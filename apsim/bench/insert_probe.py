"""Streaming-insert latency attribution for the dense engine.

Decomposes one fused micro-batch insert (``Engine.insert`` →
``score.insert_match_fused``) into its host/device constituents so the
p50 can be attacked from measurement:

  - host prep: admission + CSR build + COO pack (pure Python/NumPy);
  - enqueue:   the deferred insert call returning (H2D + dispatch);
  - complete:  ``PendingInsert.result()`` (head fetch round trip + fp64
    rescore + emission).

Usage:  python -m apsim.bench.insert_probe [n_index_rows]
"""

from __future__ import annotations

import sys
import time



def main() -> None:
    from ..config import AllPairsConfig
    from ..engine.engine import Engine
    from .scale import synthetic_corpus

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_rows = int(args[0]) if args else 20_000
    tau = 0.8
    csr = synthetic_corpus(n_rows)
    eng = Engine(AllPairsConfig())
    t0 = time.time()
    eng.build(csr)
    print(f"build({n_rows}): {time.time() - t0:.1f}s", flush=True)

    extra = synthetic_corpus(8192, seed=7)
    cursor = 0

    def take(k):
        nonlocal cursor
        batch = [
            (f"p{cursor + i}", extra.row(cursor + i)) for i in range(k)
        ]
        cursor += k
        return batch

    for bs in (1, 32, 256):
        # warm the shape bucket first (compile + first-execution)
        pend = eng.insert(take(bs), tau=tau, defer=True)
        pend.result()
        enq, comp, tot = [], [], []
        for _ in range(9):
            batch = take(bs)
            t0 = time.time()
            pend = eng.insert(batch, tau=tau, defer=True)
            t1 = time.time()
            pend.result()
            t2 = time.time()
            enq.append(t1 - t0)
            comp.append(t2 - t1)
            tot.append(t2 - t0)
        med = lambda v: sorted(v)[len(v) // 2] * 1e3  # noqa: E731
        print(
            f"bs={bs:4d}: enqueue {med(enq):6.1f} ms | complete "
            f"{med(comp):6.1f} ms | total {med(tot):6.1f} ms "
            f"({bs / (med(tot) / 1e3):.0f} vec/s)",
            flush=True,
        )
    # pipelined throughput: enqueue batch N+1 before completing batch N
    # (the server's one-tick-deep drain) — shows how much of the latency
    # the pipeline actually hides
    bs = 256
    t0 = time.time()
    prev = None
    n_b = 8
    for _ in range(n_b):
        cur = eng.insert(take(bs), tau=tau, defer=True)
        if prev is not None:
            prev.result()
        prev = cur
    prev.result()
    dt = time.time() - t0
    print(
        f"pipelined bs={bs}: {dt / n_b * 1e3:.1f} ms/batch "
        f"({bs * n_b / dt:.0f} vec/s)",
        flush=True,
    )

    # ---- result() stage decomposition (--stages): where does `complete`
    # go?  Fetch (packed-head D2H wait), parse (consume_packed), emit
    # (fp64 rescore + output shaping).  Uses PendingInsert internals — a
    # probe, not API.
    if "--stages" in sys.argv:
        import numpy as np

        from ..ops import score as score_ops

        for sbs in (1, 256):
            eng.insert(take(sbs), tau=tau, defer=True).result()  # warm
            f_t, p_t, e_t = [], [], []
            for _ in range(9):
                pend = eng.insert(take(sbs), tau=tau, defer=True)
                (e_, bufs, packed, cap, grp, n0, n_after, first_tile,
                 tau_eff, tile, tau_) = pend._e
                t0 = time.time()
                packed_h = np.asarray(packed)
                t1 = time.time()
                pairs, _needed = score_ops.consume_packed(
                    bufs, packed_h, cap, grp
                )
                t2 = time.time()
                assert pairs is not None  # steady caps: no overflow retry
                eng._emit_query_results(pairs[1], pairs[0], tau_)
                t3 = time.time()
                f_t.append(t1 - t0)
                p_t.append(t2 - t1)
                e_t.append(t3 - t2)
            med = lambda v: sorted(v)[len(v) // 2] * 1e3  # noqa: E731
            print(
                f"stages bs={sbs:4d}: fetch {med(f_t):6.1f} ms | parse "
                f"{med(p_t):6.1f} ms | emit {med(e_t):6.1f} ms "
                f"(head cap={cap}, packed={packed_h.nbytes >> 10} KiB)",
                flush=True,
            )


if __name__ == "__main__":
    main()
