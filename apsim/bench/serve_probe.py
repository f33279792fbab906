"""Server-level streaming-capacity probe at out-of-core scale.

VERDICT r4 item #4: prove (or refute) the self-coalescing claim END TO END
— not with hand-fed fixed batches, but through the real
:class:`SimilarityServer` (ingest queue + IOTrigger flusher, the
WriteWorkerActor.scala:52-57 semantics) under a Poisson arrival process at
a 500k-row chunked index.  The mechanism under test: when per-batch service
cost has a large fixed component (the full-corpus re-scatter beyond the
match-slab budget), a backlog makes the flush tick
flatten MORE queued vectors into ONE insert, so the effective batch size —
and with it throughput — grows until service rate meets arrival rate.

Phases:
  1. build the synthetic index (default 500k rows);
  2. WARM the insert shape buckets (pow2 batch sizes) so mid-run jit
     compiles don't masquerade as queue collapse;
  3. for each offered rate, replay a Poisson arrival schedule through
     ``insert_new_vectors`` and sample throughput/queue depth every 5 s.

Output: one JSON report per offered rate with sustained service rate
(vectors indexed per second over the steady phase), max/final queue depth,
and the flush batch-size distribution (insert_batches delta vs vectors).
``sustained && final queue bounded`` at >= 1000 vec/s is the done-criterion.

Usage: python -m apsim.bench.serve_probe [n_rows] [--rates 500,1000,1500]
       [--duration 60] [--cpu]
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np


def main() -> None:
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_rows = int(args[0]) if args else 500_000
    rates = [1000.0, 1500.0]
    if "--rates" in sys.argv:
        k = sys.argv.index("--rates")
        rates = [float(r) for r in sys.argv[k + 1].split(",")]
    duration = 60.0
    if "--duration" in sys.argv:
        k = sys.argv.index("--duration")
        duration = float(sys.argv[k + 1])
    flush_cap = None  # None = config default
    if "--flush-cap" in sys.argv:
        k = sys.argv.index("--flush-cap")
        flush_cap = int(sys.argv[k + 1])

    from ..config import AllPairsConfig
    from ..engine.chunked import ChunkedAllPairs
    from ..serve.server import SimilarityServer
    from .scale import synthetic_corpus

    csr = synthetic_corpus(n_rows)
    cfg = AllPairsConfig()
    if flush_cap is not None:
        cfg = cfg.replace(max_flush_batch=flush_cap)
    eng = ChunkedAllPairs(cfg)
    t0 = time.time()
    eng.build(csr)
    print(f"build({n_rows}): {time.time() - t0:.1f}s", flush=True)

    # arrival material: enough rows for every phase, same distribution.
    # PRE-MATERIALIZED vector objects: building 100k+ CSR-row slices inside
    # the arrival loop steals GIL time from the flusher thread and reads as
    # server slowness.  A real client is a different machine; the probe
    # measures the SERVER.
    need = int(sum(rates) * duration * 1.2) + 20_000
    extra = synthetic_corpus(need, seed=11)
    t0 = time.time()
    material = [(f"s{i}", extra.row(i)) for i in range(need)]
    print(f"arrival materialization({need}): {time.time() - t0:.1f}s",
          flush=True)
    cursor = 0

    def take(k: int):
        nonlocal cursor
        batch = material[cursor : cursor + k]
        cursor += k
        return batch

    srv = SimilarityServer(eng, eng.cfg)
    srv.start()

    # per-batch flush timeline: every engine.insert the flusher issues is
    # recorded as (t_rel_s, n_rows, dur_s) so a mid-phase stall (fresh
    # compile, crossing, consolidation) is attributable to its
    # exact batch instead of reading as generic queue collapse.  The
    # chunked engine completes deferred inserts synchronously, so the
    # wrapper's duration IS the full batch cost.
    timeline: list = []
    t_base = time.time()
    real_insert = eng.insert

    def timed_insert(batch, **kw):
        t0 = time.time()
        out = real_insert(batch, **kw)
        timeline.append(
            (round(t0 - t_base, 2), len(batch), round(time.time() - t0, 3))
        )
        return out

    eng.insert = timed_insert

    # phase 2: warm the pow2 shape buckets the coalescing flusher will hit
    # (a fresh mid-run compile would stall service and read as collapse).
    # With a flush cap the largest bucket is the cap itself.
    t0 = time.time()
    top = eng.cfg.max_flush_batch if eng.cfg.max_flush_batch > 0 else 8192
    bs = 256
    while bs <= top:
        srv.insert_new_vectors(take(bs))
        srv.flush()
        bs *= 2
    print(f"bucket warm-up to {top}: {time.time() - t0:.1f}s", flush=True)
    print(json.dumps({"warmup_timeline": list(timeline)}), flush=True)
    report_cap = eng.cfg.max_flush_batch

    report = {
        "n_rows": n_rows, "duration_s": duration,
        "max_flush_batch": report_cap, "phases": [],
    }
    for rate in rates:
        rng = np.random.default_rng(int(rate))
        # Poisson process, replayed in 50 ms pulses (the generator must not
        # become the bottleneck: per-vector timing at 1500/s would spend
        # more time in sleep jitter than the server does in service)
        pulse = 0.05
        n_total = int(rate * duration)
        arrivals = np.sort(rng.uniform(0.0, duration, size=n_total))
        stats0 = dict(eng.stats)
        tl0 = len(timeline)
        q_depth = []
        done = threading.Event()

        def sampler():
            while not done.wait(5.0):
                q_depth.append(
                    sum(len(b) for _, b in list(srv._queue.queue))
                )

        st = threading.Thread(target=sampler, daemon=True)
        st.start()
        t_start = time.time()
        sent = 0
        while sent < n_total:
            now = time.time() - t_start
            k = int(np.searchsorted(arrivals, now + pulse)) - sent
            if k > 0:
                srv.insert_new_vectors(take(k))
                sent += k
            time.sleep(pulse)
        # drain phase: let the server finish the backlog (bounded)
        t_sent = time.time()
        srv.flush()
        t_end = time.time()
        done.set()
        st.join(6)
        indexed = eng.stats["vectors_indexed"] - stats0["vectors_indexed"]
        batches = eng.stats["insert_batches"] - stats0["insert_batches"]
        svc_rate = indexed / (t_end - t_start)
        phase = {
            "offered_rate": rate,
            "offered_vectors": n_total,
            "indexed": int(indexed),
            "arrival_window_s": round(t_sent - t_start, 2),
            "total_s": round(t_end - t_start, 2),
            "drain_tail_s": round(t_end - t_sent, 2),
            "sustained_vec_per_s": round(svc_rate, 1),
            "flush_batches": int(batches),
            "mean_flush_batch": round(indexed / max(batches, 1), 1),
            "queue_depth_samples": q_depth,
            "kept_up": bool(t_end - t_sent < 0.15 * duration),
            "flush_timeline": timeline[tl0:],
        }
        report["phases"].append(phase)
        print(json.dumps(phase), flush=True)

    srv.close()
    json.dump(report, sys.stdout, indent=1)
    print(flush=True)


if __name__ == "__main__":
    main()
