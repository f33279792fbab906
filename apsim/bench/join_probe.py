"""Dense-join stage attribution: where does the time of one join go?

Decomposes one warm ``Engine.all_pairs`` into:

  - dispatch+sync floor: a no-op jit call followed by a 4-byte value fetch
    (the per-call tax every stage below also pays once);
  - score:    ``panel.panel_pairs_bits`` alone (int8 dots + bound epilogue
    + bit-pack over every panel pair), synced by fetching one int32 count;
  - extract:  the full ``panel.allpairs_extract_int8`` call incl. the
    three-level compaction, synced by the packed-head fetch the engine
    itself does (so "extract - score" ≈ compaction + head D2H);
  - rescore:  host fp64 rescore + emission (``all_pairs`` total minus
    extract, cross-checked against the engine Timer's sections).

Usage: python -m apsim.bench.join_probe [size ...] (default: 8586
16384 32768 65536; 8586 = Enron-sized synthetic).  ``--enron`` uses the
real Enron TF-IDF corpus for the first size instead.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np


def _med(f, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.time()
        f()
        ts.append(time.time() - t0)
    return float(sorted(ts)[len(ts) // 2])


def probe_size(csr, ids=None, tau: float = 0.8, reps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from ..config import AllPairsConfig
    from ..engine.engine import Engine
    from ..ops import panel
    from .mfu import int8_join_ops, mfu_pct

    eng = Engine(AllPairsConfig())
    t0 = time.time()
    eng.build(csr, ids)
    build_s = time.time() - t0
    # two warm calls: compile config-default caps, then the tightened ones
    eng.all_pairs(tau)
    eng.all_pairs(tau)

    out = {"n_rows": csr.n_rows, "row_cap": eng.row_cap,
           "dim_cap": eng.dim_cap, "build_seconds": round(build_s, 2)}
    if not eng._used_int8:
        out["note"] = "int8 path inactive; stage split skipped"
    else:
        # mirror _all_pairs_int8's geometry and cached operands/caps
        rb = panel.panel_rows_for(eng.row_cap, eng._int8_panel_rows)
        pi, pj = (jnp.asarray(a)
                  for a in panel.upper_panel_pairs(eng.row_cap // rb))
        q8, aux = eng._int8_index()
        tau_eff = eng._tau_eff(tau)
        cap, capb, cap0 = eng._int8_caps
        pack = eng.row_cap <= 65536

        noop = jax.jit(lambda v: v + 1)
        x0 = jnp.zeros((8,), jnp.int32)
        float(np.asarray(noop(x0))[0])  # compile
        out["dispatch_floor_s"] = _med(
            lambda: float(np.asarray(noop(x0))[0]), reps
        )

        score = jax.jit(functools.partial(panel.panel_pairs_bits, rb=rb))
        valid = jnp.ones(pi.shape, jnp.int32)

        def score_only():
            _, _, cnt = score(q8, aux, pi, pj, valid, tau_eff)
            return int(np.asarray(cnt[0, 0]))

        score_only()  # compile
        out["score_s"] = _med(score_only, reps)

        def extract_full():
            _, packed = panel.allpairs_extract_int8(
                q8, aux, pi, pj, tau_eff, rb, cap, capb, cap0,
                pack_head=pack,
            )
            return np.asarray(packed)

        extract_full()
        out["extract_s"] = _med(extract_full, reps)
        out["compact_fetch_s"] = out["extract_s"] - out["score_s"]

    out["all_pairs_s"] = _med(lambda: eng.all_pairs(tau), reps)
    if "extract_s" in out:
        out["rescore_emit_s"] = out["all_pairs_s"] - out["extract_s"]
    ops = int8_join_ops(eng.row_cap, eng.dim_cap)
    kind = jax.devices()[0].device_kind
    out["int8_ops"] = ops
    out["mfu_pct_e2e"] = round(mfu_pct(ops, out["all_pairs_s"], kind), 1)
    if "score_s" in out:
        out["mfu_pct_score"] = round(mfu_pct(ops, out["score_s"], kind), 1)
    # engine-side attribution cross-check (accumulated over all calls here)
    out["timer"] = {
        k: round(v / max(eng.timer.counts.get(k, 1), 1), 4)
        for k, v in eng.timer.totals.items()
        if k in ("score_extract", "rescore")
    }
    del eng
    return out


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sizes = [int(a) for a in args] or [8586, 16384, 32768, 65536]
    use_enron = "--enron" in sys.argv
    from .scale import synthetic_corpus

    report = {}
    for k, n in enumerate(sizes):
        if use_enron and k == 0:
            from .data import load_enron_tfidf

            csr, ids = load_enron_tfidf()
            r = probe_size(csr, ids)
            key = f"enron_{csr.n_rows}"
        else:
            r = probe_size(synthetic_corpus(n))
            key = str(n)
        report[key] = r
        print(f"{key}: {json.dumps(r)}", flush=True)
    print(json.dumps({"join_probe": report}), flush=True)


if __name__ == "__main__":
    main()
