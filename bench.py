"""Benchmark driver: Enron all-pairs cosine join at tau=0.8 on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Metric: decided-pairs/sec — the join decides all n(n-1)/2 pairs of the corpus
at the threshold; throughput = decided pairs / steady wall time (engine fully
built; measurement includes device scoring, D2H transfer of candidates and
exact fp64 rescore — everything after index build).  The line also carries
``int8_ops`` / ``seconds`` / ``mfu_pct`` (end-to-end utilization of the
device's int8 peak — see apsim/bench/mfu.py) and the device it ran on.

Baseline: measured faithful CPU port of the reference algorithm
(IndexingWorkerActor.querySimilarItems + CommonUtils.calculateSimilarity —
see apsim/bench/baseline.py) on a prefix of the same corpus, per
BASELINE.md ("the reference publishes no numbers; the baseline must be
measured").  Extrapolation is linear in decided pairs (the port's cost per
decided pair falls as the index grows denser, so the prefix rate is an
overestimate of the full-corpus rate — conservative for vs_baseline).
The baseline port is fed ONE ROW PER ``index_batch`` CALL — the
reference's own streaming ingest shape.

A run that finds no GPU fails: it never falls back to the CPU, and any
failed phase fails the run.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

TAU = 0.8
BASELINE_ROWS = 1200  # prefix for the CPU reference port (~1 min)
REPEATS = 9  # median of 9 steady joins


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    t0 = time.time()
    import jax.numpy as jnp

    assert float(jnp.sum(jnp.ones((8, 8)) @ jnp.ones((8, 8)))) == 512.0
    log(f"device init: {time.time() - t0:.1f}s on {device}")

    from apsim import AllPairsConfig, Engine
    from apsim.bench.baseline import measure_baseline
    from apsim.bench.data import load_enron_tfidf
    from apsim.bench.mfu import int8_join_ops, mfu_pct

    csr, ids = load_enron_tfidf()
    n = csr.n_rows
    log(f"corpus: {n} docs, nnz={int(csr.indptr[-1])}")

    eng = Engine(AllPairsConfig())
    t0 = time.time()
    st = eng.build(csr, ids)
    log(f"build: {time.time() - t0:.1f}s {dict(st)}")

    # warm-up (compile; persistent cache makes this fast on repeat runs).
    # Two calls: the first compiles the config-default extraction caps, and
    # its result lets the engine tighten the caps to the observed candidate
    # counts — the second compiles those steady-state shapes.
    t0 = time.time()
    res = eng.all_pairs(TAU)
    log(f"warm-up all_pairs: {time.time() - t0:.1f}s, {res.n_pairs} pairs")
    t0 = time.time()
    eng.all_pairs(TAU)
    log(f"warm-up 2 (tight caps): {time.time() - t0:.1f}s")

    # warm build: rebuild with every shape compiled — this is the engine's
    # actual indexing cost (the first build may hit or miss the persistent
    # compile cache, which is environment, not engine work).
    eng2 = Engine(AllPairsConfig())
    t0 = time.time()
    eng2.build(csr, ids)
    log(f"warm build: {time.time() - t0:.1f}s")
    del eng2

    times = []
    for _ in range(REPEATS):
        t0 = time.time()
        res = eng.all_pairs(TAU)
        times.append(time.time() - t0)
    steady = float(np.median(times))
    decided = n * (n - 1) / 2
    engine_rate = decided / steady
    ops = int8_join_ops(eng.row_cap, eng.dim_cap)
    mfu = mfu_pct(ops, steady, dev.device_kind)
    log(f"steady: {steady:.3f}s median of {times} -> "
        f"{engine_rate/1e6:.1f}M decided pairs/s, {res.n_pairs} pairs, "
        f"int8_ops={ops:.3g}, mfu={mfu:.1f}% of the int8 peak")

    # exactness gate: FULL-corpus fp64 oracle (sparse spGEMM, ~22 s) — every
    # emitted pair and every absent pair checked over all n rows, not a prefix
    from apsim.bench.suite import _oracle_pairs

    want, _ = _oracle_pairs(csr, TAU)
    got = {(int(a), int(b)) for a, b in zip(res.i, res.j)}
    parity = got == want
    log(f"parity on FULL {n}-doc corpus: {parity} "
        f"({len(got)} vs {len(want)})")
    if not parity:
        log("PARITY FAILURE — benchmark invalid")

    bl = measure_baseline(csr, TAU, max_rows=BASELINE_ROWS)
    log(
        f"baseline (reference-algorithm port, {bl['n_rows']} rows, "
        f"row-per-call streaming basis): "
        f"{bl['seconds']:.1f}s, {bl['decided_pairs_per_sec']/1e3:.1f}K "
        f"decided pairs/s, {bl['pairs_found']} pairs found"
    )
    # cross-check: the baseline port and the engine agree on the prefix
    eng_prefix = {
        tuple(sorted((str(int(a)), str(int(b)))))
        for a, b in zip(res.i, res.j)
        if a < bl["n_rows"] and b < bl["n_rows"]
    }
    bl_prefix = {tuple(sorted(p)) for p in bl["pair_set"]}
    log(f"baseline/engine prefix agreement: {eng_prefix == bl_prefix} "
        f"({len(eng_prefix)} vs {len(bl_prefix)})")

    # mid-scale utilization curve: efficiency at 16k/32k/64k through the
    # dense engine, recorded in the stderr tail
    del eng  # release the Enron index before the sweep
    from apsim.bench.scale import synthetic_corpus

    for sweep_n in (16384, 32768, 65536):
        s_csr = synthetic_corpus(sweep_n)
        s_eng = Engine(AllPairsConfig())
        s_eng.build(s_csr)
        s_eng.all_pairs(TAU)
        s_eng.all_pairs(TAU)  # tight-cap warm
        t0 = time.time()
        s_eng.all_pairs(TAU)
        s_dt = time.time() - t0
        s_ops = int8_join_ops(s_eng.row_cap, s_eng.dim_cap)
        s_dec = sweep_n * (sweep_n - 1) / 2
        log(f"mfu_curve n={sweep_n}: {s_dt:.3f}s, "
            f"{s_dec/s_dt/1e9:.2f}B decided pairs/s, "
            f"mfu={mfu_pct(s_ops, s_dt, dev.device_kind):.1f}%")
        del s_eng

    # out-of-core tier: 100k-row synthetic join through ChunkedAllPairs'
    # panel path, recorded in the stderr tail
    from apsim.bench.ooc import run_ooc

    ooc = run_ooc(100_000)
    log(
        f"out-of-core 100k join: {ooc['join_seconds']:.2f}s, "
        f"{ooc['pairs']} pairs, "
        f"{ooc['decided_pairs_per_sec']/1e9:.2f}B decided pairs/s, "
        f"mfu={ooc.get('mfu_pct', 0.0):.1f}%, "
        f"panel_path={ooc['panel_path']}"
    )

    vs = engine_rate / bl["decided_pairs_per_sec"]
    print(
        json.dumps(
            {
                "metric": "enron_allpairs_decided_pairs_per_sec_tau0.8",
                "value": round(engine_rate, 1),
                "unit": "pairs/s",
                "vs_baseline": round(vs, 1),
                "parity": bool(parity),
                "seconds": round(steady, 4),
                "int8_ops": ops,
                "mfu_pct": round(mfu, 2),
                "device": device,
            }
        ),
        flush=True,
    )
    if not parity:
        # the exactness gate must GATE: an invalid run exits nonzero so no
        # consumer records the throughput as a valid result
        sys.exit(1)


if __name__ == "__main__":
    main()
