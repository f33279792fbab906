"""Out-of-core (chunked) benchmark: build + all-pairs join + streaming at
row counts beyond the dense-index HBM ceiling.

Measures the ChunkedAllPairs panel join (the Pallas block-panel path) and
optionally cross-checks its pair set against the XLA stripe path (exact
parity — both feed the same fp64 host rescore).  Reports HBM high-water
when the platform exposes memory stats, substantiating the engine's
rows-per-chip claim.

Usage:  python -m apsim.bench.ooc [n_rows ...] [--stripes] [--stream N]
            [--stream-batch B] [--stream-only]

``--stream-batch`` sets the insert micro-batch size (default 256).  Beyond
the resident-slab budget each batch pays a FIXED corpus re-scatter (the
cross-match densifies the index per batch) plus a per-query
dot/extraction cost, so larger batches amortize the fixed part — the same
amortization the reference gets
from its time-based micro-batching (ioTriggerPeriod,
WriteWorkerActor.scala:52-57).
``--stream-only`` skips the join (streaming measurements without paying the
join warm-up).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np


def _hbm_stats() -> Dict:
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats() or {}
        return {
            k: int(v)
            for k, v in stats.items()
            if k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
        }
    except Exception:
        return {}


def run_ooc(
    n_rows: int,
    tau: float = 0.8,
    compare_stripes: bool = False,
    stream_rows: int = 0,
    chunk_dim: int = 2048,
    panel_rows: int | None = None,
    stream_batch: int = 256,
    stream_only: bool = False,
    corpus: str = "powerlaw",
) -> Dict:
    from ..config import AllPairsConfig
    from ..engine.chunked import ChunkedAllPairs
    from .scale import rcv1_like_corpus, synthetic_corpus

    gen = rcv1_like_corpus if corpus == "rcv1" else synthetic_corpus
    t0 = time.time()
    csr = gen(n_rows)
    gen_s = time.time() - t0
    decided = n_rows * (n_rows - 1) / 2

    eng = ChunkedAllPairs(
        AllPairsConfig(), chunk_dim=chunk_dim, panel_rows=panel_rows
    )
    t0 = time.time()
    st = eng.build(csr)
    build_s = time.time() - t0

    report: Dict = {
        "n_rows": n_rows,
        "corpus": corpus,
        "nnz": int(csr.indptr[-1]),
        "gen_seconds": gen_s,
        "build_seconds": build_s,
        "n_chunks": st["n_chunks"],
        "panel_geom": eng._panel_geom(),
        "panel_path": eng._panel_ok(),
    }

    if not stream_only:
        eng.all_pairs(tau)  # warm (compile; default caps)
        eng.all_pairs(tau)  # warm tight-cap shapes
        t0 = time.time()
        res = eng.all_pairs(tau)
        join_s = time.time() - t0
        report["join_seconds"] = join_s
        report["pairs"] = res.n_pairs
        report["decided_pairs_per_sec"] = decided / join_s
        geom = eng._panel_geom()
        if geom is not None:  # (rb, n_panels, d_cap)
            import jax

            from .mfu import int8_join_ops, mfu_pct

            rb, n_panels, d_cap = geom
            report["int8_ops"] = int8_join_ops(n_panels * rb, d_cap)
            report["mfu_pct"] = mfu_pct(
                report["int8_ops"], join_s, jax.devices()[0].device_kind
            )
        report["hbm"] = _hbm_stats()

    if compare_stripes and not stream_only:
        eng._use_panels = False
        eng.all_pairs(tau)
        eng.all_pairs(tau)
        t0 = time.time()
        res_s = eng.all_pairs(tau)
        report["stripe_join_seconds"] = time.time() - t0
        report["stripe_parity"] = res_s.pair_set() == res.pair_set()
        eng._use_panels = True

    if stream_rows > 0:
        extra = gen(stream_rows, seed=99)
        batch = [(f"s{i}", extra.row(i)) for i in range(extra.n_rows)]
        times = []
        bs = int(stream_batch)
        for s in range(0, len(batch), bs):
            t0 = time.time()
            eng.insert(batch[s : s + bs], tau=tau)
            times.append(time.time() - t0)
        # which match path served the stream (resident slabs / host spGEMM
        # / device rebuild) — the round-4 cost router's decision, recorded
        # so throughput numbers are attributable
        sample = extra.indices[: extra.indptr[min(bs, extra.n_rows)]]
        path = (
            "resident_slabs" if eng._match_slabs() is not None
            else "host_spgemm" if eng._use_host_match(sample)
            else "device_paneled" if eng._paneled_ok()
            else "device_rebuild"
        )
        report["stream"] = {
            "rows": stream_rows,
            "batch": bs,
            "median_batch_seconds": float(np.median(times)),
            "steady_vectors_per_sec": bs / float(np.median(times)),
            "match_path": path,
        }
        # router generalization check (VERDICT r4 #7): beyond the slab
        # budget, A/B the two match paths the router chooses between by
        # FORCING each for a few batches — the artifact then shows whether
        # the df-mass cost model picked the measured-faster one on THIS
        # corpus shape, not just on the shape it was calibrated on
        # the host leg's cost grows with batch df mass (at 500k/bs=4096 it
        # runs for many minutes), so big-batch runs skip it unless
        # explicitly asked
        if eng._match_slabs() is None and (
            bs <= 512 or "--router-ab" in sys.argv
        ):
            ab = {}
            dev_name = (
                "device_paneled" if eng._paneled_ok() else "device_rebuild"
            )
            extra2 = gen(2 * bs, seed=101)
            probes = [
                [(f"p{i}", extra2.row(i)) for i in range(bs)],
                [(f"p{i}", extra2.row(i)) for i in range(bs, 2 * bs)],
            ]
            for force, name in ((True, "host_spgemm"), (False, dev_name)):
                eng._use_host_match = lambda q, _f=force: _f  # shadow method
                t0 = time.time()
                eng.insert(probes.pop(0), tau=tau)
                ab[name + "_batch_seconds"] = time.time() - t0
            del eng._use_host_match  # restore the real router
            ab["router_choice"] = path
            ab["router_correct"] = (
                path == "resident_slabs"
                or ab[path + "_batch_seconds"]
                == min(ab["host_spgemm_batch_seconds"],
                       ab[dev_name + "_batch_seconds"])
            )
            report["router_ab"] = ab
        report["hbm_after_stream"] = _hbm_stats()

    # checkpoint roundtrip cost (VERDICT r3 #7: restore must cost <<
    # build — the gather-only remap + counting bucketing made restore a
    # cheap re-build from the checkpoint CSR, no device state persisted)
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck.npz")
        t0 = time.time()
        eng.save(ck)
        report["save_seconds"] = time.time() - t0
        e2 = ChunkedAllPairs(
            AllPairsConfig(), chunk_dim=chunk_dim, panel_rows=panel_rows
        )
        t0 = time.time()
        e2.restore(ck)
        report["restore_seconds"] = time.time() - t0
        report["restore_rows"] = e2.n_rows
    return report


def main() -> None:
    # sys imported at module scope

    args = [a for a in sys.argv[1:]]
    stripes = "--stripes" in args
    corpus = "rcv1" if "--rcv1" in args else "powerlaw"
    if "--rcv1" in args:
        args.remove("--rcv1")
    stream_only = "--stream-only" in args
    if stream_only:
        args.remove("--stream-only")
    stream = 0
    if "--stream" in args:
        k = args.index("--stream")
        stream = int(args[k + 1])
        del args[k : k + 2]
    sbatch = 256
    if "--stream-batch" in args:
        k = args.index("--stream-batch")
        sbatch = int(args[k + 1])
        del args[k : k + 2]
    sizes = [int(a) for a in args if not a.startswith("-")] or [100_000]
    out = {}
    for n in sizes:
        out[str(n)] = run_ooc(
            n, compare_stripes=stripes, stream_rows=stream,
            stream_batch=sbatch, stream_only=stream_only, corpus=corpus,
        )
        json.dump(out[str(n)], sys.stderr, indent=1)
        print(file=sys.stderr, flush=True)
    json.dump(out, sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
