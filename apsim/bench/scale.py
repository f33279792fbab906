"""Synthetic scale benchmark: corpus sizes beyond Enron.

Generates TF-IDF-shaped data (power-law dim popularity, L2-normalized, with a
controllable near-duplicate rate so thresholded joins have hits) and measures
build + all-pairs + streaming at increasing row counts on the current device.
Validates the engine's large-row paths (tiling, extraction capacity, growth)
and reports decided-pairs/sec per size.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..vector.batch import CSRMatrix

__all__ = ["synthetic_corpus", "run_scale"]


def synthetic_corpus(
    n_rows: int,
    n_dims: int = 1 << 20,
    active_dims: int = 32768,
    nnz_mean: int = 120,
    dup_rate: float = 0.02,
    seed: int = 0,
) -> CSRMatrix:
    """Power-law sparse corpus: dim d is sampled ∝ 1/(d+10); ``dup_rate`` of
    rows are exact copies of earlier rows (guaranteed tau≈1 pairs)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(active_dims) + 10.0)
    weights /= weights.sum()
    # vectorized draw: one flat power-law sample for the whole corpus
    # (inverse-CDF on uniform draws), then per-row unique-dim dedup via a
    # (row, dim) sort — the per-row Python loop this replaces took ~100 s
    # at 100k rows, which made the ≥500k scale proof impractical
    nnz_row = np.maximum(4, rng.poisson(nnz_mean, size=n_rows))
    total = int(nnz_row.sum())
    cdf = np.cumsum(weights)
    draws = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_row)
    key = row_of * active_dims + draws
    key = np.unique(key)  # sorts by (row, dim) and dedups within rows
    row_of = key // active_dims
    dims = (key % active_dims).astype(np.int32)
    vals = rng.random(dims.size) + 0.05
    counts = np.bincount(row_of, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # L2-normalize per row
    sq = np.zeros(n_rows)
    np.add.at(sq, row_of, vals * vals)
    vals = vals / np.sqrt(sq)[row_of]
    csr = CSRMatrix(n_rows, n_dims, indptr, dims, vals.astype(np.float64))
    return _inject_dups(csr, dup_rate, rng)


def _inject_dups(csr: CSRMatrix, dup_rate: float, rng) -> CSRMatrix:
    """Overwrite ``dup_rate`` of rows with copies of earlier rows
    (guaranteed tau≈1 pairs for the parity legs), vectorized.

    The per-row list loop this replaces was O(n_rows) Python work — the
    exact cost class the flat draw above removed.  Row r copies
    ``src_of[r]``; chains (a dup whose source is itself a dup) resolve by
    pointer-jumping, which terminates because sources are strictly smaller
    row ids."""
    n_rows, n_dims = csr.n_rows, csr.n_cols
    n_dup = int(n_rows * dup_rate)
    if n_dup == 0:
        return csr
    dup_dst = np.sort(rng.choice(np.arange(1, n_rows), size=n_dup, replace=False))
    dup_src = rng.integers(0, dup_dst)
    src_of = np.arange(n_rows, dtype=np.int64)
    src_of[dup_dst] = dup_src
    while True:
        nxt = src_of[src_of]
        if np.array_equal(nxt, src_of):
            break
        src_of = nxt
    counts = np.diff(csr.indptr)[src_of]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    pos = np.arange(indptr[-1]) - np.repeat(indptr[:-1], counts)
    src_flat = np.repeat(csr.indptr[src_of], counts) + pos
    return CSRMatrix(
        n_rows, n_dims, indptr, csr.indices[src_flat], csr.data[src_flat]
    )


def rcv1_like_corpus(
    n_rows: int,
    n_dims: int = 1 << 20,
    active_dims: int = 47_236,
    seed: int = 0,
    dup_rate: float = 0.01,
) -> CSRMatrix:
    """RCV1-shaped synthetic corpus (VERDICT r4 #7: a SECOND data shape so
    the host-match router, panel cost model, and int8 demotion heuristic
    are exercised beyond Enron TF-IDF + one power-law synthetic; zero
    egress, so the shape is synthesized to RCV1's published statistics:
    ~47k-term vocabulary, log-normal document lengths around ~75 terms,
    a FLATTER df curve than web text, ln-TF·IDF values, L2-normalized).

    The flatter Zipf (s≈0.7, offset 25) is the property that matters for
    calibration generalization: hot dims carry much less of the mass than
    in :func:`synthetic_corpus` (s=1), so per-batch dim intersections are
    sparse and the df-mass router faces the opposite regime.  Reference
    analog: the CC_WEB loader's alternative corpus shape
    (CCWEBVideoLoadGenerator.scala:8-30)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(active_dims) + 25.0) ** 0.7
    weights /= weights.sum()
    nnz_row = np.clip(
        rng.lognormal(np.log(60.0), 0.6, size=n_rows), 4, 600
    ).astype(np.int64)
    total = int(nnz_row.sum())
    cdf = np.cumsum(weights)
    draws = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_row)
    key = np.unique(row_of * active_dims + draws)
    row_of = key // active_dims
    dims = (key % active_dims).astype(np.int32)
    # ln-TF·IDF: tf ~ geometric-ish (most terms appear once), idf rises
    # with dim rank (rarer dim index => larger idf) — the upweighting of
    # rare dims is what defeats tail-mass pruning bounds on real TF-IDF
    tf = 1.0 + rng.standard_exponential(dims.size)
    idf = np.log(2.0 + dims.astype(np.float64))
    vals = (1.0 + np.log(tf)) * idf
    counts = np.bincount(row_of, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    sq = np.zeros(n_rows)
    np.add.at(sq, row_of, vals * vals)
    vals = vals / np.sqrt(sq)[row_of]
    csr = CSRMatrix(n_rows, n_dims, indptr, dims, vals.astype(np.float64))
    return _inject_dups(csr, dup_rate, rng)


def run_scale(sizes=(10_000, 25_000, 50_000), tau: float = 0.8) -> Dict:
    report: Dict = {}
    for n in sizes:
        t0 = time.time()
        csr = synthetic_corpus(n)
        gen_s = time.time() - t0
        eng = Engine(AllPairsConfig())
        t0 = time.time()
        eng.build(csr)
        build_s = time.time() - t0
        eng.all_pairs(tau)  # warm (default caps; lets the engine tighten)
        eng.all_pairs(tau)  # warm the tight-cap shapes
        t0 = time.time()
        res = eng.all_pairs(tau)
        join_s = time.time() - t0
        decided = n * (n - 1) / 2
        import jax

        from .mfu import int8_join_ops, mfu_pct

        ops = int8_join_ops(eng.row_cap, eng.dim_cap)
        kind = jax.devices()[0].device_kind
        report[str(n)] = {
            "gen_seconds": gen_s,
            "build_seconds": build_s,
            "join_seconds": join_s,
            "pairs": res.n_pairs,
            "decided_pairs_per_sec": decided / join_s,
            "row_cap": eng.row_cap,
            "dim_cap": eng.dim_cap,
            "index_gb": eng.row_cap * eng.dim_cap * 4 / 1e9,
            # efficiency-per-size curve: end-to-end utilization of the
            # device's int8 peak, extraction/D2H/rescore included
            "int8_ops": ops,
            "mfu_pct": mfu_pct(ops, join_s, kind),
        }
        del eng
    return report


if __name__ == "__main__":
    import sys

    sizes = tuple(int(s) for s in sys.argv[1:]) or (10_000, 25_000, 50_000)
    json.dump(run_scale(sizes), sys.stdout, indent=2)
    print()
