"""The CPU reference-algorithm port must itself be correct (it is both the
perf baseline and a second parity oracle)."""

import numpy as np

from apsim.bench.baseline import ReferenceBaseline, measure_baseline

from oracle import brute_force_pairs, random_sparse_corpus


def test_baseline_matches_oracle():
    rng = np.random.default_rng(13)
    csr = random_sparse_corpus(rng, 120, 250)
    for tau in (0.4, 0.6):
        got = ReferenceBaseline(tau).all_pairs(csr)
        assert got == brute_force_pairs(csr, tau)


def test_baseline_streaming_batches():
    rng = np.random.default_rng(14)
    csr = random_sparse_corpus(rng, 90, 200)
    eng = ReferenceBaseline(0.5)
    pairs = set()
    for s in range(0, csr.n_rows, 13):
        e = min(s + 13, csr.n_rows)
        batch = []
        for i in range(s, e):
            lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
            batch.append((str(i), csr.indices[lo:hi], csr.data[lo:hi]))
        out = eng.index_batch(batch)
        for q, sims in out.items():
            for c in sims:
                pairs.add((q, c) if q <= c else (c, q))
    assert pairs == brute_force_pairs(csr, 0.5)


def test_measure_baseline_reports():
    rng = np.random.default_rng(15)
    csr = random_sparse_corpus(rng, 60, 150)
    rep = measure_baseline(csr, 0.5, max_rows=40)
    assert rep["n_rows"] == 40
    assert rep["decided_pairs"] == 40 * 39 / 2
    assert rep["decided_pairs_per_sec"] > 0
    assert rep["pair_set"] == brute_force_pairs(
        __import__("apsim.vector.batch", fromlist=["CSRMatrix"]).CSRMatrix(
            40, csr.n_cols, csr.indptr[:41],
            csr.indices[: int(csr.indptr[40])], csr.data[: int(csr.indptr[40])],
        ),
        0.5,
    )
