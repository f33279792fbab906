"""The benchmark suite itself must run green on a small corpus (it carries
its own parity checks — this is the BASELINE.json config coverage)."""

import numpy as np

from apsim.bench.suite import run_suite

from oracle import random_sparse_corpus


def test_suite_small():
    rng = np.random.default_rng(17)
    csr = random_sparse_corpus(rng, 96, 300)
    ids = [str(i) for i in range(csr.n_rows)]
    report = run_suite(
        csr, ids, taus=(0.5, 0.7),
        stream_batch=17, topk_queries=8, mesh=True,
    )
    for tau, entry in report["threshold_sweep"].items():
        assert entry["parity_full"], tau
    assert report["streaming"]["equals_batch_join"]
    assert report["topk"]["self_match_rate"] == 1.0
    assert report["mesh"]["matches_single_device"]
    assert report["mesh"]["devices"] == 8
    # the CC_WEB loadgen leg ran end-to-end (no swallowed error)
    lg = report["ccweb_loadgen"]
    assert "error" not in lg, lg
    assert lg["messages"] > 0 and lg["avg_latency_ms"] > 0
    assert lg["indexed_after_warmup"] == lg["fixture_vectors"]


def test_lint_clean():
    """tools/lint.py (the scalastyle analog) must stay clean — run it as
    part of the suite so a regression can't land silently."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "lint.py")],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout[-3000:]


def test_rcv1_shape_leg_parity():
    """The second-corpus-shape leg (VERDICT r4 #7): RCV1-shaped synthetic
    through both engine flavors with fp64 oracle parity."""
    from apsim.bench.suite import _rcv1_shape_leg

    out = _rcv1_shape_leg(n_rows=512, taus=(0.8,))
    leg = out["tau_0.8"]
    assert leg["dense_parity"] and leg["chunked_parity"], out
    assert leg["pairs"] >= 2  # the 1% dup injection guarantees sim≈1 pairs


def test_rcv1_like_corpus_shape():
    """Generator sanity: vocabulary bound, L2-normalized rows, flatter df
    mass than the power-law synthetic (the property the router A/B needs)."""
    import numpy as np

    from apsim.bench.scale import rcv1_like_corpus, synthetic_corpus

    csr = rcv1_like_corpus(2000, seed=7)
    assert int(csr.indices.max()) < 47_236
    sq = np.zeros(csr.n_rows)
    np.add.at(sq, np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr)),
              csr.data * csr.data)
    np.testing.assert_allclose(sq, 1.0, rtol=1e-9)
    # hot-dim concentration: top-16 dims' share of total nnz mass is lower
    # than the s=1 power-law synthetic's at equal row count
    pl = synthetic_corpus(2000, seed=7)

    def top_share(c, k=16):
        df = np.bincount(c.indices)
        df.sort()
        return df[-k:].sum() / c.indices.size

    assert top_share(csr) < top_share(pl)
