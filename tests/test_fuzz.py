"""Property tests: random corpora × random engine configs must always match
the fp64 oracle exactly — batch, streaming, and chunked."""

import numpy as np
import pytest

from apsim import AllPairsConfig, Engine
from apsim.engine import ChunkedAllPairs

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 350


def random_cfg(rng) -> AllPairsConfig:
    return AllPairsConfig(
        vector_dim=DIM,
        query_tile=int(rng.choice([32, 64, 128])),
        row_bucket=int(rng.choice([32, 64, 128])),
        dim_bucket=int(rng.choice([64, 128])),
        extract_cap=int(rng.choice([64, 4096, 1 << 18])),
        extract_group=int(rng.choice([8, 16])),
        matmul_precision=str(rng.choice(["default", "highest"])),
        dtype=str(rng.choice(["float32", "bfloat16"])),
    )


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_fuzz_batch_and_streaming(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 200))
    csr = random_sparse_corpus(rng, n, DIM, nnz_lo=2, nnz_hi=25)
    tau = float(rng.choice([0.25, 0.4, 0.6, 0.8]))
    cfg = random_cfg(rng)
    want = brute_force_pairs(csr, tau)

    eng = Engine(cfg)
    eng.build(csr)
    assert eng.all_pairs(tau).pair_set() == want, (seed, cfg)

    eng2 = Engine(cfg)
    emitted = set()
    step = int(rng.integers(1, 40))
    for s in range(0, n, step):
        e = min(s + step, n)
        out = eng2.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=tau)
        for q, sims in out.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == want, (seed, cfg, step)


# first 5 seeds run UNCONDITIONALLY (exactness is the core product claim —
# the sweep must exercise every default run, VERDICT r3 item #6); the
# remaining 15 are the extended sweep behind APSIM_EXTENDED_FUZZ=1
_FAST_SEEDS = list(range(1000, 1005))
_EXT_SEEDS = list(range(1005, 1020))
_EXT = bool(__import__("os").environ.get("APSIM_EXTENDED_FUZZ"))


@pytest.mark.parametrize(
    "seed",
    _FAST_SEEDS + [
        pytest.param(s, marks=pytest.mark.skipif(
            not _EXT,
            reason="extended sweep: set APSIM_EXTENDED_FUZZ=1 "
                   "(takes minutes)",
        ))
        for s in _EXT_SEEDS
    ],
)
def test_fuzz_extended(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 250))
    csr = random_sparse_corpus(rng, n, DIM, nnz_lo=1, nnz_hi=30)
    tau = float(rng.uniform(0.2, 0.95))
    cfg = AllPairsConfig(
        vector_dim=DIM,
        query_tile=int(rng.choice([32, 64, 128, 256])),
        row_bucket=int(rng.choice([32, 64, 256])),
        dim_bucket=int(rng.choice([64, 128, 2048])),
        extract_cap=int(rng.choice([16, 2048, 1 << 18])),
        extract_group=int(rng.choice([8, 16])),
        matmul_precision=str(rng.choice(["default", "highest"])),
        pallas_int8=bool(rng.choice([True, False])),
    )
    want = brute_force_pairs(csr, tau)
    eng = Engine(cfg)
    emitted = set()
    step = int(rng.integers(1, 60))
    for s in range(0, n, step):
        e = min(s + step, n)
        out = eng.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=tau)
        for q, sims in out.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == want
    assert eng.all_pairs(tau).pair_set() == want


@pytest.mark.parametrize("seed", [555, 666])
def test_fuzz_chunked_panel(seed):
    """int8 panel join under random configs/panel sizes, including a
    streamed tail that invalidates the sorted-COO cache mid-run."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 200))
    csr = random_sparse_corpus(rng, n, DIM, nnz_lo=2, nnz_hi=25)
    tau = float(rng.choice([0.3, 0.5]))
    cfg = random_cfg(rng).replace(matmul_precision="default")
    eng = ChunkedAllPairs(
        cfg, chunk_dim=int(rng.choice([64, 128])),
        panel_rows=int(rng.choice([64, 128])),
    )
    cut = n - int(rng.integers(1, 20))
    from apsim.vector.batch import CSRMatrix

    head = CSRMatrix(
        cut, csr.n_cols, csr.indptr[: cut + 1],
        csr.indices[: int(csr.indptr[cut])],
        csr.data[: int(csr.indptr[cut])],
    )
    eng.build(head)
    assert eng._panel_ok(), seed
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(head, tau)
    eng.insert([(str(i), csr.row(i)) for i in range(cut, n)], tau=tau)
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(csr, tau), (
        seed, cfg,
    )


@pytest.mark.parametrize("seed", [111, 222])
def test_fuzz_chunked(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 220))
    csr = random_sparse_corpus(rng, n, DIM, nnz_lo=2, nnz_hi=25)
    tau = float(rng.choice([0.3, 0.5]))
    cfg = random_cfg(rng)
    eng = ChunkedAllPairs(
        cfg, chunk_dim=int(rng.choice([64, 128, 256])),
        super_tile=int(rng.choice([256, 512])),
    )
    eng.build(csr)
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(csr, tau), (
        seed, cfg,
    )
