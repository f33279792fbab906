"""Native C++ helpers: bit parity with the pure-Python paths."""

import zlib

import numpy as np
import pytest

import apsim.native as N
from apsim.etl.tfidf import hashing_tf
from apsim.vector.batch import CSRMatrix, PaddedBatch
from apsim.vector.sparse import Vectors

DOCS = [
    "hello world hello",
    "  tabs\tand\nnewlines\r\nmixed   spacing  ",
    "",
    "unicode café naïve 中文 tokens",
    "single",
]


@pytest.fixture
def native_lib():
    lib = N.get_lib()
    if lib is None:
        pytest.skip("no native toolchain")
    return lib


def _python_tf(docs, nf):
    saved_lib, saved_tried = N._lib, N._tried
    N._lib, N._tried = None, True
    try:
        return hashing_tf(docs, nf)
    finally:
        N._lib, N._tried = saved_lib, saved_tried


def test_crc32_parity(native_lib):
    for s in [b"", b"a", b"hello world", "café".encode()]:
        assert N.crc32(s) == zlib.crc32(s)


def test_hash_corpus_bit_parity(native_lib):
    nf = 1 << 16
    ip, ix, vv = N.hash_corpus(DOCS, nf)
    py = _python_tf(DOCS, nf)
    np.testing.assert_array_equal(ip, py.indptr)
    np.testing.assert_array_equal(ix, py.indices)
    np.testing.assert_array_equal(vv, py.data)


def test_hash_corpus_cap_retry(native_lib):
    # tiny initial cap exercised internally by doubling; result identical
    big = ["tok%d" % i for i in range(5000)]
    docs = [" ".join(big)]
    ip, ix, vv = N.hash_corpus(docs, 1 << 20)
    assert ip[-1] == len(ix) == len(vv)
    assert vv.sum() == 5000


def test_pad_batch_parity(native_lib):
    vecs = [
        Vectors.sparse(32, [0, 5, 9], [1.0, 2.0, 3.0]),
        Vectors.sparse(32, [], []),
        Vectors.sparse(32, [31], [4.0]),
    ]
    csr = CSRMatrix.from_vectors(vecs, 32)
    b_native = PaddedBatch.from_csr(csr, pad_dim=32, k=8)
    saved_lib, saved_tried = N._lib, N._tried
    N._lib, N._tried = None, True
    try:
        b_py = PaddedBatch.from_csr(csr, pad_dim=32, k=8)
    finally:
        N._lib, N._tried = saved_lib, saved_tried
    np.testing.assert_array_equal(b_native.dims, b_py.dims)
    np.testing.assert_array_equal(b_native.vals, b_py.vals)
    np.testing.assert_array_equal(b_native.lengths, b_py.lengths)


def _random_csr(rng, n_rows, n_cols, max_nnz=60):
    indptr = [0]
    indices, data = [], []
    for _ in range(n_rows):
        k = int(rng.integers(0, max_nnz))
        dims = np.sort(rng.choice(n_cols, size=k, replace=False))
        indices.extend(dims.tolist())
        data.extend(rng.random(k).tolist())
        indptr.append(len(indices))
    return (
        np.asarray(indptr, np.int64),
        np.asarray(indices, np.int32),
        np.asarray(data, np.float64),
    )


def test_group_dots_bit_identical_to_merge(native_lib):
    """The grouped scatter/gather rescore must return bit-identical fp64
    dots to the two-pointer merge (same products, same ascending-dim order,
    +0.0 identity adds for unmatched dims; -ffp-contract=off build)."""
    from apsim.ops.rescore import build_compact

    rng = np.random.default_rng(11)
    n_rows, n_cols = 300, 5000
    indptr, indices, data = _random_csr(rng, n_rows, n_cols)
    n_pairs = 2000
    i = rng.integers(0, n_rows, n_pairs).astype(np.int64)
    j = rng.integers(0, n_rows, n_pairs).astype(np.int64)
    merge = N.native_pair_dots(
        indptr, indices, data, indptr, indices, data, i, j
    )
    cind, n_active, _tok = build_compact(indices, n_cols)
    perm = np.argsort(i, kind="stable")
    scratch = np.zeros(n_active, np.float64)
    grouped = N.native_group_dots(
        indptr, cind, data, i[perm], j[perm], scratch
    )
    out = np.empty(n_pairs, np.float64)
    out[perm] = grouped
    np.testing.assert_array_equal(out, merge)
    # scratch restored to all-zero (reusable across calls)
    assert not scratch.any()


def test_group_dots_via_pair_dots(native_lib):
    """pair_dots(compact=...) routes through the grouped native path and
    matches the plain call; a stale compact (wrong size) falls back."""
    from apsim.ops.rescore import build_compact, pair_dots

    rng = np.random.default_rng(12)
    indptr, indices, data = _random_csr(rng, 120, 800)
    i = rng.integers(0, 120, 500).astype(np.int64)
    j = rng.integers(0, 120, 500).astype(np.int64)
    base = pair_dots(indptr, indices, data, i, j, 800)
    compact = build_compact(indices, 800)
    fast = pair_dots(indptr, indices, data, i, j, 800, compact=compact)
    np.testing.assert_array_equal(fast, base)
    stale = (compact[0][:-1], compact[1])  # size mismatch -> merge fallback
    fb = pair_dots(indptr, indices, data, i, j, 800, compact=stale)
    np.testing.assert_array_equal(fb, base)
    # token guard: same-nnz rebuild with DIFFERENT dims must also fall back
    # (the old size-only guard would have accepted it)
    indices2 = np.clip(indices + 1, 0, 799)
    fb2 = pair_dots(indptr, indices2, data, i, j, 800, compact=compact)
    base2 = pair_dots(indptr, indices2, data, i, j, 800)
    np.testing.assert_array_equal(fb2, base2)


def test_transfer_throttled_copy(tmp_path):
    from apsim.etl.transfer import copy_tree

    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"x" * 100_000)
    (src / "sub" / "b.bin").write_bytes(b"y" * 50_000)
    jobs = copy_tree(str(src), str(tmp_path / "dst"), max_bytes_per_sec=0)
    assert len(jobs) == 2
    assert (tmp_path / "dst" / "a.bin").read_bytes() == b"x" * 100_000
    assert (tmp_path / "dst" / "sub" / "b.bin").read_bytes() == b"y" * 50_000
    # no leftover temp files (atomic rename)
    leftovers = [
        p for p in (tmp_path / "dst").rglob("*") if "_COPYING_" in p.name
    ]
    assert not leftovers
