"""Vector data-model tests (reference: cpslab/vector/SparseVector.scala)."""

import numpy as np
import pytest

from apsim.vector.batch import CSRMatrix, PaddedBatch
from apsim.vector.sparse import (
    DenseVector,
    SparseVector,
    Vectors,
    format_vector,
    parse_vector,
)


def test_sparse_vector_validation():
    with pytest.raises(ValueError):
        SparseVector(4, [0, 2, 1], [1.0, 2.0, 3.0])  # not increasing
    with pytest.raises(ValueError):
        SparseVector(2, [0, 5], [1.0, 2.0])  # out of range
    with pytest.raises(ValueError):
        SparseVector(4, [0, 1], [1.0])  # length mismatch


def test_text_format_roundtrip():
    v = Vectors.sparse(10, [1, 3, 7], [0.5, -2.25, 3.0])
    s = format_vector(v)
    assert s.startswith("(10,[1,3,7],[")
    w = parse_vector(s)
    assert w.size == 10
    np.testing.assert_array_equal(w.indices, v.indices)
    np.testing.assert_allclose(w.values, v.values)


def test_parse_reference_format():
    # the exact shape the Scala writer emits (SparseVector.scala:204)
    v = parse_vector("(5,[0,4],[1.5,2.5])")
    assert v.size == 5 and v.nnz == 2
    with pytest.raises(ValueError):
        parse_vector("not-a-vector")


def test_dot_and_norm():
    a = Vectors.sparse(8, [0, 2, 5], [1.0, 2.0, 3.0])
    b = Vectors.sparse(8, [2, 5, 7], [4.0, 5.0, 6.0])
    assert a.dot(b) == pytest.approx(2 * 4 + 3 * 5)
    assert a.dot(Vectors.sparse(8, [1], [9.0])) == 0.0
    n = a.normalized()
    assert n.norm() == pytest.approx(1.0)
    with pytest.raises(ValueError):
        a.dot(Vectors.sparse(9, [0], [1.0]))


def test_filter_values_above():
    # streaming indexThreshold semantics: keep strictly greater
    # (WriteWorkerActor.scala:192)
    v = Vectors.sparse(6, [0, 1, 2], [0.1, 0.5, 0.9])
    f = v.filter_values_above(0.5)
    np.testing.assert_array_equal(f.indices, [2])


def test_from_pairs_duplicate_check():
    v = Vectors.from_pairs(5, [(3, 1.0), (1, 2.0)])
    np.testing.assert_array_equal(v.indices, [1, 3])
    with pytest.raises(ValueError, match="duplicate"):
        Vectors.from_pairs(5, [(1, 1.0), (1, 2.0)])


def test_dense_vector():
    d = Vectors.dense([0.0, 1.0, 0.0, 2.0])
    assert isinstance(d, DenseVector)
    s = d.to_sparse()
    np.testing.assert_array_equal(s.indices, [1, 3])
    assert Vectors.zeros(3).to_array().sum() == 0.0


def test_csr_from_vectors_and_stats():
    vecs = [
        Vectors.sparse(6, [0, 2], [1.0, 2.0]),
        Vectors.sparse(6, [2, 5], [3.0, 4.0]),
        Vectors.sparse(6, [], []),
    ]
    csr = CSRMatrix.from_vectors(vecs, 6)
    assert csr.n_rows == 3 and csr.n_cols == 6
    np.testing.assert_array_equal(csr.row_nnz(), [2, 2, 0])
    np.testing.assert_allclose(csr.max_weights(), [1, 0, 3, 0, 0, 4])
    np.testing.assert_array_equal(csr.doc_freq(), [1, 0, 2, 0, 0, 1])
    np.testing.assert_allclose(
        csr.row_norms(), [np.sqrt(5.0), 5.0, 0.0]
    )
    norm = csr.normalized()
    np.testing.assert_allclose(
        norm.row_norms(), [1.0, 1.0, 0.0]
    )
    back = csr.row(1)
    np.testing.assert_array_equal(back.indices, [2, 5])


def test_padded_batch():
    vecs = [
        Vectors.sparse(10, [0, 3, 7], [1.0, 2.0, 3.0]),
        Vectors.sparse(10, [5], [4.0]),
    ]
    csr = CSRMatrix.from_vectors(vecs, 10)
    b = PaddedBatch.from_csr(csr, pad_dim=10, k_bucket=4)
    assert b.dims.shape == (2, 4)
    assert b.dims[1, 1] == 10  # padding points one past the last column
    np.testing.assert_array_equal(b.lengths, [3, 1])
    assert b.vals.dtype == np.float32


def test_pack_coo_i32():
    from apsim.vector.batch import pack_coo_i32

    rows = np.array([5, 9], np.int64)
    cols = np.array([3, 7], np.int64)
    vals = np.array([1.25, -2.5], np.float64)
    coo = pack_coo_i32(rows, cols, vals, pad_row=16, lo=4)
    assert coo.shape == (3, 4) and coo.dtype == np.int32
    np.testing.assert_array_equal(coo[0], [5, 9, 16, 16])  # pad -> pad_row
    np.testing.assert_array_equal(coo[1], [3, 7, 0, 0])
    # fp32 value bits roundtrip exactly
    np.testing.assert_array_equal(
        coo[2, :2].view(np.float32), np.float32([1.25, -2.5])
    )
    assert coo[2, 2] == 0 and coo[2, 3] == 0
    empty = pack_coo_i32(rows[:0], cols[:0], vals[:0], pad_row=8, lo=4)
    assert empty.shape == (3, 4) and (empty[0] == 8).all()
