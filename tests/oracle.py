"""Brute-force float64 NumPy oracle for all-pairs cosine joins.

The reference ships zero tests (SURVEY.md §4); this oracle is the substitute
ground truth: a dense fp64 ``X @ X.T`` with exact thresholding, compared
pair-set-for-pair-set against the engine at every tau.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np

from apsim.vector.batch import CSRMatrix


def brute_force_pairs(
    csr: CSRMatrix, tau: float, ids: Sequence[str] | None = None
) -> Set[Tuple[str, str]]:
    """All unordered pairs with fp64 dot >= tau (ids default to row numbers)."""
    if ids is None:
        ids = [str(i) for i in range(csr.n_rows)]
    dense = csr.to_dense()
    s = dense @ dense.T
    i, j = np.nonzero(np.triu(s >= tau, k=1))
    out: Set[Tuple[str, str]] = set()
    for a, b in zip(i, j):
        x, y = ids[int(a)], ids[int(b)]
        out.add((x, y) if x <= y else (y, x))
    return out


def brute_force_sims(csr: CSRMatrix) -> np.ndarray:
    dense = csr.to_dense()
    return dense @ dense.T


def brute_force_topk(csr: CSRMatrix, queries: CSRMatrix, k: int) -> List[List[int]]:
    """Row indices of the k largest dots per query (fp64)."""
    xd = csr.to_dense()
    qd = queries.to_dense()
    s = qd @ xd.T
    return [list(np.argsort(-s[q], kind="stable")[:k]) for q in range(s.shape[0])]


def random_sparse_corpus(
    rng: np.random.Generator,
    n: int,
    dim: int,
    nnz_lo: int = 3,
    nnz_hi: int = 30,
    normalize: bool = True,
    n_hot_dims: int | None = None,
) -> CSRMatrix:
    """Random L2-normalized sparse vectors with a skewed dim distribution
    (mimics TF-IDF's power-law dims so dedup/pruning paths get exercised)."""
    hot = n_hot_dims or max(4, dim // 16)
    rows = []
    vals = []
    indptr = [0]
    for _ in range(n):
        nnz = int(rng.integers(nnz_lo, nnz_hi + 1))
        # half the mass in a small hot-dim set → plenty of near-duplicates
        n_hot = max(1, nnz // 2)
        hot_dims = rng.choice(hot, size=min(n_hot, hot), replace=False)
        cold_dims = rng.choice(
            np.arange(hot, dim), size=min(nnz - len(hot_dims), dim - hot),
            replace=False,
        )
        dims = np.unique(np.concatenate([hot_dims, cold_dims])).astype(np.int32)
        v = rng.random(dims.size) + 0.05
        if normalize:
            v = v / np.linalg.norm(v)
        rows.append(dims)
        vals.append(v.astype(np.float64))
        indptr.append(indptr[-1] + dims.size)
    return CSRMatrix(
        n, dim,
        np.asarray(indptr, np.int64),
        np.concatenate(rows),
        np.concatenate(vals),
    )
