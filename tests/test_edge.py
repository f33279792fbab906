"""Edge cases: threshold ties, unnormalized corpora, empty vectors,
duplicate ids, giant rows, tiny corpora."""

import numpy as np
import pytest

from apsim import AllPairsConfig, Engine
from apsim.vector.batch import CSRMatrix
from apsim.vector.sparse import Vectors

from oracle import brute_force_pairs

DIM = 300


def cfg(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return AllPairsConfig(**base)


def test_exact_tie_at_tau():
    # sim(a, b) == tau exactly: >= keeps it (reference: sim >= threshold,
    # IndexingWorkerActor.scala:103); fp64 rescore must not drop ties
    a = Vectors.sparse(DIM, [0, 1], [0.6, 0.8])
    b = Vectors.sparse(DIM, [0, 1], [0.8, 0.6])
    tau = a.dot(b)  # 0.96 exactly representable? compute actual value
    eng = Engine(cfg())
    eng.build([("a", a), ("b", b)])
    assert eng.all_pairs(tau).pair_set() == {("a", "b")}
    # and strictly above the tie drops it
    assert eng.all_pairs(np.nextafter(tau, 2.0)).pair_set() == set()


def test_unnormalized_corpus_margin():
    # large-norm vectors: margin must scale or pairs near tau are lost
    rows = []
    rng = np.random.default_rng(5)
    for _ in range(50):
        dims = np.sort(rng.choice(DIM, 6, replace=False)).astype(np.int32)
        rows.append(Vectors.sparse(DIM, dims, rng.random(6) * 40.0))
    csr = CSRMatrix.from_vectors(rows, DIM)
    eng = Engine(cfg())
    eng.build(csr)
    tau = 400.0  # raw dot threshold on unnormalized data
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(csr, tau)


def test_empty_and_singleton_vectors():
    eng = Engine(cfg())
    eng.build(
        [
            ("empty", Vectors.sparse(DIM, [], [])),
            ("a", Vectors.sparse(DIM, [1], [1.0])),
            ("b", Vectors.sparse(DIM, [1], [1.0])),
        ]
    )
    assert eng.all_pairs(0.5).pair_set() == {("a", "b")}
    # empty vector matches nothing, crashes nothing
    out = eng.insert([("e2", Vectors.sparse(DIM, [], []))], tau=0.5)
    assert out.output == {} or "e2" not in out.output


def test_duplicate_ids_index_separately():
    # reference stores duplicates as separate entries; id map keeps latest
    v = Vectors.sparse(DIM, [2], [1.0])
    eng = Engine(cfg())
    eng.build([("x", v)])
    eng.insert([("x", v)], tau=0.9)
    assert eng.n_rows == 2
    assert eng.id_to_row["x"] == 1


def test_giant_row_nnz():
    # one row with nnz >> everyone else (pads the ingest batch wide)
    rng = np.random.default_rng(9)
    big_dims = np.arange(DIM, dtype=np.int32)
    big = Vectors.sparse(DIM, big_dims, rng.random(DIM)).normalized()
    small = Vectors.sparse(DIM, [0, 1], [0.6, 0.8])
    eng = Engine(cfg())
    eng.build([("big", big), ("small", small)])
    csr = CSRMatrix.from_vectors([big, small], DIM)
    for tau in (0.1, 0.5):
        want = brute_force_pairs(csr, tau, ["big", "small"])
        assert eng.all_pairs(tau).pair_set() == want


def test_single_vector_corpus():
    eng = Engine(cfg())
    eng.build([("only", Vectors.sparse(DIM, [0], [1.0]))])
    assert eng.all_pairs(0.1).n_pairs == 0
    res = eng.topk([("q", Vectors.sparse(DIM, [0], [1.0]))], 5)
    assert len(res["q"]) == 1  # k clamped to corpus size


def test_insert_before_build():
    # engine must bootstrap from streaming inserts alone
    eng = Engine(cfg())
    out = eng.insert(
        [("a", Vectors.sparse(DIM, [7], [1.0])),
         ("b", Vectors.sparse(DIM, [7], [1.0]))],
        tau=0.9,
    )
    assert out.output["a"]["b"] == pytest.approx(1.0)
    assert eng.all_pairs(0.9).pair_set() == {("a", "b")}


def test_tau_zero_rejected_pairs_only_by_dot():
    # tau tiny: every overlapping pair emitted; disjoint pairs never
    a = Vectors.sparse(DIM, [0], [1.0])
    b = Vectors.sparse(DIM, [1], [1.0])
    c = Vectors.sparse(DIM, [0], [0.1])
    eng = Engine(cfg())
    eng.build([("a", a), ("b", b), ("c", c)])
    assert eng.all_pairs(1e-6).pair_set() == {("a", "c")}


def test_pow2_bucketing():
    from apsim.vector.batch import pow2_bucket

    assert pow2_bucket(1) == 64
    assert pow2_bucket(64) == 64
    assert pow2_bucket(65) == 128
    assert pow2_bucket(6141) == 8192
    assert pow2_bucket(5, lo=32) == 32


def test_compact_capacity_headroom_growth():
    """A build landing exactly on a dim_bucket multiple must not double its
    matmul K on the first streamed dim: capacity grows by
    geometrically-doubling headroom (bucket, 2*bucket, 4*bucket, ...)."""
    import numpy as np

    from apsim.index.compact import CompactSpace
    from apsim.vector.batch import CSRMatrix

    bucket = 64
    n = bucket * 2  # active dims == exact bucket multiple
    indptr = np.arange(n + 1, dtype=np.int64)
    csr = CSRMatrix(n, 1000, indptr, np.arange(n, dtype=np.int32),
                    np.ones(n))
    cs = CompactSpace.from_csr(csr, dim_bucket=bucket)
    assert cs.capacity == n  # tight build: no padding
    cs.extend(np.array([999]))  # first streamed new dim
    assert cs.capacity == n + bucket, cs.capacity  # ONE bucket, not 2x
    # keep minting: growth stays geometric in headroom
    cs.extend(np.arange(500, 500 + 3 * bucket))
    assert cs.capacity == n + bucket + 2 * bucket + 4 * bucket


def test_pallas_kernel_rejects_misaligned_tiles():
    """The block decomposition floors rows//tm etc. — a non-multiple
    operand must raise instead of silently dropping trailing rows/columns."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from apsim.ops import panel

    x = jnp.zeros((96, 96), jnp.int8)  # 96 % 64 != 0
    aux = jnp.zeros((3, 96), jnp.float32)
    bi = jnp.zeros(1, jnp.int32)
    bj = jnp.zeros(1, jnp.int32)
    off = jnp.zeros(2, jnp.int32)
    with pytest.raises(ValueError, match="divide"):
        panel.panel_score_bits_int8_ref(x, x, aux, aux, bi, bj, off,
                                        np.float32(0.5), 64, 64)


def test_low_tau_margin_warns_once():
    """tau below the device-error margin logs one loud warning (the clamp
    can miss pairs within the margin of zero on non-int8 paths) and does
    not repeat it on every later call.  The apsim logger has propagate off,
    so capture via a handler on it directly."""
    import logging

    from apsim.utils.logging import get_logger

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Capture(level=logging.WARNING)
    get_logger().addHandler(h)
    try:
        a = Vectors.sparse(DIM, [0], [1.0])
        c = Vectors.sparse(DIM, [0], [0.1])
        eng = Engine(cfg())
        eng.build([("a", a), ("c", c)])
        eng.all_pairs(1e-6)
        hits = [m for m in records if "below the device-error margin" in m]
        assert len(hits) == 1, records
        eng.all_pairs(1e-6)
        hits = [m for m in records if "below the device-error margin" in m]
        assert len(hits) == 1  # warned once, not per call
    finally:
        get_logger().removeHandler(h)
