"""Mesh-sharded chunked engine: out-of-core × dim-sharded, exact parity on
the 8-device virtual CPU mesh (conftest.py forces the platform)."""

import numpy as np
import pytest

from apsim import AllPairsConfig
from apsim.parallel import MeshChunkedAllPairs, make_mesh

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500


def small_cfg(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return AllPairsConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_mesh_chunked_matches_oracle(corpus, mesh):
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    stats = eng.build(corpus)
    assert stats["n_chunks"] % 8 == 0 and stats["n_chunks"] >= 8
    for tau in (0.3, 0.5, 0.7):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_mesh_chunked_panel_path_matches_oracle(corpus, mesh):
    """Sharded panel join: per-device column-sharded slabs, partial int8
    dots, exact int32 psum, replicated epilogue — multi-panel sweep with
    exact parity + insert invalidation."""
    eng = MeshChunkedAllPairs(
        small_cfg(), mesh=mesh, chunk_dim=32, panel_rows=64
    )
    eng.build(corpus)
    assert eng._panel_ok()
    assert eng._panel_geom()[1] >= 2  # off-diagonal pairs exercised
    for tau in (0.3, 0.6):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    # streaming insert invalidates the sharded sorted-COO state
    extra = [(f"x{i}", corpus.row(i)) for i in range(3)]
    eng.insert(extra, tau=0.6)
    from apsim.vector.batch import CSRMatrix

    vecs = [corpus.row(i) for i in range(corpus.n_rows)] + [
        corpus.row(i) for i in range(3)
    ]
    ids = [str(i) for i in range(corpus.n_rows)] + [f"x{i}" for i in range(3)]
    allcsr = CSRMatrix.from_vectors(vecs, DIM)
    assert eng.all_pairs(0.6).pair_set() == brute_force_pairs(
        allcsr, 0.6, ids
    )


def test_mesh_chunked_panel_tiny_caps(corpus, mesh):
    eng = MeshChunkedAllPairs(
        small_cfg(extract_cap=1024), mesh=mesh,
        chunk_dim=32, panel_rows=64,
    )
    eng.build(corpus)
    assert eng.all_pairs(0.2).pair_set() == brute_force_pairs(corpus, 0.2)


def test_mesh_chunked_int8_stripes_opt_in_matches(corpus, mesh):
    """Mesh int8 stripes: per-row quantization assembled across chunk
    shards (pmax/psum), exact int32 partial-dot psum, per-pair bound
    epilogue — same pair set as the bf16 stripe path."""
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    eng._int8_stripes = True
    eng._use_panels = False
    eng.build(corpus)
    assert eng._int8_slabs() is not None  # gate passed, cache primed
    for tau in (0.4, 0.7):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_mesh_chunked_entries_actually_sharded(corpus, mesh):
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    eng.build(corpus)
    for a in eng._ent:
        assert len(a.sharding.device_set) == 8
        # each device holds 1/8 of the chunk axis
        shard = a.addressable_shards[0]
        assert shard.data.shape[0] == a.shape[0] // 8
    layout = eng.shard_layout()
    assert len(layout) == 8
    # device entries + host-archived dormant (df==1) entries = corpus nnz
    assert sum(v["n_entries"] for v in layout.values()) + eng.stats[
        "dormant_dims"
    ] == int(corpus.indptr[-1])


def test_mesh_chunked_matches_single_device(corpus, mesh):
    from apsim.engine import ChunkedAllPairs

    single = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    single.build(corpus)
    sharded = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=64)
    sharded.build(corpus)
    assert (
        sharded.all_pairs(0.4).pair_set() == single.all_pairs(0.4).pair_set()
    )


def test_mesh_chunked_overflow_retry(corpus, mesh):
    eng = MeshChunkedAllPairs(
        small_cfg(extract_cap=8), mesh=mesh, chunk_dim=32
    )
    eng.build(corpus)
    got = eng.all_pairs(0.3).pair_set()
    assert got == brute_force_pairs(corpus, 0.3)
    assert len(got) > 8


def test_mesh_chunked_topk(corpus, mesh):
    from oracle import brute_force_sims

    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    eng.build(corpus)
    queries = [(f"q{i}", corpus.row(i)) for i in range(5)]
    res = eng.topk(queries, 4)
    sims = brute_force_sims(corpus)
    for qi in range(5):
        got = np.array([s for _, s in res[f"q{qi}"]])
        want = np.sort(sims[qi])[::-1][:4]
        np.testing.assert_allclose(got, want, atol=1e-9)


def test_mesh_chunked_streaming_equals_batch(mesh):
    rng = np.random.default_rng(11)
    corpus = random_sparse_corpus(rng, 150, DIM)
    tau = 0.4
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    emitted = set()
    for s in range(0, corpus.n_rows, 37):
        e = min(s + 37, corpus.n_rows)
        out = eng.insert(
            [(str(i), corpus.row(i)) for i in range(s, e)], tau=tau
        )
        for q, sims in out.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == brute_force_pairs(corpus, tau)
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_mesh_chunked_streaming_grows_capacity_and_dims(mesh):
    # capacity doubling + new-dim minting, all through the shard_map ops
    from apsim.vector.sparse import Vectors

    rng = np.random.default_rng(3)
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=16)
    seen = set()
    for step in range(4):
        vecs = []
        for i in range(30):
            dims = np.sort(
                rng.choice(
                    np.arange(step * 90, step * 90 + 90), 5, replace=False
                )
            ).astype(np.int32)
            vals = rng.random(5) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append((f"{step}:{i}", Vectors.sparse(DIM, dims, vals)))
        out = eng.insert(vecs, tau=0.9)
        for q, sims in out.output.items():
            for c in sims:
                seen.add((q, c) if q <= c else (c, q))
    assert eng.n_rows == 120
    got = eng.all_pairs(0.9).pair_set()
    want = brute_force_pairs(eng._shadow.view(), 0.9, eng.ids)
    assert got == want
    assert seen == want


def test_mesh_chunked_dormant_roundtrip(mesh):
    # dormant archive + activation through the shard_map append path
    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import Vectors

    v = Vectors.sparse
    a = 1 / np.sqrt(2)
    corpus = CSRMatrix.from_vectors(
        [
            v(DIM, [5, 7], [a, a]),
            v(DIM, [5, 8], [a, a]),
            v(DIM, [100, 101], [a, a]),
        ],
        DIM,
    )
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=16)
    eng.build(corpus)
    assert eng.stats["dormant_dims"] >= 2
    assert eng.all_pairs(0.3).pair_set() == brute_force_pairs(corpus, 0.3)
    out = eng.insert([("new", v(DIM, [100, 300], [a, a]))], tau=0.4)
    assert out.output.get("new", {}).get("2") == pytest.approx(0.5)
    res = eng.topk([("q", v(DIM, [100, 101], [a, a]))], 2)["q"]
    assert res[0][0] == "2" and res[0][1] == pytest.approx(1.0)


def test_mesh_chunked_freeze_external_match(mesh):
    rng = np.random.default_rng(5)
    corpus = random_sparse_corpus(rng, 80, DIM)
    eng = MeshChunkedAllPairs(small_cfg(), mesh=mesh, chunk_dim=32)
    eng.build(corpus)
    eng.freeze()
    out = eng.insert([("probe", corpus.row(0))], tau=0.9)
    assert out.output.get("probe", {}).get("0") == pytest.approx(1.0)
    assert eng.n_rows == corpus.n_rows
