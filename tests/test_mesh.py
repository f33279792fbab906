"""Mesh-sharded engine tests on the 8-device virtual CPU mesh
(the multi-device test strategy from SURVEY.md §4)."""

import numpy as np
import pytest

from apsim import AllPairsConfig
from apsim.parallel import MeshEngine, make_mesh

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500


def mesh_cfg(axis, **kw):
    base = dict(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
        shard_axis=axis,
    )
    base.update(kw)
    return AllPairsConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


def test_mesh_rows_pallas_fast_path(corpus, mesh8):
    """Rows-sharded int8 join under shard_map: each device scores its
    striped share of the upper-triangle panel pairs against the
    all-gathered int8 index — with exact parity."""
    eng = MeshEngine(
        mesh_cfg("rows", row_bucket=512), mesh=mesh8
    )
    eng._int8_panel_rows = 128  # several panel pairs across the devices
    eng.build(corpus)
    assert eng.x.sharding.num_devices == 8
    assert eng._int8_ok() and eng._mesh_rows_panel() == 128
    for tau in (0.4, 0.7):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    # streaming insert keeps the fast path exact
    out = eng.insert([("z0", corpus.row(0))], tau=0.6)
    assert out.output  # duplicate of row 0 must match
    assert eng._int8_ok()
    got = eng.all_pairs(0.6).pair_set()
    from apsim.vector.batch import CSRMatrix

    vecs = [corpus.row(i) for i in range(corpus.n_rows)] + [corpus.row(0)]
    ids = [str(i) for i in range(corpus.n_rows)] + ["z0"]
    allcsr = CSRMatrix.from_vectors(vecs, DIM)
    assert got == brute_force_pairs(allcsr, 0.6, ids)


def test_mesh_rows_pallas_tiny_caps(corpus, mesh8):
    # overflow-retry across the stacked per-device heads
    eng = MeshEngine(
        mesh_cfg("rows", row_bucket=512, extract_cap=1024),
        mesh=mesh8,
    )
    eng.build(corpus)
    assert eng._int8_ok()
    assert eng.all_pairs(0.2).pair_set() == brute_force_pairs(corpus, 0.2)


@pytest.mark.parametrize("axis", ["dims", "rows"])
def test_mesh_all_pairs_parity(corpus, mesh8, axis):
    eng = MeshEngine(mesh_cfg(axis), mesh=mesh8)
    eng.build(corpus)
    assert eng.x.sharding.num_devices == 8
    for tau in (0.4, 0.6):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


@pytest.mark.parametrize("axis", ["dims", "rows"])
def test_mesh_streaming_parity(corpus, mesh8, axis):
    tau = 0.5
    eng = MeshEngine(mesh_cfg(axis), mesh=mesh8)
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
    # sharding survives growth
    assert eng.x.sharding.num_devices == 8


def test_mesh_topk(corpus, mesh8):
    eng = MeshEngine(mesh_cfg("dims"), mesh=mesh8)
    eng.build(corpus)
    res = eng.topk([("q", corpus.row(5))], 4)
    assert res["q"][0][0] == "5"
    assert res["q"][0][1] == pytest.approx(1.0, abs=1e-5)


def test_mesh_smaller_than_devices(corpus):
    # a 2-device mesh on an 8-device host
    eng = MeshEngine(mesh_cfg("dims"), mesh=make_mesh(2))
    eng.build(corpus)
    assert eng.x.sharding.num_devices == 2
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def test_mesh_2d_rows_by_dims(corpus):
    # 2-D mesh: rows x dims jointly sharded (P('rows','dims'))
    eng = MeshEngine(mesh_cfg("dims"), mesh=make_mesh((2, 4)))
    eng.build(corpus)
    assert eng.cfg.shard_axis == "both"
    assert eng.x.sharding.num_devices == 8
    for tau in (0.4, 0.6):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    # streaming on the 2-D mesh
    out = eng.insert([("probe", corpus.row(0))], tau=0.5)
    assert "0" in out.output.get("probe", {})
    layout = eng.shard_layout()
    assert len(layout) == 8
    first = next(iter(layout.values()))
    assert "row_block" in first and "dim_block" in first


def test_shard_layout_introspection(corpus, mesh8):
    eng = MeshEngine(mesh_cfg("dims"), mesh=mesh8)
    eng.build(corpus)
    layout = eng.shard_layout()
    assert len(layout) == 8
    blocks = sorted(v["dim_block"] for v in layout.values())
    # contiguous, disjoint, covering [0, dim_cap)
    assert blocks[0][0] == 0
    for (a0, a1), (b0, b1) in zip(blocks, blocks[1:]):
        assert a1 == b0
    assert blocks[-1][1] == eng.dim_cap


def test_rows_schedule_balanced_and_complete():
    """The striped per-device schedules must (a) exactly cover the global
    upper-triangle panel-pair schedule and (b) be balanced to ±1 pair — a
    contiguous partition would give device 0 ~2× the average, and every
    device runs at its padded pace."""
    from apsim.ops.mesh_rows import rows_schedule
    from apsim.ops.panel import upper_panel_pairs

    row_cap, n_dev, rb = 1024, 8, 64
    bi_a, bj_a, va_a = rows_schedule(row_cap, n_dev, rb)
    gi, gj = upper_panel_pairs(row_cap // rb)
    got = set()
    counts = []
    for d in range(n_dev):
        live = va_a[d] == 1
        counts.append(int(live.sum()))
        got |= set(zip(bi_a[d][live].tolist(), bj_a[d][live].tolist()))
    assert got == set(zip(gi.tolist(), gj.tolist()))
    assert max(counts) - min(counts) <= 1


def test_mesh_rows_geom_no_brows_alignment():
    """Eligibility regression: with the gathered-copy schedule only
    ``row_cap`` must tile — a corpus whose per-device row block is NOT a
    multiple of the panel height (the common case on real corpora) must
    still qualify for the int8 path."""
    from types import SimpleNamespace

    # row_cap % 1024 == 0 but row_cap // 8 devices (12544) is not a
    # multiple of the chosen panel height
    fake = SimpleNamespace(
        cfg=SimpleNamespace(shard_axis="rows"), _int8_panel_rows=8192,
        x=object(), row_cap=1024 * 98, dim_cap=4096, n_shards=8,
    )
    rb = MeshEngine._mesh_rows_panel(fake)
    assert rb is not None and fake.row_cap % rb == 0 and rb <= 8192
    assert (fake.row_cap // fake.n_shards) % rb != 0  # the old gate
