"""Chunked-sparse batch join: exact parity without a resident dense index."""

import numpy as np
import pytest

from apsim import AllPairsConfig
from apsim.engine import ChunkedAllPairs

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500


def small_cfg(**kw):
    base = dict(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
    )
    base.update(kw)
    return AllPairsConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.mark.parametrize("panels", [True, False], ids=["panels", "stripes"])
def test_chunked_matches_oracle(corpus, panels):
    eng = ChunkedAllPairs(
        AllPairsConfig(
            vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
        ),
        chunk_dim=128,
    )
    eng._use_panels = panels
    stats = eng.build(corpus)
    assert eng._panel_ok() == panels
    assert stats["n_chunks"] >= 2  # actually exercises the chunk loop
    for tau in (0.3, 0.5, 0.7):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_chunked_panel_path_matches_oracle(corpus):
    """int8 panel join: multi-panel sweep with off-diagonal pairs, exact
    parity, cache invalidation on insert."""
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128, panel_rows=64)
    eng.build(corpus)
    assert eng._panel_ok()
    geom = eng._panel_geom()
    assert geom[1] >= 2  # n_panels: actually exercises off-diagonal pairs
    for tau in (0.3, 0.6):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    # streaming insert invalidates the sorted-COO cache; join stays exact
    from apsim.vector.batch import CSRMatrix

    extra = [(f"x{i}", corpus.row(i)) for i in range(3)]
    eng.insert(extra, tau=0.6)
    got = eng.all_pairs(0.6).pair_set()
    vecs = [corpus.row(i) for i in range(corpus.n_rows)] + [
        corpus.row(i) for i in range(3)
    ]
    allcsr = CSRMatrix.from_vectors(vecs, DIM)
    ids = [str(i) for i in range(corpus.n_rows)] + [f"x{i}" for i in range(3)]
    assert got == brute_force_pairs(allcsr, 0.6, ids)


def test_chunked_panel_rolling_sweep(corpus):
    """Out-of-core rolling mode: slabs do NOT all stay resident.  Shrink
    the HBM budgets so the blocked-I schedule runs with multiple I-blocks
    and mid-scan flushes, with caps forced low to also exercise the
    rebuild-on-overflow retry inside flush_window.  Exact parity."""
    eng = ChunkedAllPairs(
        small_cfg(extract_cap=1024), chunk_dim=128, panel_rows=64,
    )
    eng._panel_resident_bytes = 0  # force rolling mode
    eng.build(corpus)
    assert eng._panel_ok()
    state = eng._panel_state()
    rb, n_panels, d_cap = state["geom"]
    assert n_panels >= 3  # several I-blocks at B<=2
    eng._panel_sweep_bytes = 4 * rb * d_cap  # S=4 -> B=2, jsync=1
    for tau in (0.2, 0.6):
        assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_chunked_panel_single_panel(corpus):
    # auto geometry on a small corpus: one panel, diagonal pair only
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128)
    eng.build(corpus)
    assert eng._panel_ok() and eng._panel_geom()[1] == 1
    assert eng.all_pairs(0.4).pair_set() == brute_force_pairs(corpus, 0.4)


def test_chunked_panel_all_dormant_corpus():
    """Every dim df==1 -> ZERO device entries; the panel path must still
    run (empty slabs, 0 pairs), and a later duplicate insert must activate
    the archived dims and surface the pair through the panel rejoin."""
    from apsim.vector.sparse import Vectors

    cfg = AllPairsConfig(vector_dim=300, query_tile=64, row_bucket=64,
                         dim_bucket=64)
    eng = ChunkedAllPairs(cfg, chunk_dim=64, panel_rows=64)
    eng.build([
        (f"v{i}", Vectors.sparse(300, [i * 3, i * 3 + 1], [0.6, 0.8]))
        for i in range(40)
    ])
    assert eng.all_pairs(0.5).n_pairs == 0
    out = eng.insert(
        [("dup", Vectors.sparse(300, [0, 1], [0.6, 0.8]))], tau=0.5
    )
    assert "dup" in out.output and "v0" in out.output["dup"]
    assert eng.all_pairs(0.5).n_pairs == 1


def test_chunked_panel_tiny_caps(corpus):
    # overflow-retry protocol: caps far below the candidate count
    eng = ChunkedAllPairs(
        small_cfg(extract_cap=1024), chunk_dim=128, panel_rows=64,
    )
    eng.build(corpus)
    assert eng.all_pairs(0.2).pair_set() == brute_force_pairs(corpus, 0.2)


def test_chunked_matches_dense_engine(corpus):
    from apsim import Engine

    cfg = AllPairsConfig(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
    )
    dense = Engine(cfg)
    dense.build(corpus)
    chunked = ChunkedAllPairs(cfg, chunk_dim=256)
    chunked.build(corpus)
    assert chunked.all_pairs(0.4).pair_set() == dense.all_pairs(0.4).pair_set()


def test_chunked_single_chunk(corpus):
    # chunk_dim >= active dims: degenerates to one dense chunk
    eng = ChunkedAllPairs(
        AllPairsConfig(
            vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
        ),
        chunk_dim=1024,
    )
    stats = eng.build(corpus)
    assert stats["n_chunks"] == 1
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def test_chunked_topk(corpus):
    from oracle import brute_force_sims

    eng = ChunkedAllPairs(
        AllPairsConfig(
            vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
        ),
        chunk_dim=128,
    )
    eng.build(corpus)
    queries = [(f"q{i}", corpus.row(i)) for i in range(5)]
    res = eng.topk(queries, 4)
    sims = brute_force_sims(corpus)
    for qi in range(5):
        got = np.array([s for _, s in res[f"q{qi}"]])
        want = np.sort(sims[qi])[::-1][:4]
        np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("panels", [True, False], ids=["panels", "stripes"])
def test_chunked_overflow_retry(corpus, panels):
    eng = ChunkedAllPairs(
        AllPairsConfig(
            vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
            extract_cap=8,
        ),
        chunk_dim=128,
    )
    eng._use_panels = panels
    eng.build(corpus)
    got = eng.all_pairs(0.3).pair_set()
    assert got == brute_force_pairs(corpus, 0.3)
    assert len(got) > 8


def test_chunked_int8_stripes_opt_in_matches(corpus):
    # opt-in int8 stripes (the stripe path, not the panel join): must
    # engage when asked and emit the identical exact pair set
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128)
    eng._int8_stripes = True
    eng._use_panels = False
    eng.build(corpus)
    got = eng.all_pairs(0.4).pair_set()
    assert eng._int8_slabs() is not None  # engaged
    off = ChunkedAllPairs(small_cfg(), chunk_dim=128)
    off._use_panels = False
    off.build(corpus)
    assert off._int8_slabs() is None  # default: bf16 slabs
    assert off.all_pairs(0.4).pair_set() == got == brute_force_pairs(
        corpus, 0.4
    )
    # appends invalidate the quantized cache (keyed by array identity)
    key_before = eng._q8_cache[0]
    eng.insert([("zz", corpus.row(0))], tau=0.9)
    eng.all_pairs(0.4)
    assert eng._q8_cache[0] is not key_before


def test_chunked_streaming_equals_batch():
    # stream the corpus in micro-batches: emitted pair set must equal the
    # fp64 brute-force join, with intra-batch pairs surfacing symmetrically
    rng = np.random.default_rng(11)
    corpus = random_sparse_corpus(rng, 150, DIM)
    tau = 0.4
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128)
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
    # the final index state joins exactly too
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


def test_chunked_streaming_grows_capacity_and_dims():
    # force chunk_cap doubling AND brand-new dims across inserts
    from apsim.vector.sparse import Vectors

    rng = np.random.default_rng(3)
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=64)
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


def _dormant_corpus():
    # rows 0,1 share dim 5; row 2 has UNIQUE dims {100, 101} (df==1 ->
    # dormant: archived host-side, off the chunk buffers)
    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import Vectors

    v = Vectors.sparse
    a = 1 / np.sqrt(2)
    vecs = [
        v(DIM, [5, 7], [a, a]),
        v(DIM, [5, 8], [a, a]),
        v(DIM, [100, 101], [a, a]),
    ]
    return CSRMatrix.from_vectors(vecs, DIM)


def test_chunked_dormant_archived_and_exact():
    from oracle import brute_force_pairs as bf

    corpus = _dormant_corpus()
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=16)
    st = eng.build(corpus)
    assert eng.stats["dormant_dims"] >= 2
    assert st["entries"] == int(corpus.indptr[-1])  # stats count everything
    assert eng.all_pairs(0.3).pair_set() == bf(corpus, 0.3)


def test_chunked_dormant_activation_on_insert():
    from apsim.vector.sparse import Vectors
    from oracle import brute_force_pairs as bf

    corpus = _dormant_corpus()
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=16)
    eng.build(corpus)
    a = 1 / np.sqrt(2)
    out = eng.insert([("new", Vectors.sparse(DIM, [100, 300], [a, a]))],
                     tau=0.4)
    assert out.output.get("new", {}).get("2") == pytest.approx(0.5)
    assert eng.all_pairs(0.4).pair_set() == bf(
        eng.shadow_csr(), 0.4, eng.ids
    )


def test_chunked_dormant_topk_and_frozen_match():
    from apsim.vector.sparse import Vectors

    corpus = _dormant_corpus()
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=16)
    eng.build(corpus)
    a = 1 / np.sqrt(2)
    q = Vectors.sparse(DIM, [100, 101], [a, a])  # only dormant dims
    res = eng.topk([("q", q)], 2)["q"]
    assert res[0] == ("2", pytest.approx(1.0))
    eng.freeze()
    out = eng.insert([("probe", q)], tau=0.9)
    assert out.output.get("probe", {}).get("2") == pytest.approx(1.0)


def test_chunked_streaming_from_empty_with_dormant():
    # build-via-insert: first batch archives df==1 dims; later batches
    # activate them; emitted set stays exact throughout
    from oracle import brute_force_pairs as bf

    rng = np.random.default_rng(17)
    corpus = random_sparse_corpus(rng, 90, DIM)
    tau = 0.4
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=32)
    emitted = set()
    for s in range(0, corpus.n_rows, 30):
        out = eng.insert(
            [(str(i), corpus.row(i)) for i in range(s, min(s + 30, 90))],
            tau=tau,
        )
        for q, sims in out.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == bf(corpus, tau)
    assert eng.all_pairs(tau).pair_set() == bf(corpus, tau)


def test_rebuild_clears_dormant_archive():
    # regression: a rebuild whose corpus has no df==1 dims must not keep the
    # previous build's archive (stale rows would corrupt topk candidates)
    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import Vectors

    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=16)
    eng.build(_dormant_corpus())
    assert eng.stats["dormant_dims"] >= 2
    small = CSRMatrix.from_vectors(
        [v(DIM, [5, 7], [a, a]), v(DIM, [5, 7], [a, a])], DIM
    )
    eng.build(small, ["x", "y"])
    assert eng.stats["dormant_dims"] == 0
    # query containing the OLD corpus's dormant dim: no stale candidate
    res = eng.topk([("q", v(DIM, [100, 101], [a, a]))], 2)["q"]
    assert all(r in ("x", "y") for r, _ in res)


def test_chunked_frozen_empty_insert_indexes_nothing():
    # frozen before anything was indexed: match-only, index stays empty
    from apsim.vector.sparse import Vectors

    a = 1 / np.sqrt(2)
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=16)
    eng.freeze()
    out = eng.insert([("p", Vectors.sparse(DIM, [1, 2], [a, a]))], tau=0.5)
    assert out.output == {}
    assert eng.n_rows == 0


def test_chunked_freeze_external_match():
    rng = np.random.default_rng(5)
    corpus = random_sparse_corpus(rng, 80, DIM)
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128)
    eng.build(corpus)
    eng.freeze()
    out = eng.insert([("probe", corpus.row(0))], tau=0.9)
    assert out.output.get("probe", {}).get("0") == pytest.approx(1.0)
    assert eng.n_rows == corpus.n_rows  # nothing indexed while frozen


def test_chunked_streaming_slab_cache_matches_fallback():
    # all three streaming match paths must emit the exact same pair
    # stream: (a) resident match-slab cache, (b) host spGEMM match
    # (over-budget default), (c) per-batch device rebuild (the mesh
    # subclass's gated path, forced here via _host_stream_match=False)
    from oracle import brute_force_pairs as bf

    rng = np.random.default_rng(41)
    corpus = random_sparse_corpus(rng, 140, DIM)
    tau = 0.4
    streams = []
    for budget, host in ((7168, True), (0, True), (0, False)):
        eng = ChunkedAllPairs(
            small_cfg(match_slab_budget_mb=budget), chunk_dim=64
        )
        eng._host_stream_match = host
        # tiny corpora have high relative df, so the round-4 cost router
        # would pick the device side — force the host model to win so this
        # test keeps exercising the spGEMM path it was written for
        if host:
            eng._rebuild_ns_per_nnz = float("inf")
        emitted = set()
        for s in range(0, corpus.n_rows, 33):
            e = min(s + 33, corpus.n_rows)
            out = eng.insert(
                [(str(i), corpus.row(i)) for i in range(s, e)], tau=tau
            )
            for q, sims in out.output.items():
                for c in sims:
                    emitted.add((q, c) if q <= c else (c, q))
        if budget:
            assert eng._mslab is not None  # the cache actually engaged
        else:
            assert eng._mslab is None
        streams.append(emitted)
    assert streams[0] == streams[1] == streams[2] == bf(corpus, tau)


def test_host_match_cost_router():
    # the host spGEMM pays per intersection flop (on a 500k power-law corpus
    # a 256-row batch hits ~128M intersections), so routing must weigh
    # batch df mass, not assume host is always cheaper beyond the slab
    # budget
    rng = np.random.default_rng(47)
    corpus = random_sparse_corpus(rng, 120, DIM)
    eng = ChunkedAllPairs(small_cfg(match_slab_budget_mb=0), chunk_dim=64)
    eng.build(corpus)
    nnz = int(eng._shadow.view().indptr[-1])
    cold = np.array([DIM - 1], np.int64)
    # no device match timed yet: stay on the device
    assert eng._rebuild_ns_per_nnz is None
    assert not eng._use_host_match(cold)
    eng._rebuild_ns_per_nnz = 20.0
    # cold batch: dims nobody uses -> est_flops 0 -> host wins
    assert eng._ext_df[cold].sum() * eng._host_ns_per_flop < nnz
    assert eng._use_host_match(cold)
    # hot batch: replicate the corpus' own dims until the flop estimate
    # dominates the rebuild cost -> device wins
    hot = np.tile(corpus.indices, 8)
    assert not eng._use_host_match(hot)
    # no df stats (pre-round-4 restore shape): stay on the device path
    eng._ext_df = None
    assert not eng._use_host_match(cold)


def test_router_device_term_is_observed():
    """The router's device cost per corpus nnz comes from device matches
    beyond the slab budget that ran with no compile in flight (the fastest
    one seen); matches against resident slabs are not timed."""
    from apsim.engine import chunked

    rng = np.random.default_rng(53)
    corpus = random_sparse_corpus(rng, 100, DIM)
    seen = []
    for budget in (0, 7168):
        eng = ChunkedAllPairs(
            small_cfg(match_slab_budget_mb=budget), chunk_dim=64
        )
        eng.build(corpus)
        for s in range(0, 80, 20):
            eng.insert([(f"n{s + i}", corpus.row(s + i)) for i in range(20)],
                       tau=0.5)
            seen.append(eng._rebuild_ns_per_nnz)
    over = [v for v in seen[:4] if v is not None]
    assert over and all(v > 0 for v in over)
    assert over == sorted(over, reverse=True)  # the fastest match is kept
    assert seen[4:] == [None] * 4
    # a match that compiles is not timed
    eng = ChunkedAllPairs(small_cfg(match_slab_budget_mb=0), chunk_dim=64)
    eng.build(corpus)
    chunked._compile_count()  # listener registered

    def compiling_match(*_):
        chunked._compiles += 1
        return np.empty(0, np.int64), np.empty(0, np.int64)

    eng._match_ccsr = compiling_match
    eng._timed_device_match(None, 0, 0.5)
    assert eng._rebuild_ns_per_nnz is None


def test_chunked_host_match_external_and_dormant():
    # the host spGEMM path must also serve the frozen external match and
    # fold archived dormant-dim contributions in without the explicit
    # _dormant_hits patch (they live in the shadow CSR it walks)
    rng = np.random.default_rng(43)
    corpus = random_sparse_corpus(rng, 90, DIM)
    tau = 0.35
    results = []
    for host in (True, False):
        eng = ChunkedAllPairs(
            small_cfg(match_slab_budget_mb=0, dormant_dims=True),
            chunk_dim=64,
        )
        eng._host_stream_match = host
        if host:
            eng._rebuild_ns_per_nnz = float("inf")  # force the host route
        eng.build(corpus)  # build archives df==1 dims to the dormant tier
        eng.freeze()
        queries = [(f"q{j}", corpus.row(j)) for j in range(0, 40, 3)]
        out = eng.insert(queries, tau=tau)
        results.append({
            q: dict(sims) for q, sims in out.output.items()
        })
    assert results[0] == results[1]
    assert any(results[0].values())  # non-vacuous


def test_chunked_slab_cache_lifecycle():
    # cache builds on first match, survives same-geometry appends, is
    # dropped by all_pairs (HBM release) and by geometry growth, and the
    # results stay exact throughout
    from oracle import brute_force_pairs as bf
    from apsim.vector.sparse import Vectors

    rng = np.random.default_rng(42)
    corpus = random_sparse_corpus(rng, 60, DIM)
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    eng.build(corpus)
    assert eng._mslab is None  # lazy: nothing resident until a match
    eng.insert([("a", corpus.row(0))], tau=0.5)
    assert eng._mslab is not None
    shape1 = eng._mslab.shape
    eng.insert([("b", corpus.row(1))], tau=0.5)  # same geometry: in-place
    assert eng._mslab.shape == shape1
    res = eng.all_pairs(0.5)
    assert eng._mslab is None  # join released the cache
    assert res.pair_set() == bf(eng.shadow_csr(), 0.5, eng.ids)
    # brand-new dims force compact-space growth past the chunk width:
    # cache must rebuild at the new geometry, match still exact
    a = 1 / np.sqrt(2)
    w0 = eng._chunk_width
    step = 0
    while eng._chunk_width == w0:
        d = 64 * eng._n_chunks + step * 2  # mint fresh compact dims
        vecs = [
            (f"n{step}", Vectors.sparse(DIM, [d % DIM, (d + 1) % DIM],
                                        [a, a])),
            (f"m{step}", Vectors.sparse(DIM, [d % DIM, (d + 3) % DIM],
                                        [a, a])),
        ]
        eng.insert(vecs, tau=0.5)
        step += 1
        assert step < 80, "width never grew"
    assert eng._mslab is None or eng._mslab.shape[2] == eng._chunk_width
    assert eng.all_pairs(0.5).pair_set() == bf(
        eng.shadow_csr(), 0.5, eng.ids
    )


def test_chunked_topk_cache_matches_fallback():
    # cached (resident-slab) topk == rebuild-path topk, exact re-rank both
    rng = np.random.default_rng(7)
    corpus = random_sparse_corpus(rng, 120, DIM)
    res = []
    for budget in (0, 7168):
        eng = ChunkedAllPairs(
            small_cfg(match_slab_budget_mb=budget), chunk_dim=64
        )
        eng.build(corpus)
        queries = [(f"q{i}", corpus.row(i)) for i in range(0, 40, 3)]
        res.append(eng.topk(queries, 5))
        if budget:
            assert eng._mslab is not None
    assert res[0].keys() == res[1].keys()
    for q in res[0]:
        assert [r for r, _ in res[0][q]] == [r for r, _ in res[1][q]]
        for (_, s0), (_, s1) in zip(res[0][q], res[1][q]):
            assert s0 == pytest.approx(s1, abs=1e-12)


def test_chunked_match_width_split_exact():
    # a flush batch wider than the match-accumulator width limit is split
    # into sub-matches (q_base offset per part); emitted set stays exact,
    # including intra-batch pairs that straddle the split point
    from oracle import brute_force_pairs as bf

    rng = np.random.default_rng(77)
    corpus = random_sparse_corpus(rng, 120, DIM)
    tau = 0.4
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    eng._match_width_limit = lambda: 16  # force the split path
    emitted = set()
    for s in range(0, corpus.n_rows, 50):  # 50 > 16: every batch splits
        e = min(s + 50, corpus.n_rows)
        out = eng.insert(
            [(str(i), corpus.row(i)) for i in range(s, e)], tau=tau
        )
        for q, sims in out.output.items():
            for c in sims:
                a, b = sorted((int(q), int(c)))
                emitted.add((str(a), str(b)))
    want = {tuple(str(x) for x in sorted(map(int, p)))
            for p in bf(corpus, tau)}
    assert emitted == want
    # frozen external matching takes the same split path
    eng.freeze()
    out = eng.insert(
        [(f"p{i}", corpus.row(i)) for i in range(40)], tau=0.99
    )
    for i in range(40):
        assert out.output.get(f"p{i}", {}).get(str(i)) == pytest.approx(1.0)


def test_chunked_topk_width_split(corpus):
    """Bulk k-NN batches are width-split (the [q_rows_cap, row_cap] fp32
    accumulator is budget-bounded like the streaming match); the merged
    result must equal the unsplit one."""
    from apsim.config import AllPairsConfig

    eng = ChunkedAllPairs(
        AllPairsConfig(vector_dim=DIM, query_tile=64, row_bucket=64,
                       dim_bucket=64),
        chunk_dim=64,
    )
    eng.build(corpus)
    queries = [(f"q{i}", corpus.row(i)) for i in range(24)]
    whole = eng.topk(queries, 3)
    eng._match_width_limit = lambda: 8  # force 3 sub-batches
    split = eng.topk(queries, 3)
    assert split == whole and len(split) == 24


def test_chunked_super_tile_override_divides_row_cap():
    """A manual super_tile above 8192 must be rounded down to a DIVISOR of
    row_cap: above 8192 rows row_cap is a multiple of 8192 but not a power
    of two, and a non-divisor stripe silently loses the clamped rows'
    pairs."""
    from apsim.config import AllPairsConfig

    eng = ChunkedAllPairs(AllPairsConfig(), super_tile=16384)
    eng.n_rows = 20000  # row_cap -> 24576 = 3 * 8192 (not a power of two)
    assert eng.row_cap == 24576
    st = eng._q_super()
    assert eng.row_cap % st == 0 and st <= 16384


def test_chunked_save_restore_roundtrip(corpus, tmp_path):
    """Checkpoint roundtrip: the restored engine emits the identical pair
    set and keeps streaming exactly (restore is a re-build from the
    checkpoint CSR — gather-only remap, no lexsort; VERDICT r3 #7)."""
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    eng.build(corpus, [f"v{i}" for i in range(corpus.n_rows)])
    want = eng.all_pairs(0.5).pair_set()
    path = str(tmp_path / "ck.npz")
    eng.save(path)

    e2 = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    e2.restore(path)
    assert e2.n_rows == corpus.n_rows
    assert e2.ids == eng.ids
    assert e2.all_pairs(0.5).pair_set() == want
    # streaming continues exactly across the roundtrip: restored engine's
    # insert output matches the original engine's
    out_orig = eng.insert([("probe", corpus.row(0))], tau=0.5)
    out_rest = e2.insert([("probe", corpus.row(0))], tau=0.5)
    got = out_rest.output.get("probe", {})
    assert got and got == out_orig.output.get("probe", {})


def test_chunked_fast_restore_places_saved_layout(corpus, tmp_path):
    """Chunked checkpoints carry the device-buffer mirror: restore takes
    the FAST path (no rebuild), reproducing the exact internal layout —
    including state only streaming can create (grown capacity, minted
    dims, dormant activations)."""
    eng = ChunkedAllPairs(small_cfg(dormant_dims=True), chunk_dim=64)
    n0 = corpus.n_rows - 40
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng.build(head, [f"v{i}" for i in range(n0)])
    for s in range(n0, corpus.n_rows, 8):  # stream the tail (append+grow)
        eng.insert(
            [(f"v{i}", corpus.row(i))
             for i in range(s, min(s + 8, corpus.n_rows))],
            tau=0.5,
        )
    want = eng.all_pairs(0.5).pair_set()
    path = str(tmp_path / "ck")
    eng.save(path)

    e2 = ChunkedAllPairs(small_cfg(dormant_dims=True), chunk_dim=64)
    z = np.load(path + "/index.npz")
    assert e2._fast_restorable(z)  # the fast path is actually taken
    e2.restore(path)
    # layout equality, not just behavioral parity
    assert e2._n_chunks == eng._n_chunks
    assert e2._chunk_cap == eng._chunk_cap
    np.testing.assert_array_equal(e2._counts, eng._counts)
    np.testing.assert_array_equal(
        e2._compact.ext_of_col, eng._compact.ext_of_col
    )
    assert e2._compact._base == eng._compact._base
    assert e2._max_norm == eng._max_norm
    np.testing.assert_array_equal(e2._dorm_dims, eng._dorm_dims)
    for a, b in zip(e2._ent_host, eng._ent_host):
        np.testing.assert_array_equal(a, b)
    # behavior: identical pair set, identical continued streaming
    assert e2.all_pairs(0.5).pair_set() == want
    out_orig = eng.insert([("probe", corpus.row(1))], tau=0.5)
    out_rest = e2.insert([("probe", corpus.row(1))], tau=0.5)
    assert (
        out_rest.output.get("probe", {}) == out_orig.output.get("probe", {})
    )


def test_chunked_restore_falls_back_on_geometry_mismatch(corpus, tmp_path):
    """A chunked checkpoint restored under a DIFFERENT chunk_dim (or into
    the dense flavor) must fall back to the rebuild path and still be
    exactly correct."""
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    eng.build(corpus, [f"v{i}" for i in range(corpus.n_rows)])
    want = eng.all_pairs(0.5).pair_set()
    path = str(tmp_path / "ck")
    eng.save(path)

    e2 = ChunkedAllPairs(small_cfg(), chunk_dim=32)  # geometry moved
    z = np.load(path + "/index.npz")
    assert not e2._fast_restorable(z)
    e2.restore(path)
    assert e2.all_pairs(0.5).pair_set() == want

    # dense-flavor checkpoint (no chunk_* extras) into a chunked engine
    from apsim.engine.engine import Engine

    dense = Engine(small_cfg())
    dense.build(corpus, [f"v{i}" for i in range(corpus.n_rows)])
    dpath = str(tmp_path / "ck_dense")
    dense.save(dpath)
    e3 = ChunkedAllPairs(small_cfg(), chunk_dim=64)
    assert not e3._fast_restorable(np.load(dpath + "/index.npz"))
    e3.restore(dpath)
    assert e3.all_pairs(0.5).pair_set() == want


def test_row_cap_law_exact_at_build_geometric_while_streaming():
    """row_cap is exact (quantum-rounded) after build/restore and grows
    GEOMETRICALLY (~25% headroom) while streaming at serving scale, so
    recompile crossings are rare enough for the background prewarmer
    (measured r5: every crossing is a ~70 s cold compile mid-serve)."""
    law = ChunkedAllPairs._row_cap_law
    # build-time: exact quantum rounding, no padding
    assert law(1000, streaming=False) == 1024
    assert law(8586, streaming=False) == 16_384  # q=8192 quantum
    assert law(500_000, streaming=False) == 524_288
    # streaming at scale: ~25% jump, 32768-aligned
    assert law(500_000, streaming=True) == 655_360
    assert law(500_000, streaming=True) >= int(500_000 * 1.25)
    assert law(500_000, streaming=True) % 32_768 == 0
    # below serving scale streaming stays exact (cheap compiles)
    assert law(100_000, streaming=True) == law(100_000, streaming=False)
    # monotone in n either way
    caps = [law(n, True) for n in range(260_000, 700_000, 17_001)]
    assert caps == sorted(caps)

    # the stateful property: build-exact, then jumps only at a crossing
    eng = ChunkedAllPairs(small_cfg())
    eng.n_rows = 500_000
    assert eng.row_cap == 524_288
    eng.n_rows = 524_288          # at the cap: no change
    assert eng.row_cap == 524_288
    eng.n_rows = 524_289          # crossing: geometric jump
    jumped = eng.row_cap
    assert jumped >= int(524_289 * 1.25) and jumped % 32_768 == 0
    assert eng.row_cap == jumped  # sticky
    # _peek_next_row_cap previews exactly the post-crossing value
    eng2 = ChunkedAllPairs(small_cfg())
    eng2.n_rows = 500_000
    assert eng2.row_cap == 524_288
    nxt = eng2._peek_next_row_cap()
    eng2.n_rows = 524_289
    assert eng2.row_cap == nxt


def test_prewarm_compiles_next_rowcap_geometry(corpus):
    """On the rebuild path (beyond the slab budget) each insert kicks a
    background AOT compile of the NEXT row_cap's match program; the
    crossing then hits the persistent compile cache instead of stalling.
    Exactness across the crossing is asserted either way."""
    eng = ChunkedAllPairs(
        small_cfg(match_slab_budget_mb=0),  # force the rebuild path
        chunk_dim=128,
    )
    eng._prewarm_min_rows = 0  # the scale gate, lowered for the test
    n0 = corpus.n_rows - 30
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng.build(head, [str(i) for i in range(n0)])
    assert eng._match_slabs() is None  # really on the rebuild path
    for s in range(n0, corpus.n_rows, 10):
        eng.insert(
            [(str(i), corpus.row(i))
             for i in range(s, min(s + 10, corpus.n_rows))],
            tau=0.5,
        )
    t = eng._prewarm_thread
    assert t is not None  # the kick happened
    t.join(120)
    assert eng.stats.get("prewarm_compiles", 0) >= 1
    # parity after the prewarm machinery ran
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def _paneled_forced(cfg=None, **ekw):
    """A chunked engine forced onto the PANELED streaming-match path
    (match_slab_budget_mb=0 disables the resident-slab fast path)."""
    e = ChunkedAllPairs(
        cfg or small_cfg(match_slab_budget_mb=0, dormant_dims=True),
        **ekw,
    )
    return e


def test_paneled_match_multi_panel_parity(corpus):
    """Streaming matches through the paneled sorted-COO path with SEVERAL
    panels (ph forced below row_cap): exact oracle parity, every oracle
    pair surfaced in the streaming emissions, dormant activations flowing
    through the overflow region."""
    eng = _paneled_forced(chunk_dim=64)
    eng._paneled_ph_cap = 128  # 1024-row cap -> 8 panels
    n0 = 150
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng.build(head, [str(i) for i in range(n0)])
    assert eng._paneled_ok()
    outs = {}
    for s in range(n0, corpus.n_rows, 7):
        out = eng.insert(
            [(str(i), corpus.row(i))
             for i in range(s, min(s + 7, corpus.n_rows))],
            tau=0.5,
        )
        outs.update(out.output)
    st = eng._sort_state
    assert st is not None and st["ph"] == 128
    assert st["n_o"] > 0  # activations actually exercised the overflow
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
    for a, b in brute_force_pairs(corpus, 0.5):
        hi, lo = max(int(a), int(b)), min(int(a), int(b))
        if hi >= n0:
            assert str(lo) in outs.get(str(hi), {}), (lo, hi)


def test_paneled_match_overflow_consolidation(corpus):
    """When activation spill exceeds the overflow capacity the state drops
    and the next match rebuilds it (device re-sort) — matches stay exact
    across the consolidation."""
    eng = _paneled_forced(chunk_dim=64)
    eng._sort_o_cap = 64  # force consolidations (activation batches are
    #                       bucketed to >= 256-entry packed arrays)
    n0 = 150
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng.build(head, [str(i) for i in range(n0)])
    rebuilds = 0
    for s in range(n0, corpus.n_rows, 7):
        eng.insert(
            [(str(i), corpus.row(i))
             for i in range(s, min(s + 7, corpus.n_rows))],
            tau=0.5,
        )
        if eng._sort_state is None:
            rebuilds += 1
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def test_paneled_match_frozen_and_topk(corpus):
    """Frozen-index external matches route through the paneled path too;
    topk is unaffected (separate op)."""
    from oracle import brute_force_sims

    eng = _paneled_forced(chunk_dim=64)
    eng.build(corpus, [str(i) for i in range(corpus.n_rows)])
    eng.freeze()
    assert eng._paneled_ok()
    out = eng.insert([("q", corpus.row(3))], tau=0.5)
    # oracle: matches of row 3 at tau 0.5 (self included - external query)
    sims = brute_force_sims(corpus)
    want = {str(j) for j in np.flatnonzero(sims[3] >= 0.5)} | {"3"}
    assert set(out.output.get("q", {})) == want
    res = eng.topk([("t", corpus.row(1))], 3)
    got = np.array([s for _, s in res["t"]])
    np.testing.assert_allclose(
        got, np.sort(sims[1])[::-1][:3], atol=1e-9
    )


def test_paneled_prewarm_covers_crossing_variants(corpus):
    """The background prewarmer compiles the paneled path's three compile
    cliffs ahead of time: doubled sorted capacity (consolidation), doubled
    per-panel slice cap, and the next row_cap's panel count — plus the
    device re-sort at the new capacity (an unwarmed cap_s crossing freezes
    ingest mid-serve)."""
    eng = _paneled_forced(chunk_dim=64)
    eng._prewarm_min_rows = 0
    n0 = corpus.n_rows - 20
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng.build(head, [str(i) for i in range(n0)])
    eng.insert(
        [(str(i), corpus.row(i)) for i in range(n0, corpus.n_rows)],
        tau=0.5,
    )
    assert eng._sort_state is not None  # paneled path really ran
    cap_s = eng._sort_state["cap_s"]
    t = eng._prewarm_thread
    assert t is not None
    t.join(180)
    with eng._prewarm_lock:
        done = {k for _, k in eng._prewarm_done}
    kinds = {k[0] for k in done if isinstance(k[0], str)}
    assert "paneled" in kinds and "sortfp" in kinds
    # the sorted-capacity-doubled variant is among the compiled specs
    assert any(
        k[0] == "paneled" and k[8][0].shape == (2 * cap_s,) for k in done
    )
    assert any(k[0] == "sortfp" and k[3] == 2 * cap_s for k in done)
    assert eng.stats.get("prewarm_compiles", 0) >= 2
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def test_prewarm_retries_transient_lowering_failure(monkeypatch):
    """r5: a transient trace/lowering failure in the background prewarmer
    (jax 0.9.0 races the background ``.lower()`` against a foreground
    trace — KeyError: Var) leaves the
    spec QUEUED and retries instead of marking it done; a persistent
    failure gives up after 3 attempts.  A silent miss otherwise becomes a
    33 s cold compile stall mid-serve."""
    from apsim.engine import chunked as chunked_mod
    from apsim.ops import chunked as chunked_ops

    eng = ChunkedAllPairs(small_cfg(match_slab_budget_mb=0), chunk_dim=128)
    monkeypatch.setattr(chunked_mod.time, "sleep", lambda s: None)
    calls = {"n": 0}

    class _Compiled:
        def compile(self):
            return None

    class Flaky:
        def lower(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise KeyError("Var(id=1):int32[]")  # the observed race
            return _Compiled()

    monkeypatch.setattr(chunked_ops, "chunked_match_extract_bits", Flaky())
    key = (256, (1024, 128, 128), ())  # rebuild-path spec shape
    with eng._prewarm_lock:
        eng._prewarm_specs[key] = None
    eng._prewarm_worker(512, 128, "default")
    assert calls["n"] == 2  # failed once, retried, succeeded
    assert eng._prewarm_fail[key] == 1
    assert eng.stats.get("prewarm_compiles") == 1
    with eng._prewarm_lock:
        assert (512, key) in eng._prewarm_done

    # persistent failure: gives up after 3 attempts, marks done (no loop)
    class Dead:
        def lower(self, *a, **k):
            raise KeyError("Var(id=2):int32[]")

    monkeypatch.setattr(chunked_ops, "chunked_match_extract_bits", Dead())
    key2 = (512, (1024, 128, 128), ())
    with eng._prewarm_lock:
        eng._prewarm_specs[key2] = None
    eng._prewarm_worker(512, 128, "default")
    assert eng._prewarm_fail[key2] == 3
    with eng._prewarm_lock:
        assert (512, key2) in eng._prewarm_done
