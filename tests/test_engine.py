"""Engine correctness: exact pair-set parity against the fp64 brute-force
oracle (the test strategy the reference lacks — SURVEY.md §4), streaming/batch
equivalence, top-k, freeze, checkpointing."""

import numpy as np
import pytest

from apsim import AllPairsConfig, Engine
from apsim.vector.sparse import Vectors

from oracle import brute_force_pairs, brute_force_sims, random_sparse_corpus

DIM = 400


def small_cfg(**kw):
    base = dict(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64
    )
    base.update(kw)
    return AllPairsConfig(**base)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    base = random_sparse_corpus(rng, 177, DIM)
    # append exact duplicates of rows 0..2 so high taus have pairs
    vecs = [base.row(i) for i in range(base.n_rows)] + [
        base.row(0), base.row(1), base.row(2)
    ]
    from apsim.vector.batch import CSRMatrix

    return CSRMatrix.from_vectors(vecs, DIM).normalized()


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
@pytest.mark.parametrize("tau", [0.3, 0.5, 0.7, 0.9])
def test_all_pairs_matches_oracle(corpus, tau, int8):
    eng = Engine(small_cfg(pallas_int8=int8))
    eng.build(corpus)
    assert eng._int8_ok() == int8
    got = eng.all_pairs(tau).pair_set()
    want = brute_force_pairs(corpus, tau)
    assert got == want


def test_all_pairs_sims_exact(corpus):
    eng = Engine(small_cfg())
    eng.build(corpus)
    res = eng.all_pairs(0.5)
    sims = brute_force_sims(corpus)
    for i, j, s in zip(res.i, res.j, res.sims):
        assert s == pytest.approx(sims[int(i), int(j)], abs=1e-12)


def test_streaming_equals_batch(corpus):
    tau = 0.4
    eng = Engine(small_cfg())
    emitted = set()
    for s in range(0, corpus.n_rows, 23):
        e = min(s + 23, corpus.n_rows)
        out = eng.insert(
            [(str(i), corpus.row(i)) for i in range(s, e)], tau=tau
        )
        for q, sims in out.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    want = brute_force_pairs(corpus, tau)
    assert emitted == want
    # intra-batch symmetry: a batch with a duplicate pair reports both ways
    eng2 = Engine(small_cfg())
    v = Vectors.sparse(DIM, [3, 9], [0.6, 0.8])
    out = eng2.insert([("a", v), ("b", v)], tau=0.9)
    assert out.output["a"]["b"] == pytest.approx(1.0)
    assert out.output["b"]["a"] == pytest.approx(1.0)


def test_streaming_grows_capacity():
    # force row and dim growth across inserts, including brand-new dims
    cfg = small_cfg(row_bucket=64, dim_bucket=64)
    eng = Engine(cfg)
    rng = np.random.default_rng(3)
    seen = set()
    for step in range(4):
        vecs = []
        for i in range(40):
            dims = np.sort(
                rng.choice(np.arange(step * 90, step * 90 + 90), 5, replace=False)
            ).astype(np.int32)
            vals = rng.random(5) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append((f"{step}:{i}", Vectors.sparse(DIM, dims, vals)))
        out = eng.insert(vecs, tau=0.95)
        for q, sims in out.output.items():
            for c in sims:
                seen.add((q, c) if q <= c else (c, q))
    assert eng.n_rows == 160
    # exact parity on the final state
    got = eng.all_pairs(0.95).pair_set()
    want = brute_force_pairs(eng.shadow_csr(), 0.95, eng.ids)
    assert got == want


def test_index_threshold_filter():
    # streaming path drops components <= indexThreshold (fine-print #5)
    cfg = small_cfg(index_threshold=0.5)
    eng = Engine(cfg)
    v = Vectors.sparse(DIM, [1, 2], [0.4, 0.9])
    eng.insert([("a", v)], tau=0.1)
    row = eng.shadow_csr().row(0)
    np.testing.assert_array_equal(row.indices, [2])
    # bulk build path does NOT filter (HBase path parity)
    eng2 = Engine(cfg)
    eng2.build([("a", v)])
    assert eng2.shadow_csr().row(0).nnz == 2


def _engine_flavors():
    """All four engine flavors under one factory signature (cfg) -> engine.
    Admission semantics must be IDENTICAL across them: the same config
    admits the same corpus everywhere (VERDICT r2 gap #1)."""
    from apsim.engine.chunked import ChunkedAllPairs
    from apsim.parallel import MeshEngine, make_mesh
    from apsim.parallel.chunked_mesh import MeshChunkedAllPairs

    return [
        pytest.param(lambda cfg: Engine(cfg), id="dense"),
        pytest.param(
            lambda cfg: MeshEngine(
                cfg.replace(shard_axis="dims"), mesh=make_mesh(2)
            ),
            id="mesh",
        ),
        pytest.param(
            lambda cfg: ChunkedAllPairs(cfg, chunk_dim=64), id="chunked"
        ),
        pytest.param(
            lambda cfg: MeshChunkedAllPairs(
                cfg, mesh=make_mesh(2), chunk_dim=64
            ),
            id="chunked-mesh",
        ),
    ]


@pytest.mark.parametrize("make", _engine_flavors())
def test_admission_pruning_ones(make):
    # the reference's all-1.0 stub: sum(values) >= tau admits
    # (EntryProxyActor.scala:51-57,81-93)
    eng = make(small_cfg(admission="ones"))
    weak = Vectors.sparse(DIM, [0], [0.3])
    strong = Vectors.sparse(DIM, [0], [0.9])
    eng.insert([("w", weak), ("s", strong)], tau=0.5)
    assert eng.n_rows == 1 and eng.ids == ["s"]
    assert eng.stats["vectors_dropped_admission"] == 1


@pytest.mark.parametrize("make", _engine_flavors())
def test_admission_real_running(corpus, make):
    # normalized corpus: the self-inclusive running bound admits everything
    # (ub >= ||v||^2 = 1 >= tau), so nothing is lost
    tau = 0.6
    eng = make(small_cfg(admission="real"))
    for s in range(0, corpus.n_rows, 31):
        e = min(s + 31, corpus.n_rows)
        eng.insert([(str(i), corpus.row(i)) for i in range(s, e)], tau=tau)
    assert eng.n_rows == corpus.n_rows
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


@pytest.mark.parametrize("make", _engine_flavors())
def test_admission_real_static_map(corpus, make):
    # precomputed corpus maxima: pruning is exactly lossless AND actually
    # prunes sub-threshold vectors
    tau = 0.6
    eng = make(small_cfg(admission="real"))
    eng.set_max_weight_map(corpus.max_weights())
    weak = Vectors.sparse(DIM, [0, 1], [1e-4, 1e-4])  # cannot reach tau
    for s in range(0, corpus.n_rows, 31):
        e = min(s + 31, corpus.n_rows)
        eng.insert([(str(i), corpus.row(i)) for i in range(s, e)], tau=tau)
    eng.insert([("weak", weak)], tau=tau)
    assert "weak" not in eng.ids  # pruned by the corpus bound
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    assert eng.stats["vectors_dropped_admission"] == 1


def test_insert_device_failure_rolls_back(corpus, monkeypatch):
    """A device failure mid-insert must not leave phantom rows: host
    bookkeeping rolls back to the pre-batch state, the device index is
    rebuilt from the shadow, and the engine keeps serving exactly."""
    import apsim.ops.score as score_ops_mod

    tau = 0.4
    eng = Engine(small_cfg())
    eng.insert([(str(i), corpus.row(i)) for i in range(50)], tau=tau)
    real = score_ops_mod.insert_match_fused

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(score_ops_mod, "insert_match_fused", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.insert(
            [(f"x{i}", corpus.row(i)) for i in range(50, 60)], tau=tau
        )
    monkeypatch.setattr(score_ops_mod, "insert_match_fused", real)
    assert eng.n_rows == 50 and len(eng.ids) == 50
    assert "x0" not in eng.id_to_row
    # still exact after rollback, and a retried insert works
    from apsim.vector.batch import CSRMatrix

    head = CSRMatrix(
        50, corpus.n_cols, corpus.indptr[:51],
        corpus.indices[: int(corpus.indptr[50])],
        corpus.data[: int(corpus.indptr[50])],
    )
    assert eng.all_pairs(tau).pair_set() == brute_force_pairs(head, tau)
    eng.insert([(f"x{i}", corpus.row(i)) for i in range(50, 60)], tau=tau)
    assert eng.n_rows == 60


def test_small_extract_cap_streaming(corpus):
    # regression: extract_cap smaller than the packed head must not crash
    # the streaming/fused path
    eng = Engine(small_cfg(extract_cap=8))
    out = eng.insert(
        [(str(i), corpus.row(i)) for i in range(40)], tau=0.3
    )
    assert eng.n_rows == 40
    emitted = set()
    for q, sims in out.output.items():
        for c in sims:
            emitted.add((q, c) if q <= c else (c, q))
    from apsim.vector.batch import CSRMatrix

    sub = CSRMatrix(
        40, corpus.n_cols, corpus.indptr[:41],
        corpus.indices[: int(corpus.indptr[40])],
        corpus.data[: int(corpus.indptr[40])],
    )
    assert emitted == brute_force_pairs(sub, 0.3)


def test_topk(corpus):
    eng = Engine(small_cfg())
    eng.build(corpus)
    queries = [(f"q{i}", corpus.row(i)) for i in range(4)]
    res = eng.topk(queries, 5)
    sims = brute_force_sims(corpus)
    for qi in range(4):
        got_ids = [int(r) for r, _ in res[f"q{qi}"]]
        # top-1 must be the row itself (sim 1.0 duplicate of the query)
        assert sims[qi, got_ids[0]] == pytest.approx(
            np.max(sims[qi]), abs=1e-5
        )
        got_scores = np.array([s for _, s in res[f"q{qi}"]])
        want_scores = np.sort(sims[qi])[::-1][:5]
        np.testing.assert_allclose(got_scores, want_scores, atol=1e-5)


def test_topk_query_with_unseen_dims(corpus):
    eng = Engine(small_cfg())
    eng.build(corpus)
    # query whose dims were never indexed scores 0 everywhere
    q = Vectors.sparse(DIM, [DIM - 1], [1.0])
    if eng.compact.cols_of(np.array([DIM - 1]))[0] < 0:
        res = eng.topk([("q", q)], 3)
        assert all(s == pytest.approx(0.0) for _, s in res["q"])


def test_freeze_semantics(corpus):
    tau = 0.4
    eng = Engine(small_cfg())
    eng.build(corpus)
    eng.freeze()
    out = eng.insert([("new", corpus.row(0))], tau=tau)
    # query served (row 0 is a perfect match) but nothing indexed
    assert "0" in out.output["new"]
    assert eng.n_rows == corpus.n_rows
    eng.unfreeze()
    eng.insert([("new", corpus.row(0))], tau=tau)
    assert eng.n_rows == corpus.n_rows + 1


def test_checkpoint_roundtrip(tmp_path, corpus):
    eng = Engine(small_cfg())
    eng.build(corpus)
    want = eng.all_pairs(0.5).pair_set()
    eng.save(str(tmp_path / "ckpt"))
    eng2 = Engine.load(str(tmp_path / "ckpt"), config=small_cfg())
    assert eng2.ids == eng.ids
    assert eng2.all_pairs(0.5).pair_set() == want


def test_empty_engine():
    eng = Engine(small_cfg())
    assert eng.all_pairs(0.5).n_pairs == 0
    assert eng.topk([], 3) == {}


def test_pallas_all_pairs_matches_oracle(corpus):
    # int8 join over several row panels: diagonal AND off-diagonal panel
    # pairs, one compaction over all of them
    cfg = small_cfg(row_bucket=256, query_tile=256, dim_bucket=2048)
    eng = Engine(cfg)
    eng._int8_panel_rows = 64
    eng.build(corpus)
    assert eng._int8_ok() and eng.row_cap // 64 >= 3
    got = eng.all_pairs(0.5).pair_set()
    assert eng._used_int8
    assert got == brute_force_pairs(corpus, 0.5)


def test_extract_cap_overflow_retry(corpus):
    # a tiny device pair buffer must auto-grow, not lose pairs
    eng = Engine(small_cfg(extract_cap=8))
    eng.build(corpus)
    got = eng.all_pairs(0.3).pair_set()
    assert got == brute_force_pairs(corpus, 0.3)
    assert len(got) > 8


def test_bfloat16_mode_superset_margin(corpus):
    # bf16 storage still yields the exact pair set thanks to the widened
    # margin + fp64 rescore
    eng = Engine(small_cfg(dtype="bfloat16"))
    eng.build(corpus)
    got = eng.all_pairs(0.5).pair_set()
    assert got == brute_force_pairs(corpus, 0.5)


def test_checkpoint_self_contained_npz(tmp_path, corpus):
    # the atomic save embeds meta in index.npz; restore must not need
    # meta.json (torn-write recovery: npz swapped, meta.json stale/absent)
    import os

    eng = Engine(small_cfg())
    eng.build(corpus)
    path = str(tmp_path / "ckpt")
    eng.save(path)
    os.remove(os.path.join(path, "meta.json"))
    csr, ids, mw, cfg = Engine.read_checkpoint(path)
    assert csr.n_rows == corpus.n_rows
    assert len(ids) == corpus.n_rows
    assert cfg["vector_dim"] == DIM
    # and read_checkpoint is a plain staticmethod (callable off the class
    # AND an instance on every Python >= 3.10)
    assert Engine(small_cfg()).read_checkpoint(path)[0].n_rows == corpus.n_rows


def test_unaligned_row_bucket(corpus):
    # row_bucket not a multiple of query_tile: the capacity quantum must
    # round up so the last tile is never scored at a clamped/wrong offset
    eng = Engine(small_cfg(row_bucket=96, query_tile=64))
    eng.build(corpus)
    assert eng.row_cap % 64 == 0
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def _near_tie_corpus(n=200, base=0.9):
    # n vectors whose similarity to e0 differs only at the 1e-13 level:
    # indistinguishable in fp32 (resolution ~5e-8 near 0.9) but strictly
    # ordered in fp64, with the TRUE best at the LAST row index — the old
    # heuristic 4k+64 over-fetch picked fp32-tied candidates by lowest row
    # index and missed it
    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import SparseVector

    vecs = []
    for i in range(n):
        s = base + i * 1e-13
        vecs.append(
            SparseVector(
                DIM,
                np.array([0, 1 + i], np.int32),
                np.array([s, np.sqrt(1.0 - s * s)]),
            )
        )
    q = SparseVector(DIM, np.array([0], np.int32), np.array([1.0]))
    return CSRMatrix.from_vectors(vecs, DIM), q


def test_topk_exact_under_near_ties():
    corpus, q = _near_tie_corpus()
    eng = Engine(small_cfg())
    eng.build(corpus)
    got = eng.topk([("q", q)], 3)["q"]
    # provably-exact fetch must surface the true fp64 ranking: rows n-1,
    # n-2, n-3 in that order
    n = corpus.n_rows
    assert [g[0] for g in got] == [str(n - 1), str(n - 2), str(n - 3)], got
    assert got[0][1] == pytest.approx(0.9 + (n - 1) * 1e-13, abs=1e-15)


def test_topk_exact_under_near_ties_chunked():
    from apsim.engine.chunked import ChunkedAllPairs

    corpus, q = _near_tie_corpus()
    eng = ChunkedAllPairs(small_cfg(), chunk_dim=128)
    eng.build(corpus)
    got = eng.topk([("q", q)], 3)["q"]
    n = corpus.n_rows
    assert [g[0] for g in got] == [str(n - 1), str(n - 2), str(n - 3)], got


def _dormant_corpus():
    # rows 0,1 share dim 5; row 2 has UNIQUE dims {100, 101} (df==1 ->
    # dormant: kept off the device, archived host-side)
    from apsim.vector.batch import CSRMatrix

    v = Vectors.sparse
    a = 1 / np.sqrt(2)
    vecs = [
        v(DIM, [5, 7], [a, a]),
        v(DIM, [5, 8], [a, a]),
        v(DIM, [100, 101], [a, a]),
    ]
    return CSRMatrix.from_vectors(vecs, DIM)


def test_dormant_dims_archived_and_exact():
    corpus = _dormant_corpus()
    eng = Engine(small_cfg())
    eng.build(corpus)
    assert eng.stats["dormant_dims"] >= 2  # dims 100,101 (7,8 too)
    # device index lost nothing decidable: pair set still exact
    assert eng.all_pairs(0.3).pair_set() == brute_force_pairs(corpus, 0.3)


def test_dormant_activation_on_insert():
    corpus = _dormant_corpus()
    eng = Engine(small_cfg())
    eng.build(corpus)
    a = 1 / np.sqrt(2)
    # new vector shares dormant dim 100 with row 2: the archived entry must
    # activate or the (new, 2) pair is lost
    out = eng.insert([("new", Vectors.sparse(DIM, [100, 300], [a, a]))],
                     tau=0.4)
    assert out.output.get("new", {}).get("2") == pytest.approx(0.5)
    assert eng.all_pairs(0.4).pair_set() == brute_force_pairs(
        eng.shadow_csr(), 0.4, eng.ids
    )


def test_dormant_topk_and_frozen_match():
    corpus = _dormant_corpus()
    eng = Engine(small_cfg())
    eng.build(corpus)
    a = 1 / np.sqrt(2)
    q = Vectors.sparse(DIM, [100, 101], [a, a])  # only dormant dims
    # top-k must surface row 2 at sim 1.0 even though the device sees zeros
    res = eng.topk([("q", q)], 2)["q"]
    assert res[0] == ("2", pytest.approx(1.0))
    # frozen external match must find it too
    eng.freeze()
    out = eng.insert([("probe", q)], tau=0.9)
    assert out.output.get("probe", {}).get("2") == pytest.approx(1.0)


def test_pallas_int8_matches_oracle(corpus):
    # int8 join (default): the per-pair quantization bound must keep the
    # pair set exact
    eng = Engine(small_cfg(pallas_int8=True,
                           query_tile=256, row_bucket=256, dim_bucket=2048))
    eng.build(corpus)
    assert eng._int8_ok()
    assert eng.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
    assert eng._used_int8


def test_streaming_singleton_dims_archived_then_promoted():
    # a brand-new dim seen once stays OFF the device; when a later insert
    # shares it, both entries must pair exactly (archive -> promote path)
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    eng = Engine(small_cfg())
    eng.build(
        CSRMatrix_from([v(DIM, [5, 7], [a, a]), v(DIM, [5, 8], [a, a])])
    )
    n_active0 = eng.compact.n_active
    out = eng.insert([("s1", v(DIM, [200, 201], [a, a]))], tau=0.4)
    assert out.output.get("s1", {}) == {}
    # both fresh dims were singletons: archived, no compact growth
    assert eng.compact.n_active == n_active0
    assert eng.stats["dormant_dims"] >= 2
    out = eng.insert([("s2", v(DIM, [200, 300], [a, a]))], tau=0.4)
    # dim 200 promoted: the archived s1 entry must activate and pair
    assert out.output.get("s2", {}).get("s1") == pytest.approx(0.5)
    assert eng.all_pairs(0.4).pair_set() == brute_force_pairs(
        eng.shadow_csr(), 0.4, eng.ids
    )
    # dims appearing twice WITHIN one batch are promoted immediately
    out = eng.insert(
        [("t1", v(DIM, [250, 251], [a, a])), ("t2", v(DIM, [250, 252], [a, a]))],
        tau=0.4,
    )
    got = {
        (q, c) for q, sims in out.output.items() for c in sims
    }
    assert ("t1", "t2") in got and ("t2", "t1") in got


def CSRMatrix_from(vecs):
    from apsim.vector.batch import CSRMatrix

    return CSRMatrix.from_vectors(vecs, DIM)


def test_compact_bits_prelevel_matches_oracle(corpus):
    """512-row panels activate the SUPER2 pre-level in _compact_bits (the
    g512 reduce + 8x smaller nonzero); pair set must stay exact."""
    import jax.numpy as jnp

    from apsim.ops import bits, panel

    eng = Engine(small_cfg(query_tile=512, row_bucket=512, dim_bucket=2048))
    eng.build(corpus)
    assert eng.row_cap % 512 == 0
    assert (512 // bits.SUPER) % (bits.SUPER2 // bits.SUPER) == 0
    q8, aux = panel.quantize_rows(eng.x)
    rb = 512
    pi, pj = panel.upper_panel_pairs(eng.row_cap // rb)
    (rows, cols), packed = panel.allpairs_extract_int8(
        q8, aux, jnp.asarray(pi), jnp.asarray(pj), np.float32(0.45), rb,
        65536, 8192, 8192,
    )
    _, _, total, _, _ = bits.unpack_head(np.asarray(packed))
    got = set(
        zip(np.asarray(rows)[:total].tolist(),
            np.asarray(cols)[:total].tolist())
    )
    # candidates must be a superset of the true pair set at tau=0.5
    # (int8 bound admits at tau_eff=0.45), and every true pair present
    want = brute_force_pairs(corpus, 0.5)
    want_idx = {tuple(sorted((int(a), int(b)))) for a, b in want}
    assert want_idx <= got


def test_pallas_int8_excludes_padded_rows(corpus):
    # regression: padded (all-zero) rows must have a ZERO error bound —
    # with the old alpha=1 fallback every padded x real pair leaked through
    # the epilogue (5.4M bogus candidates on Enron; out-of-range row ids
    # then crashed the native rescore)
    import jax.numpy as jnp

    from apsim.ops import bits, panel

    eng = Engine(small_cfg(pallas_int8=True,
                           query_tile=256, row_bucket=256, dim_bucket=2048))
    eng.build(corpus)
    assert eng.row_cap > corpus.n_rows  # padding actually present
    q8, aux = panel.quantize_rows(eng.x)
    rb = 128
    pi, pj = panel.upper_panel_pairs(eng.row_cap // rb)
    (rows, cols), packed = panel.allpairs_extract_int8(
        q8, aux, jnp.asarray(pi), jnp.asarray(pj), eng._tau_eff(0.5), rb,
        65536, 8192, 8192,
    )
    _, _, total, _, _ = bits.unpack_head(np.asarray(packed))
    r = np.asarray(rows)[:total]
    c = np.asarray(cols)[:total]
    assert total < corpus.n_rows ** 2
    assert r.max() < corpus.n_rows and c.max() < corpus.n_rows


def test_insert_device_failure_rolls_back_dormant_archive(monkeypatch):
    """The rollback must also undo the batch's dormant-archive appends:
    a stale entry references a rolled-back row, so a later query sharing
    its dim would emit an out-of-range candidate (and a later activation
    would scatter into a row owned by a different re-inserted vector)."""
    import apsim.ops.score as score_ops_mod

    corpus = _dormant_corpus()
    eng = Engine(small_cfg())
    eng.build(corpus)
    arch0 = eng._dorm_rows.size
    a = 1 / np.sqrt(2)
    fresh = Vectors.sparse(DIM, [5, 399], [a, a])  # dim 399: new singleton

    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    real = score_ops_mod.insert_match_fused
    monkeypatch.setattr(score_ops_mod, "insert_match_fused", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.insert([("gone", fresh)], tau=0.4)
    monkeypatch.setattr(score_ops_mod, "insert_match_fused", real)
    assert eng.n_rows == corpus.n_rows
    assert eng._dorm_rows.size == arch0, "archive entries not rolled back"
    assert eng._dormant_of_ext[399] == -1, "ext map not rolled back"
    # a different vector re-inserted on the recycled row: queries through
    # dim 399 must not see the rolled-back row's archived value
    eng.insert([("kept", Vectors.sparse(DIM, [5, 7], [a, a]))], tau=0.4)
    got = eng.topk([("q", fresh)], 3)["q"]
    assert all(cid in eng.id_to_row for cid, _ in got)
    assert eng.all_pairs(0.3).pair_set() == brute_force_pairs(
        eng.shadow_csr(), 0.3, eng.ids
    )


def test_rollback_commits_promoted_dormant_marks(monkeypatch):
    """A failed insert that PROMOTED an archived dim must not leave its
    archive mark set: the rollback rebuild already scattered the archived
    entry onto the device, so a later activation would add it a second
    time — inflating that row's device score beyond the margin and
    breaking topk's exact-fetch proof."""
    import apsim.ops.score as score_ops_mod

    corpus = _dormant_corpus()  # row 2 has archived dims {100, 101}
    eng = Engine(small_cfg())
    eng.build(corpus)
    assert eng._dormant_of_ext[100] >= 0
    a = 1 / np.sqrt(2)
    sharer = Vectors.sparse(DIM, [100, 300], [a, a])  # promotes dim 100

    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    real = score_ops_mod.insert_match_fused
    monkeypatch.setattr(score_ops_mod, "insert_match_fused", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.insert([("gone", sharer)], tau=0.4)
    monkeypatch.setattr(score_ops_mod, "insert_match_fused", real)
    # dim 100 is mapped (promotion not rolled back) and its entry landed on
    # the device via the rollback rebuild -> its mark must be committed
    assert eng.compact.cols_of(np.array([100]))[0] >= 0
    assert eng._dormant_of_ext[100] == -1, "stale archive mark"
    # a successful re-insert sharing dim 100 must see row 2's TRUE score
    out = eng.insert([("new", sharer)], tau=0.4)
    assert out.output.get("new", {}).get("2") == pytest.approx(0.5)
    got = dict(eng.topk([("q", sharer)], 2)["q"])
    # top-2 = the identical "new" (1.0) and row 2 at its TRUE 0.5 — a
    # double-added archive entry would inflate row 2's device score
    assert got["new"] == pytest.approx(1.0)
    assert got["2"] == pytest.approx(0.5)
    assert eng.all_pairs(0.4).pair_set() == brute_force_pairs(
        eng.shadow_csr(), 0.4, eng.ids
    )


def test_insert_cap_adapts(corpus):
    """r5: the streaming-insert extraction cap adapts to observed candidate
    counts (the join's 8x-hysteresis rule) instead of paying the generous
    config default's compaction/buffer tax on every micro-batch; an
    overflow-retry's grown cap persists."""
    eng = Engine(AllPairsConfig())
    assert eng._insert_cap is None
    default = int(eng.cfg.extract_cap)
    eng._note_insert_cap(100, default)          # gross oversize: tighten
    assert eng._insert_cap == 1024
    eng._note_insert_cap(100, 4096)             # retry grew it: persist
    assert eng._insert_cap == 4096
    eng._note_insert_cap(3000, 4096)            # within 8x: unchanged
    assert eng._insert_cap == 4096
    # end to end: streaming a real corpus tightens below the default and
    # stays exact (the streaming==batch contract at tightened caps)
    eng2 = Engine(AllPairsConfig())
    n0 = corpus.n_rows // 2
    head = type(corpus)(
        n0, corpus.n_cols, corpus.indptr[: n0 + 1],
        corpus.indices[: corpus.indptr[n0]],
        corpus.data[: corpus.indptr[n0]],
    )
    eng2.build(head, [str(i) for i in range(n0)])
    for s in range(n0, corpus.n_rows, 32):
        eng2.insert(
            [(str(i), corpus.row(i))
             for i in range(s, min(s + 32, corpus.n_rows))],
            tau=0.5,
        )
    assert eng2._insert_cap is not None and eng2._insert_cap < default
    assert eng2.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
