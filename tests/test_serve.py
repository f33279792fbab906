"""Service-layer tests: async ingest queue, LoadData path, TCP RPC,
output subscription (reference: server actors + ClientConnection)."""

import time

import numpy as np
import pytest

from apsim import AllPairsConfig, Engine
from apsim.etl.store import VectorStore
from apsim.serve import ClientConnection, RpcServer, SimilarityServer

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 300


@pytest.fixture
def corpus():
    rng = np.random.default_rng(21)
    return random_sparse_corpus(rng, 100, DIM)


def make_cfg(**kw):
    base = dict(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.5, io_trigger_period_ms=5,
    )
    base.update(kw)
    return AllPairsConfig(**base)


def wait_until(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_server_async_ingest(corpus):
    cfg = make_cfg()
    with SimilarityServer(Engine(cfg), cfg) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        for i in range(corpus.n_rows):
            srv.insert_new_vectors([(str(i), corpus.row(i))])
        assert wait_until(lambda: srv.stats()["n_rows"] == corpus.n_rows)
    emitted = set()
    for o in outputs:
        for q, sims in o.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == brute_force_pairs(corpus, 0.5)


def test_server_bulk_load_skips_admission(tmp_path, corpus):
    # bulk path must not admission-prune (HBase path parity)
    store = VectorStore(str(tmp_path))
    weak = corpus.normalized()
    weak.data[:] *= 0.01  # sums far below tau -> "ones" admission would drop
    store.write("T", weak)
    cfg = make_cfg(admission="ones")
    with SimilarityServer(Engine(cfg), cfg, store=store) as srv:
        srv.load_data("T", 0, weak.n_rows - 1)
        assert wait_until(lambda: srv.stats()["n_rows"] == weak.n_rows)
        assert srv.stats()["vectors_dropped_admission"] == 0


def test_disconnected_subscriber_is_unregistered(corpus):
    """A subscriber that disconnects must be dropped from the sink list on
    the next output push — socketserver closes its wfile after handle()
    returns, which raises ValueError (not OSError) on write; the push hook
    converts both to BrokenPipeError so _fanout unregisters the sink."""
    cfg = make_cfg()
    sim = SimilarityServer(Engine(cfg), cfg)
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: None)
        assert wait_until(lambda: len(sim._sinks) == 1)
        sub.close()  # subscriber gone; its sink is still registered
        cc = ClientConnection([addr])
        # duplicate pairs guarantee output events -> push -> dead sink
        # (the first write to a freshly-closed peer can land in the TCP
        # buffer before the RST arrives, so allow a couple of pushes)
        for k in range(5):
            cc.insert_new_vector(
                [(f"a{k}", corpus.row(0)), (f"b{k}", corpus.row(0))]
            )
            cc.flush()
            if wait_until(lambda: len(sim._sinks) == 0, timeout=2):
                break
        assert len(sim._sinks) == 0
        cc.close()


def test_rpc_roundtrip(tmp_path, corpus):
    store = VectorStore(str(tmp_path))
    store.write("SMALL_DATA", corpus, ids=[f"v{i}" for i in range(corpus.n_rows)])
    cfg = make_cfg()
    sim = SimilarityServer(Engine(cfg), cfg, store=store)
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        outputs = []
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: outputs.append(o))
        cc = ClientConnection([addr])
        # Test ping (Message.scala:37 parity)
        assert cc.test("x")["test"] == "x"
        # bulk load half, stream the rest
        cc.load_data("SMALL_DATA", 0, 49)
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == 50)
        for i in range(50, corpus.n_rows):
            cc.insert_new_vector([(f"v{i}", corpus.row(i))])
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == corpus.n_rows)
        # full join over RPC matches the oracle
        pairs = cc.all_pairs(0.5)
        got = {tuple(sorted((a, b))) for a, b, _ in pairs}
        want = brute_force_pairs(
            corpus, 0.5, ids=[f"v{i}" for i in range(corpus.n_rows)]
        )
        assert got == want
        # outputs were pushed to the subscriber
        assert wait_until(lambda: len(outputs) > 0)
        # topk over RPC
        tk = cc.topk([("q", corpus.row(3))], 2)
        assert tk["q"][0][0] == "v3"
        # freeze over RPC
        cc.freeze()
        assert cc.stats()["frozen"]
        # malformed op gets an error, connection survives
        import json

        cc._send({"op": "nope"})
        rsp = json.loads(cc._rfile.readline())
        assert not rsp["ok"]
        assert cc.test("still-alive")["test"] == "still-alive"
        cc.close()
        sub.close()


def test_server_checkpoint_restore(tmp_path, corpus):
    # crash-recovery story: server auto-checkpoints, a new server restores
    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt, checkpoint_interval_s=0.0)
    with SimilarityServer(None, cfg) as srv:
        srv.insert_new_vectors(
            [(str(i), corpus.row(i)) for i in range(40)]
        )
        assert wait_until(lambda: srv.stats()["n_rows"] == 40)
    # close() force-checkpoints; a fresh server restores the index
    with SimilarityServer(None, cfg) as srv2:
        assert srv2.stats()["n_rows"] == 40
        res = srv2.all_pairs(0.5)
        want = brute_force_pairs(
            CSRSlice(corpus, 40), 0.5, [str(i) for i in range(40)]
        )
        assert res.pair_set() == want


def test_mesh_server_checkpoint_restore(tmp_path, corpus):
    # regression: a caller-provided (mesh) engine must also restore
    from apsim.parallel import MeshEngine, make_mesh

    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt)
    with SimilarityServer(None, cfg) as srv:
        srv.insert_new_vectors([(str(i), corpus.row(i)) for i in range(30)])
        assert wait_until(lambda: srv.stats()["n_rows"] == 30)
    mesh_engine = MeshEngine(cfg, mesh=make_mesh(8))
    with SimilarityServer(mesh_engine, cfg) as srv2:
        assert srv2.stats()["n_rows"] == 30
        assert srv2.engine.x.sharding.num_devices == 8


def CSRSlice(csr, n):
    from apsim.vector.batch import CSRMatrix

    return CSRMatrix(
        n, csr.n_cols, csr.indptr[: n + 1],
        csr.indices[: int(csr.indptr[n])], csr.data[: int(csr.indptr[n])],
    )


def test_chunked_server_async_ingest(corpus):
    # out-of-core engine behind the same server: streaming ingest + stats
    from apsim.engine import ChunkedAllPairs

    cfg = make_cfg()
    with SimilarityServer(ChunkedAllPairs(cfg, chunk_dim=64), cfg) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        for s in range(0, corpus.n_rows, 10):
            srv.insert_new_vectors(
                [(str(i), corpus.row(i))
                 for i in range(s, min(s + 10, corpus.n_rows))]
            )
        assert wait_until(lambda: srv.stats()["n_rows"] == corpus.n_rows)
        st = srv.stats()
        assert st["vectors_indexed"] == corpus.n_rows
        assert "insert" in st["timings"]
    emitted = set()
    for o in outputs:
        for q, sims in o.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert emitted == brute_force_pairs(corpus, 0.5)


def test_chunked_server_checkpoint_cross_flavor(tmp_path, corpus):
    # checkpoints are interchangeable across engine flavors: chunked server
    # writes, dense AND mesh-chunked engines restore the same index
    from apsim.engine import ChunkedAllPairs
    from apsim.parallel import MeshChunkedAllPairs, make_mesh

    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt, checkpoint_interval_s=0.0)
    with SimilarityServer(ChunkedAllPairs(cfg, chunk_dim=64), cfg) as srv:
        srv.insert_new_vectors([(str(i), corpus.row(i)) for i in range(40)])
        assert wait_until(lambda: srv.stats()["n_rows"] == 40)
    want = brute_force_pairs(
        CSRSlice(corpus, 40), 0.5, [str(i) for i in range(40)]
    )
    dense = Engine.load(ckpt, config=cfg)
    assert dense.all_pairs(0.5).pair_set() == want
    mce = MeshChunkedAllPairs(cfg, mesh=make_mesh(8), chunk_dim=32)
    with SimilarityServer(mce, cfg) as srv2:
        assert srv2.stats()["n_rows"] == 40
        assert srv2.all_pairs(0.5).pair_set() == want


def test_profiling_utils(tmp_path):
    from apsim.utils.logging import Timer, get_logger

    log = get_logger("apsim.test")
    log.info("structured %s", "record")
    t = Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    assert t.counts["a"] == 2 and t.totals["a"] >= 0


def test_concurrent_clients(corpus):
    # 4 clients insert disjoint slices simultaneously; no pair may be lost
    # and the final index must hold every vector exactly once
    import threading

    cfg = make_cfg(output_io_duration_ms=20)  # exercise coalesced emission
    sim = SimilarityServer(Engine(cfg), cfg)
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        outputs = []
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: outputs.append(o))

        def worker(lo, hi):
            cc = ClientConnection([addr])
            for i in range(lo, hi):
                cc.insert_new_vector([(str(i), corpus.row(i))])
            cc.flush()
            cc.close()

        n = corpus.n_rows
        bounds = [(k * n // 4, (k + 1) * n // 4) for k in range(4)]
        threads = [threading.Thread(target=worker, args=b) for b in bounds]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert wait_until(lambda: sim.stats()["n_rows"] == n, timeout=20)
        # exact join over the concurrently-built index
        res = sim.all_pairs(0.5)
        assert res.pair_set() == brute_force_pairs(
            corpus, 0.5, ids=[str(i) for i in range(n)]
        )
        assert sorted(sim.engine.ids, key=int) == [str(i) for i in range(n)]
        sub.close()


def test_interactive_client(tmp_path, corpus):
    import io

    from apsim.serve import InteractiveClient

    store = VectorStore(str(tmp_path))
    store.write("T", corpus)
    cfg = make_cfg()
    sim = SimilarityServer(Engine(cfg), cfg, store=store)
    with RpcServer(sim, port=0) as rpc:
        cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
        out = io.StringIO()
        term = InteractiveClient(cc, out=out)
        term.run(input_lines=["start", "T", "0", "9", "test", "ping", "quit"])
        assert "test reply" in out.getvalue()
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == 10)
        cc.close()


def test_flusher_survives_poisoned_batch(corpus):
    # a batch that raises inside the engine must be dropped (logged +
    # counted), NOT kill the flusher thread — IndexingWorkerActor.scala's
    # deliberate keep-alive try/catch (:124-137)
    cfg = make_cfg()
    with SimilarityServer(Engine(cfg), cfg) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        srv.insert_new_vectors([("a", corpus.row(0))])
        assert wait_until(lambda: srv.stats()["n_rows"] == 1)
        # poison: bypass the ingest-boundary validation and enqueue a
        # wrong-dimensionality vector directly (simulates any engine fault)
        from apsim.vector.sparse import SparseVector

        bad = SparseVector(DIM * 4, np.array([DIM * 2], np.int32), [1.0])
        srv._queue.put((False, [("bad", bad)]))
        assert wait_until(lambda: srv.stats()["errors"] >= 1)
        # later inserts still flow through the same flusher thread
        srv.insert_new_vectors([("b", corpus.row(1))])
        assert wait_until(lambda: srv.stats()["n_rows"] == 2)
        assert srv._flusher.is_alive()


def test_insert_validates_dimensionality(corpus):
    cfg = make_cfg()
    from apsim.vector.sparse import SparseVector

    with SimilarityServer(Engine(cfg), cfg) as srv:
        bad = SparseVector(DIM * 4, np.array([DIM * 2], np.int32), [1.0])
        with pytest.raises(ValueError, match="vector_dim"):
            srv.insert_new_vectors([("bad", bad)])
        assert srv.stats()["n_rows"] == 0


def test_rpc_bad_insert_never_desyncs(corpus):
    # an invalid fire-and-forget insert must produce NO reply line: the next
    # request/response call must still read ITS OWN reply
    cfg = make_cfg()
    with RpcServer(SimilarityServer(Engine(cfg), cfg)) as rpc:
        conn = ClientConnection([f"127.0.0.1:{rpc.port}"], timeout=10.0)
        # oversized vector (size != vector_dim) -> rejected server-side
        conn._send(
            {"op": "insert", "vectors": [["bad", DIM * 4, [DIM * 2], [1.0]]]}
        )
        # malformed payload shape -> rejected server-side
        conn._send({"op": "insert", "vectors": [["oops"]]})
        rsp = conn.test("ping")
        assert rsp == {"ok": True, "test": "ping"}
        conn.insert_new_vector([("ok", corpus.row(0))])
        conn.flush()
        stats = conn.stats()
        assert stats["n_rows"] == 1
        assert stats["errors"] >= 2
        conn.close()


def test_stats_expose_stage_timings(corpus):
    cfg = make_cfg()
    with SimilarityServer(Engine(cfg), cfg) as srv:
        srv.insert_new_vectors([("a", corpus.row(0))])
        srv.all_pairs(0.5)
        t = srv.stats()["timings"]
        assert t["all_pairs"]["count"] >= 1
        assert t["insert"]["count"] >= 1
        assert t["score_extract"]["seconds"] >= 0
        assert t["rescore"]["count"] >= 1


def test_profile_dir_captures_trace(tmp_path, corpus):
    # jax.profiler trace hook (SURVEY.md §5): a trace directory appears
    cfg = make_cfg(profile_dir=str(tmp_path / "trace"))
    eng = Engine(cfg)
    eng.build(corpus)
    eng.all_pairs(0.5)
    import os

    found = []
    for root, _, files in os.walk(str(tmp_path / "trace")):
        found.extend(files)
    assert found, "no profiler trace files written"


def test_auth_token_gate(corpus):
    cfg = make_cfg(auth_token="sekrit")
    with RpcServer(SimilarityServer(Engine(cfg), cfg)) as rpc:
        addr = [f"127.0.0.1:{rpc.port}"]
        # wrong token -> refused
        with pytest.raises(PermissionError):
            ClientConnection(addr, timeout=10.0, auth_token="wrong")
        # no token -> first real op refused, connection closed
        c = ClientConnection(addr, timeout=10.0)
        rsp = c._request({"op": "stats"})
        assert rsp == {"ok": False, "error": "unauthorized"}
        c.close()
        # right token -> full service
        c = ClientConnection(addr, timeout=10.0, auth_token="sekrit")
        c.insert_new_vector([("a", corpus.row(0))])
        c.flush()
        assert c.stats()["n_rows"] == 1
        c.close()


def test_tls_roundtrip(tmp_path, corpus):
    import subprocess

    cert = str(tmp_path / "cert.pem")
    key = str(tmp_path / "key.pem")
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", cert, "-days", "1",
            "-subj", "/CN=localhost",
        ],
        check=True, capture_output=True,
    )
    cfg = make_cfg(tls_cert=cert, tls_key=key, auth_token="t0k3n")
    with RpcServer(SimilarityServer(Engine(cfg), cfg)) as rpc:
        addr = [f"127.0.0.1:{rpc.port}"]
        # plaintext client cannot speak to a TLS server
        import socket as socklib

        raw = socklib.create_connection(("127.0.0.1", rpc.port), timeout=5)
        raw.sendall(b'{"op": "stats"}\n')
        raw.settimeout(5)
        try:
            data = raw.recv(100)
        except OSError:
            data = b""
        raw.close()
        assert b'"ok": true' not in data.lower()
        # TLS + auth client gets everything, including the event stream
        c = ClientConnection(
            addr, timeout=30.0, ca_file=cert, auth_token="t0k3n"
        )
        events = []
        c.subscribe_outputs(lambda out, moment: events.append(out))
        c.insert_new_vector([("a", corpus.row(0)), ("b", corpus.row(0))])
        c.flush()
        assert c.stats()["n_rows"] == 2
        assert wait_until(lambda: any("a" in e for e in events))
        c.close()


def test_bulk_load_auto_installs_static_max_weights(tmp_path, corpus):
    """load_data with admission="real" must install the store's <table>_MAX
    statistic on the engine (the loop the reference left open:
    HBaseUpLoader.scala:113-123 computes it, EntryProxyActor.scala:51-57
    never loads it) — and subsequent streaming admission stays exactly
    lossless: every oracle pair is emitted despite active pruning."""
    store = VectorStore(str(tmp_path))
    base = corpus.normalized()
    store.write("T", base)
    cfg = make_cfg(admission="real")
    rng = np.random.default_rng(33)
    extra = random_sparse_corpus(rng, 40, DIM)
    with SimilarityServer(Engine(cfg), cfg, store=store) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        srv.load_data("T", 0, base.n_rows - 1)
        assert wait_until(lambda: srv.stats()["n_rows"] == base.n_rows)
        # the static map is installed and is the store's statistic
        installed = getattr(srv.engine, "_static_max_weights", None)
        assert installed is not None
        np.testing.assert_allclose(installed, store.max_weights("T"))
        # stream more vectors through admission
        for i in range(extra.n_rows):
            srv.insert_new_vectors([(f"s{i}", extra.row(i))])
        assert wait_until(
            lambda: srv.stats()["n_rows"]
            == base.n_rows + extra.n_rows
            - srv.stats()["vectors_dropped_admission"]
        )
        srv.flush()
    emitted = set()
    for o in outputs:
        for q, sims in o.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    # oracle over the UNION corpus with the streamed ids
    from apsim.vector.batch import CSRMatrix

    union = CSRMatrix.from_vectors(
        [base.row(i) for i in range(base.n_rows)]
        + [extra.row(i) for i in range(extra.n_rows)],
        DIM,
    )
    ids = [str(i) for i in range(base.n_rows)] + [
        f"s{i}" for i in range(extra.n_rows)
    ]
    want = set()
    for a, b in brute_force_pairs(union, 0.5):
        qa, qb = ids[int(a)], ids[int(b)]
        want.add((qa, qb) if qa <= qb else (qb, qa))
    assert want == emitted  # lossless: no oracle pair missing, none extra


def test_flush_batch_cap_bounds_coalescing(corpus):
    """max_flush_batch bounds every engine micro-batch: a queued backlog
    drains as several capped batches instead of one mega-batch (measured
    r5: unbounded coalescing at 500k rows served 375 vec/s where capped
    2k batches serve 1,322 — and each new pow2 bucket is a fresh compile
    mid-serve)."""
    cfg = make_cfg(max_flush_batch=8)
    with SimilarityServer(Engine(cfg), cfg) as srv:
        sizes = []
        real_insert = srv.engine.insert

        def spy(batch, **kw):
            sizes.append(len(batch))
            return real_insert(batch, **kw)

        srv.engine.insert = spy
        srv.insert_new_vectors(
            [(f"c{i}", corpus.row(i)) for i in range(20)]
        )
        srv.flush()
        assert sizes and max(sizes) <= 8, sizes
        assert sum(sizes) == 20
        assert srv.engine.n_rows == 20
        # cap 0 = reference semantics: everything in one batch
    cfg = make_cfg(max_flush_batch=0)
    with SimilarityServer(Engine(cfg), cfg) as srv:
        sizes = []
        real_insert = srv.engine.insert

        def spy0(batch, **kw):
            sizes.append(len(batch))
            return real_insert(batch, **kw)

        srv.engine.insert = spy0
        srv.insert_new_vectors(
            [(f"d{i}", corpus.row(i)) for i in range(20)]
        )
        srv.flush()
        assert sizes == [20], sizes


def test_drain_defers_subcap_tail_under_backlog(corpus):
    """A periodic drain that flushed a full cap-sized chunk holds back the
    sub-cap streaming tail for the next tick (it merges with newer
    arrivals, so sustained load runs in ONE warmed shape bucket); an
    explicit flush() always drains everything."""
    cfg = make_cfg(max_flush_batch=8, io_trigger_period_ms=10_000)
    with SimilarityServer(Engine(cfg), cfg) as srv:
        sizes = []
        real_insert = srv.engine.insert

        def spy(batch, **kw):
            sizes.append(len(batch))
            return real_insert(batch, **kw)

        srv.engine.insert = spy
        srv.insert_new_vectors([(f"t{i}", corpus.row(i)) for i in range(21)])
        srv._drain()  # one periodic tick: 2 full chunks, tail deferred
        assert sizes == [8, 8], sizes
        assert srv._queue.qsize() == 1  # the 5-vector tail is re-queued
        # a later tick with no backlog (no full chunk) takes the tail as-is
        srv._drain()
        assert sizes == [8, 8, 5], sizes
        # explicit flush never defers
        srv.insert_new_vectors([(f"u{i}", corpus.row(i)) for i in range(9)])
        srv.flush()
        assert sizes == [8, 8, 5, 8, 1], sizes
        assert srv.engine.n_rows == 30
