"""Multi-host tests: single-process no-op AND a real 2-process
``jax.distributed`` cluster (the Akka seed-node join analog,
conf/akka.conf:10-15) running a mesh build + all-pairs with exact parity.

The 2-process test spawns fresh interpreters (each forcing 4 virtual CPU
devices) because jax.distributed must initialize before any backend touch —
it cannot run inside this already-initialized pytest process.
"""

import os
import socket
import subprocess
import sys

import jax
import pytest

from apsim.parallel import global_mesh, init_multihost, is_coordinator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")
SERVE_WORKER = os.path.join(REPO, "tests", "multihost_serve_worker.py")


def test_single_host_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    init_multihost()  # must not raise or try to dial anything
    assert is_coordinator()
    mesh = global_mesh()
    assert mesh.devices.size == len(jax.devices())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("shard_axis", ["dims", "rows"])
def test_two_process_cluster(shard_axis):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), shard_axis],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "MULTIHOST_OK" in outs[0], outs[0][-3000:]


def test_cli_multihost_serve_end_to_end(tmp_path):
    """`apsim serve --replicate` over a 2-process jax.distributed cluster:
    the coordinator serves RPC, the follower replays the op log; a client
    streams inserts and reads the exact join back."""
    import json as jsonlib
    import signal
    import time

    import numpy as np

    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import SparseVector

    coord, repl, rpc_port = _free_port(), _free_port(), _free_port()
    cfgfile = str(tmp_path / "cfg.json")
    with open(cfgfile, "w") as f:
        jsonlib.dump(
            {"vector_dim": 300, "query_tile": 32, "row_bucket": 32,
             "dim_bucket": 64, "io_trigger_period_ms": 5}, f,
        )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{coord}"
    procs = []
    for pid in (0, 1):
        e = dict(env)
        e["JAX_NUM_PROCESSES"] = "2"
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "apsim.cli", "serve",
             "--config", cfgfile, "--mesh",
             "--replicate", f"127.0.0.1:{repl}",
             "--host", "127.0.0.1", "--port", str(rpc_port)],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    try:
        from apsim.serve import ClientConnection

        rng = np.random.default_rng(3)
        vecs = []
        for _ in range(24):
            nnz = int(rng.integers(4, 9))
            dims = np.sort(
                rng.choice(300, nnz, replace=False)
            ).astype(np.int32)
            vals = rng.random(nnz) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append(SparseVector(300, dims, vals))
        vecs.append(vecs[0])  # guaranteed pair
        cc = None
        deadline = time.time() + 240
        while time.time() < deadline:
            if any(p.poll() is not None for p in procs):
                break  # a server process died; surface its output below
            try:
                probe = ClientConnection(
                    [f"127.0.0.1:{rpc_port}"], timeout=2.0
                )
                probe.close()
                # reconnect without a timeout: first-compile of the mesh
                # shapes can take tens of seconds in the subprocess
                cc = ClientConnection([f"127.0.0.1:{rpc_port}"])
                break
            except OSError:
                time.sleep(1.0)
        if cc is None:
            for p in procs:
                p.kill()
            outs = [p.communicate()[0] for p in procs]
            raise AssertionError(
                "server never came up\n--- p0 ---\n"
                + outs[0][-2000:] + "\n--- p1 ---\n" + outs[1][-2000:]
            )
        cc.insert_new_vector(
            [(str(i), v) for i, v in enumerate(vecs)]
        )
        cc.flush()
        served = cc.all_pairs(0.5)
        got = {tuple(sorted((a, b), key=int)) for a, b, _ in served}
        dense = CSRMatrix.from_vectors(vecs, 300).to_dense()
        s = dense @ dense.T
        oi, oj = np.nonzero(np.triu(s >= 0.5, k=1))
        want = {(str(a), str(b)) for a, b in zip(oi.tolist(), oj.tolist())}
        assert got == want, (len(got), len(want))
        cc.close()
    finally:
        procs[0].send_signal(signal.SIGINT)
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "leader closed" in outs[1], outs[1][-2000:]


def test_oplog_auth_token_gate():
    """The replication socket honors the shared secret: a wrong token is
    rejected, the right one joins (same story as the RPC auth_token)."""
    import socket as socklib
    import threading

    from apsim.serve.replica import OpLogLeader, follow

    class DummyEngine:
        def freeze(self):
            pass

    leader = OpLogLeader(DummyEngine(), port=0, n_followers=1,
                         auth_token="s3cret")
    accepted = threading.Event()

    def acceptor():
        leader.wait_followers()
        accepted.set()

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()
    bad = socklib.create_connection((leader.host, leader.port))
    bad.sendall(b'{"token": "wrong"}\n')
    assert not accepted.wait(0.5)  # rejected, still waiting

    class F:
        def freeze(self):
            self.froze = True

    eng = F()
    done = []

    def follower():
        done.append(follow(eng, leader.host, leader.port, "s3cret"))

    ft = threading.Thread(target=follower, daemon=True)
    ft.start()
    assert accepted.wait(5)
    leader.freeze()
    leader.close()
    ft.join(5)
    assert done == [(1, True)] and getattr(eng, "froze", False)


def test_oplog_stray_connection_rejected_without_token():
    """Even with NO auth token configured, a bare TCP connect (port scan,
    health probe) must not occupy a follower slot: every follower has to
    present the JSON hello line before it is counted."""
    import socket as socklib
    import threading

    from apsim.serve.replica import OpLogLeader, follow

    class DummyEngine:
        def freeze(self):
            self.froze = True

    leader = OpLogLeader(DummyEngine(), port=0, n_followers=1)
    accepted = threading.Event()

    def acceptor():
        leader.wait_followers()
        accepted.set()

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()
    # a stray connection that sends garbage (and one that sends nothing
    # would be dropped after the 10 s handshake timeout — not waited on
    # here to keep the test fast)
    stray = socklib.create_connection((leader.host, leader.port))
    stray.sendall(b"GET / HTTP/1.0\r\n\r\n")
    assert not accepted.wait(0.5)  # not counted as a follower

    eng = DummyEngine()
    done = []

    def follower():
        done.append(follow(eng, leader.host, leader.port))

    ft = threading.Thread(target=follower, daemon=True)
    ft.start()
    assert accepted.wait(5)
    leader.freeze()
    leader.close()
    ft.join(5)
    stray.close()
    assert done == [(1, True)] and getattr(eng, "froze", False)


def test_leader_restore_replicates_state(tmp_path):
    """restore ships the checkpoint corpus AND the stored maxima: follower
    replicas converge to the same rows and the same admission state (a
    divergence would desync collective shapes on a later insert)."""
    import threading

    import numpy as np

    from apsim import AllPairsConfig, Engine
    from apsim.serve.replica import OpLogLeader, follow

    cfg = AllPairsConfig(
        vector_dim=200, query_tile=32, row_bucket=32, dim_bucket=64
    )
    src = Engine(cfg)
    from apsim.vector.sparse import Vectors

    src.build([
        ("a", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
        ("b", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
    ])
    # simulate an admission-dropped record: maxima beyond the corpus
    np.maximum.at(src.max_weights, [5], [0.9])
    ckpt = str(tmp_path / "ck")
    src.save(ckpt)

    leader_eng = Engine(cfg)
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    follower_eng = Engine(cfg)
    done = []

    def run_follower():
        done.append(follow(follower_eng, leader.host, leader.port))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    leader.restore(ckpt)
    leader.close()
    t.join(30)
    assert done and done[0][1], "follower did not finish cleanly"
    assert follower_eng.n_rows == leader_eng.n_rows == 2
    np.testing.assert_array_equal(
        follower_eng.max_weights, leader_eng.max_weights
    )
    assert follower_eng.max_weights[5] == 0.9  # dropped-record maxima too


def test_leader_fails_fast_on_dead_follower():
    """Losing a follower must raise BEFORE entering a collective (which
    would hang every surviving host), with the recovery path in the
    message — the multi-host failure story (SURVEY §5 A3)."""
    import socket as socklib

    from apsim.serve.replica import OpLogLeader

    class DummyEngine:
        def freeze(self):
            pass

    leader = OpLogLeader(DummyEngine(), port=0, n_followers=1)
    client = socklib.create_connection((leader.host, leader.port))
    client.sendall(b'{"token": ""}\n')  # mandatory follower hello
    leader.wait_followers()
    client.close()
    leader.freeze()  # may land in the dead socket's buffer
    with pytest.raises(RuntimeError, match="checkpoint"):
        for _ in range(64):  # broken pipe surfaces within a few writes
            leader.freeze()


def test_follower_promotion_on_leader_loss():
    """Leader crash (socket EOF, no shutdown op): follow() reports
    clean=False, the replica's state equals the leader's pre-crash state,
    and wrapping it in a new OpLogLeader resumes service — including NEW
    followers converging and NEW inserts matching — without losing a row.
    The elastic-recovery story (SURVEY §5 A3): unlike the reference, where
    ClusterSharding relocation loses the in-memory index, every follower
    here IS a full replica."""
    import threading

    from apsim import AllPairsConfig, Engine
    from apsim.serve.replica import OpLogLeader, follow
    from apsim.vector.sparse import Vectors

    cfg = AllPairsConfig(
        vector_dim=200, query_tile=32, row_bucket=32, dim_bucket=64
    )
    leader_eng = Engine(cfg)
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    replica = Engine(cfg)
    done = []

    def run_follower():
        done.append(follow(replica, leader.host, leader.port))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    vecs = [
        ("a", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
        ("b", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
        ("c", Vectors.sparse(200, [7], [1.0])),
    ]
    leader.build(vecs)
    leader.insert([("d", Vectors.sparse(200, [7], [1.0]))], tau=0.5)
    pre_crash = leader_eng.all_pairs(0.5).pair_set()
    assert pre_crash  # nonempty: the state being recovered is real
    # crash: sockets die with the process — no shutdown op is shipped
    for f in leader._files:
        f.close()
    for c in leader._conns:
        c.close()
    leader._srv.close()
    t.join(30)
    assert done, "follower replay loop did not return"
    n_ops, clean = done[0]
    # build + insert (all_pairs above queried the inner engine directly —
    # pure reads need no replication)
    assert not clean and n_ops == 2
    # the replica converged to the exact pre-crash state
    assert replica.all_pairs(0.5).pair_set() == pre_crash
    # PROMOTE: the replica becomes the new leader; a fresh follower joins
    # and service continues from exactly where the old leader died
    new_leader = OpLogLeader(replica, port=0, n_followers=1)
    replica2 = Engine(cfg)
    done2 = []

    def run_follower2():
        done2.append(follow(replica2, new_leader.host, new_leader.port))

    t2 = threading.Thread(target=run_follower2, daemon=True)
    t2.start()
    new_leader.wait_followers()
    # bring the new follower to the promoted state, then serve new traffic
    new_leader.restore_from_engine()
    out = new_leader.insert(
        [("e", Vectors.sparse(200, [1, 2], [0.6, 0.8]))], tau=0.5
    )
    assert "a" in out.output.get("e", {})
    post = replica.all_pairs(0.5).pair_set()
    assert post > pre_crash
    new_leader.close()
    t2.join(30)
    assert done2 and done2[0][1]
    assert replica2.all_pairs(0.5).pair_set() == post


def test_two_process_serve_end_to_end():
    """RPC ingest -> replicated op log -> 2-process global mesh -> pair set
    equals the fp64 oracle (the composition VERDICT r2 called unproven:
    multi-host serving end-to-end, SimilaritySearchService.scala:28-32)."""
    coord = _free_port()
    repl = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, SERVE_WORKER, str(coord), str(repl), str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "MULTIHOST_SERVE_OK" in outs[0], outs[0][-3000:]
    assert "FOLLOWER_OK" in outs[1], outs[1][-3000:]


def test_follow_torn_final_line_is_promotable():
    """Leader dies mid-write of an op line: the torn tail was never
    executed anywhere (ship precedes execute), so follow() must report the
    replica promotable (clean=False) instead of crashing on the decode."""
    import json
    import socket as socklib
    import threading

    srv = socklib.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    host, port = srv.getsockname()

    def leader():
        conn, _ = srv.accept()
        # consume the follower hello like the real leader does: closing
        # with unread inbound data raises RST, which can destroy the
        # already-sent op lines in the follower's receive buffer
        conn.makefile("r", encoding="utf-8").readline()
        conn.sendall((json.dumps({"op": "freeze"}) + "\n").encode())
        conn.sendall(b'{"op": "insert", "vecto')  # torn: died mid-write
        conn.close()

    t = threading.Thread(target=leader, daemon=True)
    t.start()

    class F:
        def freeze(self):
            self.froze = True

    from apsim.serve.replica import follow

    eng = F()
    n_ops, clean = follow(eng, host, port)
    srv.close()
    assert (n_ops, clean) == (1, False) and eng.froze


def test_restore_from_engine_replicates_frozen_flag():
    """A promoted FROZEN leader must ship freeze to catch-up followers:
    an unfrozen follower would index the next insert the leader only
    matches, silently desyncing the corpora."""
    import threading

    from apsim import AllPairsConfig, Engine
    from apsim.serve.replica import OpLogLeader, follow
    from apsim.vector.sparse import Vectors

    cfg = AllPairsConfig(
        vector_dim=200, query_tile=32, row_bucket=32, dim_bucket=64
    )
    promoted = Engine(cfg)
    promoted.build([("a", Vectors.sparse(200, [1, 2], [0.6, 0.8]))])
    promoted.freeze()

    leader = OpLogLeader(promoted, port=0, n_followers=1)
    fresh = Engine(cfg)
    done = []

    def run_follower():
        done.append(follow(fresh, leader.host, leader.port))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    leader.restore_from_engine()
    leader.close()
    t.join(30)
    assert done and done[0][1]
    assert fresh.n_rows == 1
    assert fresh.frozen, "freeze flag was not replicated on catch-up"


def test_oplog_bulk_build_framed_50k():
    """VERDICT r4 #6: a bulk corpus must replicate WITHOUT materializing as
    JSON lists.  50k rows / >1M nnz ships as bounded binary frames
    (build_begin / build_chunk / build_end) and arrives bit-exact."""
    import threading

    import numpy as np

    from apsim.bench.scale import synthetic_corpus
    from apsim.serve.replica import _JSON_NNZ_LIMIT, OpLogLeader, follow

    csr = synthetic_corpus(50_000, nnz_mean=30, seed=3)
    assert int(csr.indptr[-1]) > _JSON_NNZ_LIMIT  # really takes the framed path

    class Cfg:
        vector_dim = csr.n_cols

    class Recorder:
        cfg = Cfg()

        def build(self, got, ids):
            self.got, self.got_ids = got, list(ids)

    leader_eng, follower_eng = Recorder(), Recorder()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    done = []

    def run_follower():
        done.append(follow(follower_eng, leader.host, leader.port))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    ids = [f"d{i}" for i in range(csr.n_rows)]
    leader.build(csr, ids)
    leader.close()
    t.join(120)
    assert done and done[0][1], "follower did not finish cleanly"
    got = follower_eng.got
    np.testing.assert_array_equal(got.indptr, csr.indptr)
    np.testing.assert_array_equal(got.indices, csr.indices)
    np.testing.assert_array_equal(got.data, csr.data)  # bit-exact fp64
    assert follower_eng.got_ids == ids
    # and the leader side executed the identical build locally
    assert leader_eng.got is csr and leader_eng.got_ids == ids


def test_oplog_framed_build_engine_parity(monkeypatch):
    """End-to-end: the framed wire form feeds a REAL engine on both sides
    and the replicas answer all_pairs identically (the collective-lockstep
    contract, now through binary frames)."""
    import threading

    from apsim import AllPairsConfig, Engine
    from apsim.serve import replica
    from apsim.serve.replica import OpLogLeader, follow
    from apsim.vector.sparse import Vectors

    monkeypatch.setattr(replica, "_JSON_NNZ_LIMIT", 0)  # force framing
    cfg = AllPairsConfig(
        vector_dim=200, query_tile=32, row_bucket=32, dim_bucket=64
    )
    leader_eng, follower_eng = Engine(cfg), Engine(cfg)
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    done = []

    def run_follower():
        done.append(follow(follower_eng, leader.host, leader.port))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    leader.build([
        ("a", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
        ("b", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
        ("c", Vectors.sparse(200, [7], [1.0])),
    ])
    res = leader.all_pairs(0.5)
    leader.close()
    t.join(60)
    assert done and done[0][1]
    assert follower_eng.n_rows == 3
    assert follower_eng.all_pairs(0.5).pair_set() == res.pair_set()


def test_oplog_load_table_ships_reference_not_corpus(tmp_path):
    """Replicated bulk load through a shared VectorStore: the op log
    carries table name + content hash; leader and follower ingest the
    IDENTICAL batch sequence from their own store reads."""
    import threading

    from apsim.bench.scale import synthetic_corpus
    from apsim.etl.store import VectorStore
    from apsim.serve.replica import OpLogLeader, follow

    csr = synthetic_corpus(50_000, nnz_mean=8, seed=5)
    store = VectorStore(str(tmp_path / "store"), run_mode="PRODUCT")
    store.write("corpus", csr)

    class Cfg:
        vector_dim = csr.n_cols

    class Recorder:
        cfg = Cfg()

        def __init__(self):
            self.batches = []

        def insert(self, batch, tau=None, bulk=False):
            assert bulk
            self.batches.append([vid for vid, _ in batch])

    leader_eng, follower_eng = Recorder(), Recorder()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    done = []

    def run_follower():
        done.append(
            follow(follower_eng, leader.host, leader.port, store=store)
        )

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    outs = leader.load_table(store, "corpus", 0, csr.n_rows - 1,
                             io_range_num=4, max_io_workers=4)
    leader.close()
    t.join(120)
    assert done and done[0][1]
    assert leader_eng.batches == follower_eng.batches
    assert sum(len(b) for b in leader_eng.batches) == csr.n_rows
    assert len(outs) == len(leader_eng.batches)


def test_oplog_load_table_hash_mismatch_fails_fast(tmp_path):
    """Two store copies that drifted must kill the replay loudly — NOT
    bulk-load different corpora into one lockstep mesh."""
    import threading

    from apsim.bench.scale import synthetic_corpus
    from apsim.etl.store import VectorStore
    from apsim.serve.replica import OpLogLeader, follow

    a = VectorStore(str(tmp_path / "a"), run_mode="PRODUCT")
    b = VectorStore(str(tmp_path / "b"), run_mode="PRODUCT")
    a.write("corpus", synthetic_corpus(64, nnz_mean=4, seed=1))
    b.write("corpus", synthetic_corpus(64, nnz_mean=4, seed=2))  # drifted

    class Cfg:
        vector_dim = 1 << 20

    class Recorder:
        cfg = Cfg()

        def insert(self, batch, tau=None, bulk=False):
            pass

    leader = OpLogLeader(Recorder(), port=0, n_followers=1)
    err = []

    def run_follower():
        try:
            follow(Recorder(), leader.host, leader.port, store=b)
        except RuntimeError as e:
            err.append(str(e))

    t = threading.Thread(target=run_follower, daemon=True)
    t.start()
    leader.wait_followers()
    leader.load_table(a, "corpus", 0, 63, io_range_num=1, max_io_workers=1)
    leader.close()
    t.join(60)
    assert err and "hash mismatch" in err[0]
