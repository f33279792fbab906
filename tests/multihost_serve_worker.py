"""Worker for the multi-host SERVE end-to-end test (VERDICT r2 gap #3).

Process 0: joins the 2-process jax.distributed cluster, wraps a global-mesh
MeshEngine in the replicated op log (serve/replica.py), runs the public
RpcServer, and drives it as a CLIENT over TCP — streaming inserts, then an
all_pairs — asserting the served pair set equals the fp64 oracle.

Process 1: joins the cluster and replays the op log (its replay is the
matching entry into every global-mesh collective), asserting it converged
to the same corpus.

Usage: python multihost_serve_worker.py <coord_port> <repl_port> <pid>
"""

import os
import sys

coord_port, repl_port, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from apsim.parallel import global_mesh, init_multihost  # noqa: E402

init_multihost(f"127.0.0.1:{coord_port}", num_processes=2, process_id=pid)
assert jax.device_count() == 8

import numpy as np  # noqa: E402

from apsim import AllPairsConfig  # noqa: E402
from apsim.parallel import MeshEngine  # noqa: E402
from apsim.serve.replica import OpLogLeader, follow  # noqa: E402
from apsim.vector.batch import CSRMatrix  # noqa: E402
from apsim.vector.sparse import SparseVector  # noqa: E402

rng = np.random.default_rng(7)
vecs = []
for _ in range(60):
    nnz = int(rng.integers(4, 10))
    dims = np.sort(rng.choice(400, nnz, replace=False)).astype(np.int32)
    vals = rng.random(nnz) + 0.1
    vals /= np.linalg.norm(vals)
    vecs.append(SparseVector(400, dims, vals))
for i in range(5):
    vecs.append(vecs[i])  # guaranteed pairs
csr = CSRMatrix.from_vectors(vecs, 400)
TAU = 0.5

cfg = AllPairsConfig(
    vector_dim=400, query_tile=32, row_bucket=32, dim_bucket=64,
    shard_axis="dims", io_trigger_period_ms=5,
)
eng = MeshEngine(cfg, mesh=global_mesh())

if pid == 0:
    from apsim.serve import ClientConnection, RpcServer, SimilarityServer

    leader = OpLogLeader(eng, port=repl_port, n_followers=1)
    leader.wait_followers()
    sim = SimilarityServer(leader, cfg)
    with RpcServer(sim, port=0) as rpc:
        cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
        # stream the corpus in over the public RPC surface
        for s in range(0, len(vecs), 16):
            cc.insert_new_vector(
                [(str(i), vecs[i]) for i in range(s, min(s + 16, len(vecs)))]
            )
        cc.flush()
        served = cc.all_pairs(TAU)
        got = {
            tuple(sorted((a, b), key=int)) for a, b, _ in served
        }
        dense = csr.to_dense()
        s_mat = dense @ dense.T
        oi, oj = np.nonzero(np.triu(s_mat >= TAU, k=1))
        want = {(str(a), str(b)) for a, b in zip(oi.tolist(), oj.tolist())}
        assert len(want) >= 5, len(want)
        assert got == want, (len(got), len(want))
        assert sim.stats()["n_rows"] == len(vecs)
        cc.close()
    leader.close()
    print(f"MULTIHOST_SERVE_OK pairs={len(got)}", flush=True)
else:
    n_ops, clean = follow(eng, "127.0.0.1", repl_port)
    assert clean, "leader should have shut down explicitly"
    # follower converged to the same corpus through pure log replay (the
    # server's flusher coalesces RPC batches, so op count is small: at
    # least one insert + the all_pairs)
    assert eng.n_rows == len(vecs), (eng.n_rows, len(vecs))
    assert n_ops >= 2, n_ops
    print(f"FOLLOWER_OK ops={n_ops}", flush=True)

jax.distributed.shutdown()
