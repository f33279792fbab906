"""Worker process for the real 2-process jax.distributed test.

Each process owns 4 virtual CPU devices; together they form one 8-device
global mesh — the ``jax.distributed`` analog of the reference's Akka seed
-node cluster join (conf/akka.conf:10-15).  Both processes build the same
corpus, the MeshEngine shards the index over the GLOBAL mesh (cross-process
collectives ride the distributed runtime), and process 0 asserts exact
pair-set parity against the fp64 oracle.

Usage: python multihost_worker.py <coordinator_port> <process_id>
"""

import os
import sys

port, pid = sys.argv[1], int(sys.argv[2])
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from apsim.parallel import (  # noqa: E402
    global_mesh,
    init_multihost,
    is_coordinator,
)

init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert len(jax.local_devices()) == 4

import numpy as np  # noqa: E402

from apsim import AllPairsConfig  # noqa: E402
from apsim.parallel import MeshEngine  # noqa: E402
from apsim.vector.batch import CSRMatrix  # noqa: E402
from apsim.vector.sparse import SparseVector  # noqa: E402

rng = np.random.default_rng(5)
vecs = []
for _ in range(80):
    nnz = int(rng.integers(4, 10))
    dims = np.sort(rng.choice(500, nnz, replace=False)).astype(np.int32)
    vals = rng.random(nnz) + 0.1
    vals /= np.linalg.norm(vals)
    vecs.append(SparseVector(500, dims, vals))
# guarantee a non-trivial pair set: exact duplicates + dense overlap block
for i in range(6):
    vecs.append(vecs[i])
csr = CSRMatrix.from_vectors(vecs, 500)

shard_axis = sys.argv[3] if len(sys.argv) > 3 else "dims"
cfg = AllPairsConfig(
    vector_dim=500, query_tile=32, row_bucket=32, dim_bucket=64,
    shard_axis=shard_axis,
)
eng = MeshEngine(cfg, mesh=global_mesh())
eng.build(csr)
res = eng.all_pairs(0.5)

dense = csr.to_dense()
s = dense @ dense.T
oi, oj = np.nonzero(np.triu(s >= 0.5, k=1))
want = set(zip(oi.tolist(), oj.tolist()))
got = {(int(a), int(b)) for a, b in zip(res.i, res.j)}
assert len(want) >= 6, len(want)  # the duplicate block guarantees pairs
assert got == want, (len(got), len(want))

# streaming insert across the global mesh
out = eng.insert([("probe", vecs[0])], tau=0.5)
assert "probe" in out.output and "0" in out.output["probe"], out.output

if shard_axis == "dims":
    # out-of-core engine over the same 2-process global mesh: chunk axis
    # sharded across hosts, shard_map psum riding the distributed runtime
    from apsim.parallel import MeshChunkedAllPairs  # noqa: E402

    mce = MeshChunkedAllPairs(cfg, mesh=global_mesh(), chunk_dim=16)
    mce.build(csr)
    res_c = mce.all_pairs(0.5)
    got_c = {(int(a), int(b)) for a, b in zip(res_c.i, res_c.j)}
    assert got_c == want, ("chunked-mesh", len(got_c), len(want))
    out_c = mce.insert([("probe_c", vecs[1])], tau=0.5)
    assert "probe_c" in out_c.output and "1" in out_c.output["probe_c"]

if is_coordinator():
    print(f"MULTIHOST_OK pairs={len(got)}", flush=True)
jax.distributed.shutdown()
