"""Mesh-sharded engine: dimension-sharded scale-out over several devices.

The reference scales by partitioning posting lists across Akka cluster shards
with ``dim % maxShardNum`` and multicasting each vector once per shard with
only that shard's dims (WriteWorkerActor.scala:73-76,172-174;
SparseVectorWrapper.scala:9), then letting ClusterSharding place the shards
(CommonUtils.scala:28-46).  On a device mesh the same decomposition is a
*column sharding* of the dense index matrix over a ``jax.sharding.Mesh``:

  - ``shard_axis="dims"`` (default, reference parity): ``X [rows, dims]`` is
    sharded ``P(None, "shards")`` — each device owns a contiguous block of
    compact dims (contiguous instead of modulo for locality; SURVEY.md §2).
    ``X @ Qᵀ`` then contracts over the sharded axis and XLA inserts the
    ``psum`` of per-device partial dot products — exactly the
    "assemble full cosine from shard-local partial sums" the actor system
    never did (it recomputed full dots per shard instead).
  - ``shard_axis="rows"``: data-parallel alternative — each device owns a
    block of vectors, queries are broadcast; no psum, results concatenate.

  - ``shard_axis="both"``: a 2-D mesh ``(rows × dims)`` — the index matrix is
    sharded ``P("rows", "dims")``: row blocks give data parallelism, dim
    blocks give the reference-style posting partition within each row group;
    XLA composes the psum over the dim axis with the row-parallel layout.
    This is the layout that scales both corpus size AND vocabulary at once.

Everything else (extraction, growth, rescore) is inherited unchanged from
:class:`~apsim.engine.engine.Engine`; GSPMD propagates the sharding
through the scatter/extract jits.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..vector.batch import round_up

__all__ = ["MeshEngine", "make_mesh"]

AXIS = "shards"
ROW_AXIS = "rows"
DIM_AXIS = "dims"


def to_host(a) -> np.ndarray:
    """The whole of a device-stacked array on this host, also when its
    shards live in other processes of a multi-host mesh."""
    if a.is_fully_addressable:
        return np.asarray(a)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def make_mesh(shape: Sequence[int] | int | None = None, devices=None) -> Mesh:
    """Mesh over all devices (or an explicit device list): 1-D ``(shards,)``
    for a single shard axis, or 2-D ``(rows, dims)`` when given two sizes."""
    if devices is None:
        devices = jax.devices()
    if shape is None or shape == ():
        n = len(devices)
        dims = (n,)
    elif isinstance(shape, int):
        dims = (shape,)
    else:
        dims = tuple(int(s) for s in shape)
    n = int(np.prod(dims))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    if len(dims) == 1:
        return Mesh(np.array(devices[:n]), (AXIS,))
    if len(dims) == 2:
        return Mesh(
            np.array(devices[:n]).reshape(dims), (ROW_AXIS, DIM_AXIS)
        )
    raise ValueError(f"mesh shape must be 1-D or 2-D, got {dims}")


class MeshEngine(Engine):
    """Engine whose index matrix lives sharded across a device mesh.

    The public API is identical to :class:`Engine`; construction takes the
    mesh (or builds one over all visible devices).  ``max_shard_num`` from the
    reference config maps to the mesh size.
    """

    def __init__(
        self,
        config: AllPairsConfig | None = None,
        mesh: Mesh | None = None,
    ):
        config = config or AllPairsConfig()
        if mesh is None:
            mesh = make_mesh(config.mesh_shape or None)
        self.mesh = mesh
        self.n_shards = int(np.prod(mesh.devices.shape))
        if len(mesh.devices.shape) == 2:
            # 2-D mesh: rows × dims jointly sharded
            n_rows_shards, n_dim_shards = mesh.devices.shape
            spec = P(ROW_AXIS, DIM_AXIS)
            config = config.replace(
                shard_axis="both",
                dim_bucket=round_up(config.dim_bucket, 128 * n_dim_shards),
                row_bucket=round_up(
                    max(config.row_bucket, config.query_tile),
                    8 * n_rows_shards,
                ),
            )
        elif config.shard_axis == "dims":
            spec = P(None, AXIS)
            # column blocks must tile evenly across shards
            config = config.replace(
                dim_bucket=round_up(config.dim_bucket, 128 * self.n_shards)
            )
        elif config.shard_axis == "rows":
            spec = P(AXIS, None)
            config = config.replace(
                row_bucket=round_up(
                    max(config.row_bucket, config.query_tile),
                    8 * self.n_shards,
                )
            )
        else:
            raise ValueError(f"unknown shard_axis: {config.shard_axis}")
        self.x_sharding = NamedSharding(mesh, spec)
        super().__init__(config)

    def _place(self, x):
        return jax.device_put(x, self.x_sharding)

    # ----------------------------------------------- rows-sharded int8 join
    # With rows sharding the upper-triangle panel pairs partition across
    # devices: each device scores its share of pairs at int8 against one
    # all-gathered int8 index copy (ops/mesh_rows.py) — no psum.  The dims
    # and 2-D layouts take the XLA float path, whose contraction over the
    # sharded dim axis GSPMD turns into the reference-style psum.

    def _mesh_rows_panel(self) -> int | None:
        """Panel height of the rows-sharded int8 join, or None when the
        layout is not rows-sharded or the row capacity does not tile."""
        if self.cfg.shard_axis != "rows" or self.x is None:
            return None
        if self.row_cap % self.n_shards or self.row_cap % 64:
            return None
        from ..ops import panel

        return panel.panel_rows_for(self.row_cap, self._int8_panel_rows)

    def _int8_ok(self) -> bool:
        if self.x is not None and len(self.x.devices()) == 1:
            return super()._int8_ok()
        if (
            self.x is None
            or not self._int8_allowed()
            or self._mesh_rows_panel() is None
        ):
            return False
        from ..utils import memory

        # per device: the striped 1/n share of the ~row_cap²/14-byte hit
        # structure, PLUS one all-gathered int8 index copy
        n = self.n_shards
        return (
            self.row_cap * self.row_cap // (14 * n)
            + self.row_cap * self.dim_cap
        ) <= memory.budget(memory.HIT_BITS + memory.PANEL_RESIDENT)

    def _all_pairs_int8(self, tau_eff, cap: int):
        if self.x is not None and len(self.x.devices()) == 1:
            return super()._all_pairs_int8(tau_eff, cap)
        from ..ops import bits, mesh_rows
        from ..ops import score as score_ops
        from ..vector.batch import pow2_bucket

        self._used_int8 = True
        rb = self._mesh_rows_panel()
        n = self.n_shards
        sh = NamedSharding(self.mesh, P(AXIS, None))
        pi, pj, va = (
            jax.device_put(a, sh)
            for a in mesh_rows.rows_schedule(self.row_cap, n, rb)
        )
        caps = getattr(self, "_mesh_caps", None)
        if caps is None:
            c = pow2_bucket(cap, 1024)
            cb = max(c // bits.GROUP, 1024)
            caps = (c, cb, cb)  # generous cap0 default: see bits
        pack = self.row_cap <= 65536
        while True:
            fn = mesh_rows.mesh_rows_extract_int8(
                self.mesh, AXIS, rb, *caps, pack,
            )
            rows, cols, heads = fn(self.x, pi, pj, va, tau_eff)
            heads_np = to_host(heads)
            parsed = [bits.unpack_head(heads_np[d]) for d in range(n)]
            mx = tuple(
                max(p[k] for p in parsed) for k in (2, 3, 4)
            )
            if mx[0] > caps[0] or mx[1] > caps[1] or mx[2] > caps[2]:
                caps = score_ops.grow_caps(caps, mx)
                continue
            break
        self._mesh_caps = score_ops.tighten_caps(mx, caps)
        all_i, all_j = [], []
        for d, (rows_h, cols_h, total, _, _) in enumerate(parsed):
            if total == 0:
                continue
            if total <= rows_h.size:
                all_i.append(rows_h[:total])
                all_j.append(cols_h[:total])
            else:
                if not getattr(rows, "is_fully_addressable", True):
                    rows, cols = to_host(rows), to_host(cols)
                dec = score_ops.decode_pairs((rows[d], cols[d]), total)
                all_i.append(dec[0])
                all_j.append(dec[1])
        if not all_i:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return np.concatenate(all_i), np.concatenate(all_j)

    def shard_layout(self) -> dict:
        """Introspection: which compact-dim (or row) block each device owns —
        the moral equivalent of the reference's shard→entry routing table
        (CommonUtils.scala:28-40)."""
        n = self.n_shards
        out = {}
        if self.cfg.shard_axis == "both":
            nr, nd = self.mesh.devices.shape
            rb = self.row_cap // nr if self.row_cap else 0
            db = self.dim_cap // nd if self.dim_cap else 0
            for (ri, di), d in np.ndenumerate(self.mesh.devices):
                out[str(d)] = {
                    "row_block": (ri * rb, (ri + 1) * rb),
                    "dim_block": (di * db, (di + 1) * db),
                }
        elif self.cfg.shard_axis == "dims":
            block = self.dim_cap // n if self.dim_cap else 0
            for i, d in enumerate(self.mesh.devices.flat):
                out[str(d)] = {"dim_block": (i * block, (i + 1) * block)}
        else:
            block = self.row_cap // n if self.row_cap else 0
            for i, d in enumerate(self.mesh.devices.flat):
                out[str(d)] = {"row_block": (i * block, (i + 1) * block)}
        return out
