"""Mesh-sharded out-of-core engine: chunked COO entries × dim sharding.

Combines the two scale axes that were separate in round 1/2:

  - :class:`~apsim.engine.chunked.ChunkedAllPairs` lifts the ROW ceiling
    (no resident dense index — per-chunk COO entries + one slab at a time);
  - :class:`~apsim.parallel.mesh.MeshEngine` lifts the DIM/throughput
    ceiling (index sharded over a device mesh, psum across devices).

Here the chunk axis itself is the shard axis: the per-chunk entry buffers
``[n_chunks, chunk_cap]`` are placed ``P("shards", None)`` so each device
owns ``n_chunks / n_devices`` dim-chunks — the reference's
``dim % maxShardNum`` posting partition (WriteWorkerActor.scala:73-76,
SparseVectorWrapper.scala:9) at out-of-core scale.  Per-device partial score
stripes are ``psum``'d (ops/chunked_mesh.py), multiplying the per-chip entry
budget by the mesh size while keeping the exact-join contract (fp64 host
rescore) unchanged.

All host logic (compact space, shadow CSR, capacity doubling, emission) is
inherited; only the op hooks are rerouted through ``jax.shard_map``.
"""

from __future__ import annotations

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..ops import chunked_mesh as cm_ops
from ..vector.batch import round_up
from .mesh import AXIS, to_host, make_mesh

__all__ = ["MeshChunkedAllPairs"]


class MeshChunkedAllPairs(ChunkedAllPairs):
    """Out-of-core all-pairs engine over a 1-D device mesh.

    Same public API as :class:`ChunkedAllPairs`; ``mesh`` defaults to all
    visible devices (``config.mesh_shape`` may pin a smaller 1-D mesh).
    """

    # int8 stripes are WIRED for the mesh (mesh_quantize_chunk_entries +
    # mesh_stripe_extract_int8, exact int32 psum) but stay opt-in, same as
    # the single-device engine.  Set the attribute True to enable (parity
    # is exact either way).
    _int8_stripes = False
    # the panel join runs SHARDED here (ops/panel_mesh.py): per-device
    # column-sharded slabs, int8 partial dots, exact int32 psum, replicated
    # epilogue — the stripe path stays the fallback
    _use_panels = True
    # the single-device resident match-slab cache does not apply: entries are
    # chunk-sharded across the mesh and every match op here is shard_map'd
    _match_slab_cache_ok = False
    # the shard_map'd match replicates the two-level match_epilogue per
    # device — _run_match keeps its legacy head consumption here
    _match_bits = False

    def __init__(
        self,
        config: AllPairsConfig | None = None,
        mesh: Mesh | None = None,
        chunk_dim: int = 2048,
        super_tile: int | None = None,
        panel_rows: int | None = None,
    ):
        config = config or AllPairsConfig()
        if mesh is None:
            mesh = make_mesh(config.mesh_shape or None)
        if len(mesh.devices.shape) != 1:
            raise ValueError(
                "MeshChunkedAllPairs shards the chunk axis: needs a 1-D mesh"
            )
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size)
        self.ent_sharding = NamedSharding(mesh, P(AXIS, None))
        self.cnt_sharding = NamedSharding(mesh, P(AXIS))
        super().__init__(config, chunk_dim, super_tile, panel_rows)

    # ------------------------------------------------------------ placement
    def _round_chunks(self, n: int) -> int:
        # the sharded leading axis must tile evenly across devices
        return round_up(max(n, self.n_shards), self.n_shards)

    def _place_ent(self, rows2d, cols2d, vals2d):
        import jax

        return tuple(
            jax.device_put(a, self.ent_sharding)
            for a in (rows2d, cols2d, vals2d)
        )

    def _place_counts(self, counts: np.ndarray):
        import jax

        return jax.device_put(counts.astype(np.int32), self.cnt_sharding)

    def _place_q(self, q):
        import jax

        r2, c2, v2, cnts = q
        return (
            jax.device_put(r2, self.ent_sharding),
            jax.device_put(c2, self.ent_sharding),
            jax.device_put(v2, self.ent_sharding),
            jax.device_put(cnts, self.cnt_sharding),
        )

    # ------------------------------------------------------------------ ops
    def _op_append(self, coo5):
        fn = cm_ops.mesh_append_entries(self.mesh, AXIS)
        self._ent = fn(*self._ent, coo5)

    def _op_grow(self, new_cap: int):
        fn = cm_ops.mesh_grow_entry_cap(
            self.mesh, AXIS, new_cap, self._pad_row()
        )
        self._ent = fn(*self._ent)

    def _int8_slabs(self):
        """Mesh analog of ChunkedAllPairs._int8_slabs: per-row maxima and
        bound ingredients assembled across the chunk shards (pmax/psum);
        q2d stays chunk-sharded, aux replicated.  Cached by the immutable
        values array; None when disabled or the int32 gate trips."""
        if not (self._int8_stripes and self.cfg.pallas_int8):
            return None
        key = self._ent[2]
        cached = getattr(self, "_q8_cache", None)
        if cached is not None and cached[0] is key:
            return cached[1]
        fn = cm_ops.mesh_quantize_chunk_entries(
            self.mesh, AXIS, self.row_cap
        )
        q2d, aux, max_nnz = fn(self._ent[0], self._ent[2])
        if int(max_nnz) >= (1 << 30) // (127 * 127):
            self._int8_stripes = False  # shadow the class flag
            self._q8_cache = None
            return None
        out = (q2d, aux)
        self._q8_cache = (key, out)
        return out

    def _op_stripe(self, q0: int, tau_eff, super_tile: int, caps):
        cap, capb, cap0 = caps
        q8 = self._int8_slabs()
        if q8 is not None:
            q2d, aux = q8
            fn = cm_ops.mesh_stripe_extract_int8(
                self.mesh, AXIS, self.row_cap, self._chunk_width, super_tile,
                cap, capb, cap0,
            )
            return fn(
                self._ent[0], self._ent[1], q2d, self._counts_dev, aux,
                np.int32(q0), tau_eff,
            )
        fn = cm_ops.mesh_stripe_extract(
            self.mesh, AXIS, self.row_cap, self._chunk_width, super_tile,
            cap, capb, cap0, self.cfg.matmul_precision,
        )
        return fn(*self._ent, self._counts_dev, np.int32(q0), tau_eff)

    def _op_match(self, q, q_base: int, tau_eff, q_rows_cap: int, cap: int,
                  grp: int):
        fn = cm_ops.mesh_match_extract(
            self.mesh, AXIS, self.row_cap, self._chunk_width, q_rows_cap,
            cap, grp, self.cfg.matmul_precision,
        )
        return fn(
            *self._ent, self._counts_dev, *q, np.int32(q_base), tau_eff
        )

    def _op_topk(self, q, q_rows_cap: int, kf: int):
        fn = cm_ops.mesh_topk(
            self.mesh, AXIS, self.row_cap, self._chunk_width, q_rows_cap,
            kf, "highest",
        )
        return fn(*self._ent, self._counts_dev, *q, np.int32(self.n_rows))

    # ------------------------------------------------------ mesh panel join
    def _panel_d_local(self, d_cap: int) -> int:
        # slabs are column-sharded P(None, shards): each device holds
        # [rb, d_local], so slab budgets apply to the per-device share
        return d_cap // self.n_shards

    def _panel_state(self):
        geom = self._panel_geom()
        if geom is None:
            return None
        rb, n_panels, d_cap = geom
        key = (self._ent[2], geom)
        cached = getattr(self, "_panel_state_cache", None)
        if (
            cached is not None
            and cached[0][0] is key[0]
            and cached[0][1] == key[1]
        ):
            return cached[1]
        from ..engine.chunked import _panel_aux
        from ..ops import panel_mesh
        from ..vector.batch import pow2_bucket

        fn = panel_mesh.mesh_panel_state(
            self.mesh, AXIS, self.row_cap, rb, n_panels
        )
        r_s, c_s, q_s, aux, pcounts, max_nnz = fn(
            self._ent[0], self._ent[1], self._ent[2], self._counts_dev
        )
        if int(max_nnz) >= (1 << 30) // (127 * 127):
            state = None
        else:
            pc = to_host(pcounts)[:, :n_panels].astype(np.int64)
            starts2d = np.zeros((self.n_shards, n_panels), np.int64)
            np.cumsum(pc[:, :-1], axis=1, out=starts2d[:, 1:])
            flat_local = (
                self._n_chunks // self.n_shards
            ) * self._chunk_cap
            p_cap = min(
                pow2_bucket(max(int(pc.max()) if pc.size else 1, 1), 1024),
                flat_local,
            )
            state = {
                "geom": geom,
                "r_s": r_s, "c_s": c_s, "q_s": q_s,
                "starts2d": starts2d, "p_cap": p_cap,
                "aux_of": _panel_aux(aux, rb, n_panels),
                "d_local": d_cap // self.n_shards,
            }
        self._panel_state_cache = (key, state)
        return state

    def _build_slab(self, state, p: int):
        import jax

        from ..ops import panel_mesh

        rb = state["geom"][0]
        fn = panel_mesh.mesh_build_panel_slab(
            self.mesh, AXIS, rb, state["d_local"], state["p_cap"]
        )
        start = jax.device_put(
            state["starts2d"][:, p].astype(np.int32), self.cnt_sharding
        )
        return fn(
            state["r_s"], state["c_s"], state["q_s"], start, np.int32(p * rb)
        )

    def _op_panel_pair(self, state, xi, xj, pi, pj, tau_eff, caps, pack):
        from ..ops import panel_mesh

        rb = state["geom"][0]
        fn = panel_mesh.mesh_panel_pair(
            self.mesh, AXIS, rb, caps[0], caps[1], caps[2], pack,
        )
        return fn(
            xi, xj, state["aux_of"][pi], state["aux_of"][pj],
            np.int32(pi * rb), np.int32(pj * rb), tau_eff,
        )

    # ---------------------------------------------------------- introspection
    def shard_layout(self) -> dict:
        """Which global dim-chunks each device owns (the chunk-granular
        analog of the reference's shard routing table,
        CommonUtils.scala:28-40)."""
        out = {}
        if self._ent is None:
            return out
        n_local = self._n_chunks // self.n_shards
        for i, d in enumerate(self.mesh.devices.flat):
            out[str(d)] = {
                "chunk_block": (i * n_local, (i + 1) * n_local),
                "n_entries": int(
                    self._counts[i * n_local : (i + 1) * n_local].sum()
                ),
            }
        return out
