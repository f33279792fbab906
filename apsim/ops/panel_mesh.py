"""Mesh-sharded panel join: panel slabs sharded by chunk columns.

Extends the panel join (``ops/panel.py``) to the chunk-sharded out-of-core
engine: every device holds its own chunks' entries, so a row panel's int8
slab is naturally COLUMN-sharded — device d densifies ``[rb, d_local]`` from
its local entries, the panel-pair score is the sum of per-device int8
partial dots (an exact int32 ``psum``), and the quantization-bound epilogue
+ bit-packed compaction run replicated on the summed scores.  The int32
psum is exact, so the per-pair bound proof (``ops/panel.py``) carries over
unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .bits import _compact_bits
from .panel import int8_dot, pair_bits

__all__ = [
    "mesh_panel_state",
    "mesh_build_panel_slab",
    "mesh_panel_pair",
]


@functools.lru_cache(maxsize=None)
def mesh_panel_state(mesh: Mesh, axis: str, row_cap: int, rb: int,
                     n_panels: int):
    """Compiled fn: (rows2d, cols2d, vals2d, counts) ->
    (r_s, c_s, q_s, aux, pcounts, max_nnz).

    Per device: global per-row α/L1/nnz assembled with pmax/psum (a row's
    dims are split across devices), local entries int8-quantized, then
    sorted by row with SLAB-LOCAL columns (``local_dim · n_local_chunks +
    local_chunk`` — any per-device bijection works, the dot contracts it).
    ``r_s/c_s/q_s/pcounts`` come out device-stacked ``P(axis, None)``;
    ``aux`` replicated."""

    def local(rows2d, cols2d, vals2d, counts):
        n_local, cap = rows2d.shape
        pos = jax.lax.broadcasted_iota(jnp.int32, (n_local, cap), 1)
        valid = pos < counts[:, None]
        flat_r = jnp.where(valid, rows2d, 1 << 30).reshape(-1)
        flat_v = jnp.where(valid, vals2d, 0.0).reshape(-1)
        safe_r = jnp.minimum(flat_r, row_cap - 1)
        absv = jnp.abs(flat_v)
        mx = jnp.zeros((row_cap,), jnp.float32).at[flat_r].max(
            absv, mode="drop"
        )
        mx = jax.lax.pmax(mx, axis)
        alpha = jnp.where(mx > 0, mx / 127.0, 0.0)
        div = jnp.where(alpha[safe_r] > 0, alpha[safe_r], 1.0)
        q = jnp.clip(jnp.round(flat_v / div), -127, 127).astype(jnp.int8)
        l1q = jnp.zeros((row_cap,), jnp.float32).at[flat_r].add(
            jnp.abs(q).astype(jnp.float32), mode="drop"
        )
        l1q = jax.lax.psum(l1q, axis)
        nnz = jnp.zeros((row_cap,), jnp.float32).at[flat_r].add(
            (flat_v != 0).astype(jnp.float32), mode="drop"
        )
        nnz = jax.lax.psum(nnz, axis)
        aux = jnp.stack([alpha, alpha * l1q, nnz])
        chunk_of = jax.lax.broadcasted_iota(jnp.int32, (n_local, cap), 0)
        c_slab = (cols2d * n_local + chunk_of).reshape(-1)
        order = jnp.argsort(flat_r)
        r_s = flat_r[order]
        c_s = c_slab[order]
        q_s = q[order]
        pan = jnp.minimum(r_s // rb, n_panels).astype(jnp.int32)
        pcounts = jnp.zeros((n_panels + 1,), jnp.int32).at[pan].add(1)
        return (
            r_s[None], c_s[None], q_s[None], aux, pcounts[None],
            jnp.max(nnz).astype(jnp.int32),
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(),
            P(axis, None), P(),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_build_panel_slab(mesh: Mesh, axis: str, rb: int, d_local: int,
                          p_cap: int):
    """Compiled fn: (r_s, c_s, q_s, start, row0) -> int8 slab
    ``[rb, n_dev · d_local]`` column-sharded ``P(None, axis)``.  Same
    row-range-masked, clamp-safe slice as the single-device
    ``build_panel_slab`` — per-device ``start``."""

    def local(r_s, c_s, q_s, start, row0):
        r = jax.lax.dynamic_slice(r_s[0], (start[0],), (p_cap,))
        c = jax.lax.dynamic_slice(c_s[0], (start[0],), (p_cap,))
        q = jax.lax.dynamic_slice(q_s[0], (start[0],), (p_cap,))
        ok = (r >= row0) & (r < row0 + rb)
        rl = jnp.where(ok, r - row0, rb)
        c = jnp.where(ok, c, 0)
        q = jnp.where(ok, q, 0)
        slab = jnp.zeros((rb, d_local), jnp.int8)
        return slab.at[rl, c].set(q, mode="drop", unique_indices=True)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis), P()),
        out_specs=P(None, axis),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_panel_pair(
    mesh: Mesh, axis: str, rb: int, cap: int, capb: int, cap0: int,
    pack: bool,
):
    """Compiled fn: (xi, xj, aux_i, aux_j, row0_i, row0_j, tau_eff) ->
    ((rows, cols), packed_head) — one panel pair: per-device int8 partial
    dot, exact int32 psum, replicated bound epilogue + compaction over the
    whole ``[rb, rb]`` rectangle as one block."""

    def local(xi, xj, aux_i, aux_j, row0_i, row0_j, tau_eff):
        d = jax.lax.psum(int8_dot(xi, xj), axis)
        gb, g64, cnt = pair_bits(d, aux_i, aux_j, row0_i, row0_j, tau_eff)
        bi = (row0_i // rb).astype(jnp.int32)[None]
        bj = (row0_j // rb).astype(jnp.int32)[None]
        return _compact_bits(
            gb, g64, cnt, bi, bj, cap, capb, cap0, rb, rb, pack,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(), P(), P(), P(), P()),
        out_specs=((P(), P()), P()),
        check_vma=False,
    )
    return jax.jit(fn)
