"""Mesh-sharded chunked ops: out-of-core joins × dimension sharding.

The single-device chunked ops (``ops/chunked.py``) loop a ``fori`` over ALL
dim-chunks, densifying one slab at a time.  Here the chunk axis is sharded
over a 1-D device mesh (``P("shards", None)`` on the per-chunk entry
buffers) and each device loops only its OWN ``n_chunks / n_devices`` chunks
— the reference's ``dim % maxShardNum`` posting partition
(WriteWorkerActor.scala:73-76) at out-of-core scale.  Partial score stripes
are ``psum``'d across devices (the per-shard partial-dot assembly the actor system
never did), and the threshold/extract epilogue runs replicated so the result
needs no further collective.

Everything is expressed with ``jax.shard_map``: explicit per-device slabs +
one collective per stripe, so XLA schedules the chunk loop and the psum
without any gather of the (large) sharded entry buffers.

Appends/growth are shard_map'd too: every device receives the (small,
replicated) batch entries and keeps only those whose global chunk index
falls in its shard — one donated scatter per device, no host routing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .chunked import (
    _densify_chunk,
    int8_join_epilogue,
    join_epilogue_bits,
    match_epilogue,
)
from .score import _precision

__all__ = [
    "mesh_stripe_extract",
    "mesh_stripe_extract_int8",
    "mesh_quantize_chunk_entries",
    "mesh_match_extract",
    "mesh_topk",
    "mesh_append_entries",
    "mesh_grow_entry_cap",
]


def _score_dtype(precision: str):
    return jnp.float32 if precision == "highest" else jnp.bfloat16


def _varying(x, axis: str):
    """Mark a loop carry as device-varying along ``axis`` — the chunk loop's
    partial sums differ per device until the psum (shard_map VMA typing)."""
    return jax.lax.pcast(x, (axis,), to="varying")


@functools.lru_cache(maxsize=None)
def mesh_stripe_extract(
    mesh: Mesh, axis: str, row_cap: int, chunk_dim: int, super_tile: int,
    cap: int, capb: int, cap0: int, precision: str,
):
    """Compiled fn: (ent..., counts, q0, tau_eff) ->
    ((rows, cols), packed_head) for one upper-triangle query stripe,
    chunk axis sharded over ``axis`` (three-level bit-packed extraction)."""
    prec = _precision(precision)
    sdt = _score_dtype(precision)

    def local(rows2d, cols2d, vals2d, counts, q0, tau_eff):
        n_local = rows2d.shape[0]

        def chunk_body(c, acc):
            slab = _densify_chunk(
                rows2d, cols2d, vals2d, counts, c, row_cap, chunk_dim, sdt
            )
            q = jax.lax.dynamic_slice(slab, (q0, 0), (super_tile, chunk_dim))
            return acc + jax.lax.dot_general(
                slab, q,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )

        s = jax.lax.fori_loop(
            0, n_local, chunk_body,
            _varying(jnp.zeros((row_cap, super_tile), jnp.float32), axis),
        )
        s = jax.lax.psum(s, axis)
        s = jax.lax.optimization_barrier(s)
        return join_epilogue_bits(s, q0, tau_eff, cap, capb, cap0)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(axis), P(), P(),
        ),
        out_specs=((P(), P()), P()),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_quantize_chunk_entries(mesh: Mesh, axis: str, row_cap: int):
    """Compiled fn: (rows2d, vals2d) -> (q2d, aux, max_nnz) — per-row int8
    quantization of the SHARDED entry buffers.  A device only sees its own
    chunks (a row's dims are split across devices), so the per-row maxima /
    L1 / nnz are assembled with pmax/psum before quantizing locally; ``aux``
    comes out replicated, ``q2d`` stays chunk-sharded.  Same α = 0 rule for
    empty rows as the single-device path."""

    def local(rows2d, vals2d):
        flat_r = rows2d.reshape(-1)
        flat_v = vals2d.reshape(-1)
        absv = jnp.abs(flat_v)
        mx = jnp.zeros((row_cap,), jnp.float32).at[flat_r].max(
            absv, mode="drop"
        )
        mx = jax.lax.pmax(mx, axis)
        alpha = jnp.where(mx > 0, mx / 127.0, 0.0)
        safe_r = jnp.minimum(flat_r, row_cap - 1)
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
        return q.reshape(rows2d.shape), aux, jnp.max(nnz).astype(jnp.int32)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_stripe_extract_int8(
    mesh: Mesh, axis: str, row_cap: int, chunk_dim: int, super_tile: int,
    cap: int, capb: int, cap0: int,
):
    """int8 variant of ``mesh_stripe_extract``: per-device int8 slabs and
    EXACT int32 partial dots, psum'd across devices, then the shared per-pair
    quantization-bound epilogue (``chunked.int8_join_epilogue``) replicated.
    The int32 psum is exact, so the bound proof carries over unchanged."""

    def local(rows2d, cols2d, q2d, counts, aux, q0, tau_eff):
        n_local = rows2d.shape[0]

        def chunk_body(c, acc):
            slab = _densify_chunk(
                rows2d, cols2d, q2d, counts, c, row_cap, chunk_dim, jnp.int8
            )
            q = jax.lax.dynamic_slice(slab, (q0, 0), (super_tile, chunk_dim))
            return acc + jax.lax.dot_general(
                slab, q,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )

        d = jax.lax.fori_loop(
            0, n_local, chunk_body,
            _varying(jnp.zeros((row_cap, super_tile), jnp.int32), axis),
        )
        d = jax.lax.psum(d, axis)
        d = jax.lax.optimization_barrier(d)
        return int8_join_epilogue(d, aux, q0, tau_eff, cap, capb, cap0)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(axis), P(),
            P(), P(),
        ),
        out_specs=((P(), P()), P()),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_match_extract(
    mesh: Mesh, axis: str, row_cap: int, chunk_dim: int, q_rows_cap: int,
    cap: int, group: int, precision: str,
):
    """Compiled fn: (ent..., counts, q_ent..., q_counts, q_base, tau_eff) ->
    (bufs, packed_head) — streaming match of a chunk-bucketed query batch
    against the full sharded index."""
    prec = _precision(precision)
    sdt = _score_dtype(precision)

    def local(rows2d, cols2d, vals2d, counts,
              q_rows2d, q_cols2d, q_vals2d, q_counts, q_base, tau_eff):
        n_local = rows2d.shape[0]

        def chunk_body(c, acc):
            slab = _densify_chunk(
                rows2d, cols2d, vals2d, counts, c, row_cap, chunk_dim, sdt
            )
            qslab = _densify_chunk(
                q_rows2d, q_cols2d, q_vals2d, q_counts, c, q_rows_cap,
                chunk_dim, sdt,
            )
            return acc + jax.lax.dot_general(
                slab, qslab,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )

        s = jax.lax.fori_loop(
            0, n_local, chunk_body,
            _varying(jnp.zeros((row_cap, q_rows_cap), jnp.float32), axis),
        )
        s = jax.lax.psum(s, axis)
        s = jax.lax.optimization_barrier(s)
        return match_epilogue(s, q_base, tau_eff, cap, group)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(axis),
            P(axis, None), P(axis, None), P(axis, None), P(axis), P(), P(),
        ),
        out_specs=((P(), P()), P()),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_topk(
    mesh: Mesh, axis: str, row_cap: int, chunk_dim: int, q_rows_cap: int,
    k: int, precision: str,
):
    """Compiled fn: top-k over the sharded chunked index — partial
    ``[q_rows_cap, row_cap]`` scores psum'd, then a replicated ``top_k``."""
    prec = _precision(precision)
    sdt = _score_dtype(precision)

    def local(rows2d, cols2d, vals2d, counts,
              q_rows2d, q_cols2d, q_vals2d, q_counts, n_rows):
        n_local = rows2d.shape[0]

        def chunk_body(c, acc):
            slab = _densify_chunk(
                rows2d, cols2d, vals2d, counts, c, row_cap, chunk_dim, sdt
            )
            qslab = _densify_chunk(
                q_rows2d, q_cols2d, q_vals2d, q_counts, c, q_rows_cap,
                chunk_dim, sdt,
            )
            return acc + jax.lax.dot_general(
                qslab, slab,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )

        s = jax.lax.fori_loop(
            0, n_local, chunk_body,
            _varying(jnp.zeros((q_rows_cap, row_cap), jnp.float32), axis),
        )
        s = jax.lax.psum(s, axis)
        s = jax.lax.optimization_barrier(s)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
        s = jnp.where(col_ids < n_rows, s, -jnp.inf)
        top, idx = jax.lax.top_k(s, k)
        return top, idx

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(axis),
            P(axis, None), P(axis, None), P(axis, None), P(axis), P(),
        ),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def mesh_append_entries(mesh: Mesh, axis: str):
    """Compiled donated append: each device keeps the batch entries whose
    global chunk lands in its shard (localized index, OOB-dropped scatter)."""

    def local(rows2d, cols2d, vals2d, coo5):
        # ONE replicated packed [5, ecap] int32 array (chunk / slot / row /
        # local / fp32 value bits) — same H2D-count rationale as
        # ops/chunked.append_entries_packed
        chunk_idx, slot_idx, r, lc = coo5[0], coo5[1], coo5[2], coo5[3]
        v = jax.lax.bitcast_convert_type(coo5[4], jnp.float32)
        n_local = rows2d.shape[0]
        me = jax.lax.axis_index(axis)
        loc = chunk_idx - me * n_local
        # foreign/padding entries -> one past the local end: scatter drops
        loc = jnp.where((loc >= 0) & (loc < n_local), loc, n_local)
        rows2d = rows2d.at[loc, slot_idx].set(r, mode="drop")
        cols2d = cols2d.at[loc, slot_idx].set(lc, mode="drop")
        vals2d = vals2d.at[loc, slot_idx].set(v, mode="drop")
        return rows2d, cols2d, vals2d

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None), P(),
        ),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        check_vma=False,  # outputs are deliberately device-varying
    )
    return jax.jit(fn, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=None)
def mesh_grow_entry_cap(
    mesh: Mesh, axis: str, new_cap: int, pad_row: int
):
    """Compiled capacity-doubling pad, shard-local (no data movement)."""

    def local(rows2d, cols2d, vals2d):
        n_local = rows2d.shape[0]
        nr = jnp.full((n_local, new_cap), pad_row, jnp.int32)
        nc = jnp.zeros((n_local, new_cap), jnp.int32)
        nv = jnp.zeros((n_local, new_cap), jnp.float32)
        return (
            jax.lax.dynamic_update_slice(nr, rows2d, (0, 0)),
            jax.lax.dynamic_update_slice(nc, cols2d, (0, 0)),
            jax.lax.dynamic_update_slice(nv, vals2d, (0, 0)),
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        check_vma=False,
    )
    # donation matters most here: growth happens at the out-of-core engine's
    # peak-HBM moment, and without it each device transiently holds the old
    # AND doubled entry slabs (single-device grow_entry_cap donates too)
    return jax.jit(fn, donate_argnums=(0, 1, 2))
