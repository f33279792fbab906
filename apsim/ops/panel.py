"""int8 panel scoring: the join's hot op, for the dense and out-of-core engines.

Per-row symmetric quantization ``x_i = α_i (q_i + e_i)``, ``α_i =
max|x_i|/127``, ``q`` int8, ``|e| ≤ 0.5`` and ``e = 0`` off-support.  The
device computes ``D = Σ q_i q_j`` as an EXACT int8 × int8 → int32 dot and
the epilogue admits a pair when the dequantized score plus a PER-PAIR
quantization-error upper bound reaches ``tau_eff``:

  |x_i·x_j − α_iα_j D| ≤ 0.5(α_j b_i + α_i b_j) + 0.25 α_iα_j min(n_i, n_j)

with ``b_i = α_i L1(q_i)`` and ``n_i = nnz(x_i)`` — so the candidates form a
PROVEN superset and the host fp64 rescore keeps the emitted pair set exact.
int32 accumulator safety: ``D ≤ 127·min(L1(q_i), L1(q_j)) ≤ 127²·max_nnz``,
so the engines gate this path on ``max_nnz < 2^30/127² ≈ 66k``.

The unit of work is a PANEL PAIR: two row panels ``xi [m, d]``, ``xj [n, d]``
scored as one plain ``lax.dot_general`` (cuBLAS's int8 GEMM on the GPU) into
an int32 rectangle, then the bound mask and the bit-packed hit structure
(``ops/bits.py``) over that rectangle as ONE block.  Panels keep the int32
rectangle bounded (``m·n·4`` bytes), so an index of any height is scored
panel pair by panel pair:

  - the dense engine's join (``allpairs_extract_int8``) maps over the
    upper-triangle panel pairs of its resident int8 copy in one program;
  - the out-of-core engine densifies each row panel from a row-sorted COO
    (``sort_entries_by_row`` + ``build_panel_slab``) and scores panel pairs
    one device call at a time (``panel_pair_extract_int8``);
  - the mesh engines run the same epilogue under ``shard_map``
    (``ops/mesh_rows.py``, ``ops/panel_mesh.py``).

Replaces the hot loop of the reference's IndexingWorkerActor.scala:74-111.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .bits import (
    _compact_bits, _sat_count_sum, bits_and_counts, bitpack_mask, check_tiles,
)

__all__ = [
    "quantize_rows",
    "int8_bound_mask",
    "int8_dot",
    "pair_bits",
    "panel_score_bits_int8_ref",
    "panel_pair_extract_int8",
    "panel_pairs_bits",
    "allpairs_extract_int8",
    "panel_rows_for",
    "upper_panel_pairs",
    "sort_entries_by_row",
    "build_panel_slab",
]


@jax.jit
def quantize_rows(x):
    """(q int8, aux f32 [3, rows]): per-row symmetric int8 quantization with
    the bound ingredients (aux rows: α, α·L1(q), nnz).

    All-zero (padded/invalid) rows get α = 0, which zeroes BOTH their
    rescaled score and their error bound — the epilogue's
    ``s_hat + bound >= tau_eff`` test then excludes them.  (With an α = 1
    fallback a padded row's bound would be ``0.5·α_j·L1(q_j)`` ≈ the
    partner row's L1 ≫ tau, so every padded×real pair would leak through as
    a "candidate" and its out-of-range row id would crash the host
    rescore.)"""
    ax = jnp.abs(x)
    s = jnp.max(ax, axis=1)
    alpha = jnp.where(s > 0, s / 127.0, 0.0).astype(jnp.float32)
    div = jnp.where(s > 0, alpha, 1.0)
    q = jnp.clip(
        jnp.round(x / div[:, None]), -127, 127
    ).astype(jnp.int8)
    l1q = jnp.sum(jnp.abs(q).astype(jnp.float32), axis=1)
    nnz = jnp.sum((x != 0).astype(jnp.float32), axis=1)
    aux = jnp.stack([alpha, alpha * l1q, nnz])
    return q, aux


def int8_bound_mask(d, auxi, auxj, rows, cols, tau_eff):
    """Quantization-bound admit mask over one int32 score rectangle.

    ``d`` is the raw int8-dot rectangle, ``auxi``/``auxj`` the per-row
    (α, α·L1(q), nnz) tables of its two sides (``[3, m]`` / ``[3, n]``),
    ``rows``/``cols`` the GLOBAL coordinates of each cell (any shapes that
    broadcast to ``d``'s).  Admits exactly the cells whose dequantized score
    plus the proven per-pair error bound reaches ``tau_eff``, restricted to
    the strict upper triangle.

    This is THE definition of the bound epilogue: the single-device panel
    scorer, the mesh panel pair and the int8 stripes all call it, so a bound
    or margin change cannot silently diverge between deployments."""
    ai = auxi[0][:, None]    # α_i  [m, 1]
    bi_b = auxi[1][:, None]  # α_i·L1(q_i)
    ci = auxi[2][:, None]    # nnz_i
    aj = auxj[0][None, :]
    bj_b = auxj[1][None, :]
    cj = auxj[2][None, :]
    s_hat = d.astype(jnp.float32) * (ai * aj)
    bound = (
        0.5 * (aj * bi_b + ai * bj_b)
        + 0.25 * (ai * aj) * jnp.minimum(ci, cj)
    )
    return ((s_hat + bound) >= tau_eff) & (rows < cols)


def int8_dot(xi, xj):
    """``xi [m, d] · xj [n, d]ᵀ`` as an exact int8 × int8 → int32 product."""
    return jax.lax.dot_general(
        xi, xj,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def pair_bits(d, auxi, auxj, row0, col0, tau_eff, valid=1):
    """Bound mask + bit-pack over one int32 score rectangle ``d [m, n]``
    whose cells sit at global rows ``row0 + i`` and columns ``col0 + j``:
    ``(gb [1, m/8, n], g64 [1, m/64, n], cnt [1, 3])`` — the whole
    rectangle as ONE block.  ``valid = 0`` blanks it (padding pairs)."""
    m, n = d.shape
    rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    cols = col0 + jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    mi = int8_bound_mask(d, auxi, auxj, rows, cols, tau_eff).astype(
        jnp.int32
    ) * valid
    gb, g64, cnt = bits_and_counts(mi)
    return gb[None], g64[None], cnt[None]


def panel_score_bits_int8_ref(
    xi, xj, auxi, auxj, bi, bj, off, tau_eff, tm: int, tn: int,
):
    """Plain reference of the scorer in per-block form: ``(gb, g64, cnt)``
    for the ``(bi[p], bj[p])`` tiles (``tm × tn``) of one panel pair at
    global offset ``off = [row0, col0]``.  One int8 dot over the whole pair,
    one bit-pack, then the scheduled blocks are gathered from the packed
    bytes.  With ``tm, tn`` equal to the panel sizes and a one-entry
    schedule it computes what ``pair_bits`` does; the GPU tests hold the
    compiled scorer to it on the CPU backend."""
    m, n = xi.shape[0], xj.shape[0]
    check_tiles(m, n, xi.shape[1], tm, tn, 1)
    rows = off[0] + jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    cols = off[1] + jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    mi = int8_bound_mask(
        int8_dot(xi, xj), auxi, auxj, rows, cols, tau_eff
    ).astype(jnp.int32)
    gbi, g_any, g64i = bitpack_mask(mi)

    def blocks(a, h):
        return a.reshape(m // tm, h, n // tn, tn)[bi, :, bj, :]

    def counts(a, h):
        return _sat_count_sum(
            a.reshape(m // tm, h, n // tn, tn), axis=(1, 3)
        )[bi, bj]

    gb = blocks(gbi.astype(jnp.uint8), tm // 8)
    g64 = blocks(g64i.astype(jnp.uint8), tm // 64)
    cnt = jnp.stack(
        [counts(mi, tm), counts(g_any, tm // 8), counts(g64i, tm // 64)],
        axis=1,
    )
    return gb, g64, cnt


@functools.partial(
    jax.jit, static_argnames=("cap", "capb", "cap0", "pack_head"),
)
def panel_pair_extract_int8(
    xi, xj, auxi, auxj, row0, col0, tau_eff,
    cap: int, capb: int, cap0: int, pack_head: bool = False,
):
    """One panel pair end to end: int8 dot, bound epilogue and three-level
    compaction.  ``row0``/``col0`` are the panels' global row origins
    (multiples of the panel heights), so the emitted (row, col) pairs are
    global.  Returns ``((rows, cols), packed_head)`` (``bits.unpack_head``
    layout)."""
    m, n = xi.shape[0], xj.shape[0]
    gb, g64, cnt = pair_bits(int8_dot(xi, xj), auxi, auxj, row0, col0,
                             tau_eff)
    bi = (row0 // m).astype(jnp.int32)[None]
    bj = (col0 // n).astype(jnp.int32)[None]
    return _compact_bits(gb, g64, cnt, bi, bj, cap, capb, cap0, m, n,
                         pack_head)


def panel_rows_for(row_cap: int, max_rows: int) -> int:
    """Panel height for a dense index: the largest divisor of ``row_cap``
    that is at most ``max_rows`` and a multiple of 64 (the bit-pack's super
    granularity).  ``row_cap`` must be a multiple of 64."""
    k = -(-row_cap // max_rows)
    while row_cap % k or (row_cap // k) % 64:
        k += 1
    return row_cap // k


def upper_panel_pairs(n_panels: int) -> tuple[np.ndarray, np.ndarray]:
    """(I, J) panel indices with I ≤ J, row-major."""
    pi, pj = np.triu_indices(n_panels)
    return pi.astype(np.int32), pj.astype(np.int32)


def panel_pairs_bits(xq, aux, pi, pj, valid, tau_eff, rb: int):
    """``lax.map`` over the panel pairs ``(pi[p], pj[p])`` of height ``rb``
    of one int8 matrix ``xq [rows, d]``: each pair is one int8 dot +
    ``pair_bits``, stacked into per-pair blocks (``tm = tn = rb``).  The
    int32 rectangle in flight is ``rb² · 4`` bytes."""
    d = xq.shape[1]

    def one(ijv):
        i, j, v = ijv
        xi = jax.lax.dynamic_slice(xq, (i * rb, 0), (rb, d))
        xj = jax.lax.dynamic_slice(xq, (j * rb, 0), (rb, d))
        ai = jax.lax.dynamic_slice(aux, (0, i * rb), (3, rb))
        aj = jax.lax.dynamic_slice(aux, (0, j * rb), (3, rb))
        gb, g64, cnt = pair_bits(int8_dot(xi, xj), ai, aj, i * rb, j * rb,
                                 tau_eff, v)
        return gb[0], g64[0], cnt[0]

    return jax.lax.map(one, (pi, pj, valid))


@functools.partial(
    jax.jit,
    static_argnames=("rb", "cap", "capb", "cap0", "pack_head"),
)
def allpairs_extract_int8(
    xq, aux, pi, pj, tau_eff, rb: int,
    cap: int, capb: int, cap0: int, pack_head: bool = False,
):
    """Upper-triangle join of a dense int8 index ``xq [row_cap, d]`` over
    its panel pairs ``I ≤ J`` (``upper_panel_pairs``), then one three-level
    compaction over all pairs.  Only the diagonal pairs score their lower
    half for nothing."""
    check_tiles(xq.shape[0], xq.shape[0], xq.shape[1], rb, rb, 1)
    valid = jnp.ones(pi.shape, jnp.int32)
    gb, g64, cnt = panel_pairs_bits(xq, aux, pi, pj, valid, tau_eff, rb)
    return _compact_bits(gb, g64, cnt, pi, pj, cap, capb, cap0, rb, rb,
                         pack_head)


@functools.partial(jax.jit, static_argnames=("rb", "n_panels"))
def sort_entries_by_row(rows2d, cols2d, q2d, counts, rb: int, n_panels: int):
    """Row-sorted flat COO from the per-chunk entry buffers.

    Returns ``(rows_s, gcols_s, q_s, panel_counts)``: entries sorted by
    global row (padding slots carry row = 2^30 and sort to the tail),
    columns mapped back from (chunk, local) to GLOBAL compact ids
    (``global = local · n_chunks + chunk`` — the interleaved assignment of
    ``chunked.split_chunks`` inverted), values int8-quantized, and the
    int32 per-panel entry counts (tail bucket = padding).
    """
    n_chunks, cap = rows2d.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (n_chunks, cap), 1)
    valid = pos < counts[:, None]
    r = jnp.where(valid, rows2d, 1 << 30).reshape(-1)
    chunk_of = jax.lax.broadcasted_iota(jnp.int32, (n_chunks, cap), 0)
    gc = (cols2d * n_chunks + chunk_of).reshape(-1)
    order = jnp.argsort(r)
    r_s = r[order]
    gc_s = gc[order]
    q_s = q2d.reshape(-1)[order]
    pan = jnp.minimum(r_s // rb, n_panels).astype(jnp.int32)
    pcounts = jnp.zeros((n_panels + 1,), jnp.int32).at[pan].add(1)
    return r_s, gc_s, q_s, pcounts


@functools.partial(jax.jit, static_argnames=("rb", "d_cap", "p_cap"))
def build_panel_slab(r_s, gc_s, q_s, start, row0, rb: int, d_cap: int,
                     p_cap: int):
    """Densify one row panel: int8 slab ``[rb, d_cap]`` from the sorted COO
    slice at ``start``.  Membership is decided by ROW RANGE, not slice
    position, so ``dynamic_slice``'s start-clamping near the array tail is
    harmless (the clamped window still contains the whole panel slice, and
    out-of-range rows scatter-drop)."""
    r = jax.lax.dynamic_slice(r_s, (start,), (p_cap,))
    g = jax.lax.dynamic_slice(gc_s, (start,), (p_cap,))
    q = jax.lax.dynamic_slice(q_s, (start,), (p_cap,))
    ok = (r >= row0) & (r < row0 + rb)
    rl = jnp.where(ok, r - row0, rb)  # OOB row -> dropped by the scatter
    g = jnp.where(ok, g, 0)
    q = jnp.where(ok, q, 0)
    slab = jnp.zeros((rb, d_cap), jnp.int8)
    return slab.at[rl, g].set(q, mode="drop", unique_indices=True)
