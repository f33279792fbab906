"""Bit-packed hit structure shared by every thresholded join epilogue.

A scoring pass (the int8 panel scorer in ``ops/panel.py``, the chunked
stripe and streaming-match epilogues in ``ops/chunked.py``) turns its 0/1
hit mask into three per-block outputs:

  gb   [n_blocks, TM/8, TN]  uint8 — bit-packed hits: byte (g, c) holds the
                                     8 rows of group g at column c (bit o =
                                     row g*8+o)
  g64  [n_blocks, TM/64, TN] uint8 — super-group (64-row) any-hit, the
                                     level-0 structure for compaction
  cnt  [n_blocks, 3]         int32 — (pairs, hit groups, hit super-groups)
                                     of the block, so exact totals cost no
                                     extra device pass

``_compact_bits`` then runs a THREE-level compaction (supers → group bytes →
bits) whose ``jnp.nonzero`` domains are sized by the *previous* level's cap
instead of the raw mask: the largest domain is ``n_blocks·TM/64·TN`` (or
8× smaller with the 512-row pre-level), and the deeper levels scale with
the candidate caps, not the corpus.

Each level has its own capacity (cap0 ≥ #hit supers, capb ≥ #hit groups,
cap ≥ #pairs); the packed head returns all three true counts so the caller
can retry with exact sizes (and cache them across calls).

Replaces the reference's querySimilarItems posting walk + per-pair HashMap
dot (IndexingWorkerActor.scala:74-111, CommonUtils.scala:98-117).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "check_tiles",
    "bitpack_mask",
    "bits_and_counts",
    "unpack_head",
    "GROUP",
    "SUPER",
]

GROUP = 8  # rows per bit-packed byte (fixed: the uint8 width)
SUPER = 64  # rows per level-0 super-group (8 group bytes)
SUPER2 = 512  # rows per pre-level cell (reduced from g64 at compaction
              # time — not a scorer output; see _compact_bits)

HEAD_PAIRS = 32768  # pairs carried inline in the packed head (one fetch)


def check_tiles(rows_i: int, rows_j: int, dim: int, tm: int, tn: int,
                tk: int) -> None:
    """Reject silently-floored block grids.  A grid computes ``rows // tm``
    etc., so a non-multiple operand would silently drop the trailing
    rows/columns from a "lossless" join (score.py raises for the analogous
    ``row_cap % tile`` case; the engine's geometry pickers always pass
    aligned shapes — this guards every OTHER caller)."""
    if rows_i % tm or rows_j % tn or dim % tk:
        raise ValueError(
            f"kernel tiles must divide operands exactly: "
            f"rows {rows_i} % tm {tm}, cols {rows_j} % tn {tn}, "
            f"dim {dim} % tk {tk}"
        )


def bitpack_mask(mi):
    """Shared bit-pack hierarchy over an int32 0/1 hit mask ``mi [tm, tn]``:
    returns ``(gbi, g_any, g64i)`` — group bytes (bit o = row g·GROUP+o),
    group any-hit, and 64-row super any-hit, all int32.  Every scoring
    epilogue calls this, so the packing layout has one definition."""
    tm, tn = mi.shape
    w = jnp.left_shift(
        1,
        jax.lax.broadcasted_iota(jnp.int32, (tm // GROUP, GROUP, tn), 1),
    )
    gbi = jnp.sum(mi.reshape(tm // GROUP, GROUP, tn) * w, axis=1)
    g_any = jnp.minimum(gbi, 1)
    g64i = jnp.minimum(
        jnp.sum(g_any.reshape(tm // SUPER, SUPER // GROUP, tn), axis=1), 1
    )
    return gbi, g_any, g64i


def _sat_count_sum(v, axis=None):
    """Saturating int32 sum of hit counts.  A plain jnp.sum wraps past 2^31
    (a 131k-row low-tau join can total 2^34), and a wrapped NEGATIVE total
    passes the caller's overflow check and silently truncates the result —
    the same bug class score.py's cursor saturation guards against.  The
    fp32 shadow sum is only used as a > 2^30 detector (its ~1e-7 relative
    error is far below the 2x headroom to the wrap point), so totals ≤ 2^30
    stay exact."""
    exact = jnp.sum(v, axis=axis, dtype=jnp.int32)
    approx = jnp.sum(v.astype(jnp.float32), axis=axis)
    return jnp.where(
        approx > jnp.float32(2**30), jnp.int32(2**31 - 1), exact
    )


def bits_and_counts(mi):
    """One block's ``(gb, g64, cnt)`` from an int32 0/1 hit mask: the packed
    bytes as uint8 and the saturating (pairs, groups, supers) counts."""
    gbi, g_any, g64i = bitpack_mask(mi)
    cnt = jnp.stack([
        _sat_count_sum(mi), _sat_count_sum(g_any), _sat_count_sum(g64i)
    ])
    return gbi.astype(jnp.uint8), g64i.astype(jnp.uint8), cnt


def _pack_head(row, col, total, groups, supers, pack_u32: bool):
    """Result head: first h pairs + (total, groups, supers) counts.

    ``pack_u32=True`` (any corpus with row_cap ≤ 65536) packs each pair
    into ONE int32 as ``row << 16 | col``, halving the head bytes of the
    one blocking device-to-host fetch.  The trailing flag word records the
    layout so the host can decode either format."""
    h = min(HEAD_PAIRS, row.shape[0])
    tail = [
        total.reshape(1).astype(jnp.int32),
        groups.reshape(1).astype(jnp.int32),
        supers.reshape(1).astype(jnp.int32),
        jnp.full((1,), int(pack_u32), jnp.int32),
    ]
    if pack_u32:
        # sentinel (-1, -1) slots become 0xFFFFFFFF -> decoded as (65535,
        # 65535), but decode only reads the first `total` slots anyway
        packed = jnp.left_shift(row[:h], 16) | (col[:h] & 0xFFFF)
        return jnp.concatenate([packed] + tail)
    return jnp.concatenate([row[:h], col[:h]] + tail)


def unpack_head(packed: np.ndarray):
    """(rows_head, cols_head, total, groups, supers) from a fetched head;
    the layout flag in the last word selects u32-packed vs two-array."""
    total = int(packed[-4])
    if total >= 2**31 - 1:
        raise ValueError(
            "join produced >= 2^31 candidate pairs (saturated counter); "
            "raise the threshold — fetching/rescoring that many pairs is "
            "beyond the engine's design envelope"
        )
    groups = int(packed[-3])
    supers = int(packed[-2])
    if int(packed[-1]):  # u32-packed pairs
        h = packed.shape[0] - 4
        k = min(total, h)
        u = packed[:k].view(np.uint32)
        return (
            (u >> 16).astype(np.int64),
            (u & 0xFFFF).astype(np.int64),
            total,
            groups,
            supers,
        )
    h = (packed.shape[0] - 4) // 2
    k = min(total, h)
    return (
        packed[:k].astype(np.int64),
        packed[h : h + k].astype(np.int64),
        total,
        groups,
        supers,
    )


def _compact_bits(gb, g64, cnt, bi, bj, cap, capb, cap0, tm, tn,
                  pack_head: bool = False):
    """Three-level compaction of per-block ``(gb, g64, cnt)`` into global
    ``((row, col), packed_head)``; block p covers rows ``bi[p]·tm`` and
    columns ``bj[p]·tn`` onward.  Overflow contract: the head carries the
    TRUE (pairs, groups, supers) counts; the caller retries with larger
    caps when any exceeds its capacity (entries past a cap are dropped,
    counts stay exact)."""
    n_blocks = bi.shape[0]
    total = _sat_count_sum(cnt[:, 0])
    groups = _sat_count_sum(cnt[:, 1])
    supers = _sat_count_sum(cnt[:, 2])
    # ---- level 0: hit super-groups (64 rows) over the whole structure
    per0 = (tm // SUPER) * tn
    if (tm // SUPER) % (SUPER2 // SUPER) == 0:
        # pre-level: reduce g64 to 512-row any-hit cells first.  The
        # reduce is bandwidth-cheap (one pass over g64), while jnp.nonzero
        # is a full scan of its domain — so scanning the 8× smaller g512
        # domain and gathering the g64 bytes under its hits (≤ cap0 of
        # them: hit-512s ≤ hit supers, so cap0 bounds both and the overflow
        # contract is unchanged) removes the largest corpus-sized scan.
        r8 = SUPER2 // SUPER
        per00 = (tm // SUPER2) * tn
        g512 = jnp.max(
            g64.reshape(n_blocks, tm // SUPER2, r8, tn), axis=2
        )
        (b00,) = jnp.nonzero(
            (g512 != 0).reshape(-1), size=cap0,
            fill_value=n_blocks * per00,
        )
        v00 = b00 < n_blocks * per00
        b00c = jnp.where(v00, b00, 0)
        p00 = (b00c // per00).astype(jnp.int32)
        rem00 = b00c % per00
        s00 = (rem00 // tn).astype(jnp.int32)
        c00 = (rem00 % tn).astype(jnp.int32)
        bytes00 = g64.reshape(n_blocks, tm // SUPER2, r8, tn)[
            p00, s00, :, c00
        ]  # [cap0, r8]
        bytes00 = jnp.where(v00[:, None], bytes00, 0)
        (f0,) = jnp.nonzero(
            (bytes00 != 0).reshape(-1), size=cap0, fill_value=cap0 * r8
        )
        v0 = f0 < cap0 * r8
        f0c = jnp.where(v0, f0, 0)
        slot00 = (f0c // r8).astype(jnp.int32)
        o00 = (f0c % r8).astype(jnp.int32)
        p0 = p00[slot00]
        s0 = s00[slot00] * r8 + o00  # super index within block
        c0 = c00[slot00]  # column within block
    else:
        (b0,) = jnp.nonzero(
            (g64 != 0).reshape(-1), size=cap0, fill_value=n_blocks * per0
        )
        v0 = b0 < n_blocks * per0
        b0c = jnp.where(v0, b0, 0)
        p0 = (b0c // per0).astype(jnp.int32)
        rem0 = b0c % per0
        s0 = (rem0 // tn).astype(jnp.int32)  # super index within block
        c0 = (rem0 % tn).astype(jnp.int32)  # column within block
    # ---- level 1: hit group bytes within each hit super (8 bytes each)
    gb4 = gb.reshape(n_blocks, tm // SUPER, SUPER // GROUP, tn)
    bytes0 = gb4[p0, s0, :, c0]  # [cap0, 8] uint8
    bytes0 = jnp.where(v0[:, None], bytes0, 0)
    (f1,) = jnp.nonzero(
        (bytes0 != 0).reshape(-1), size=capb,
        fill_value=cap0 * (SUPER // GROUP),
    )
    v1 = f1 < cap0 * (SUPER // GROUP)
    f1c = jnp.where(v1, f1, 0)
    slot1 = (f1c // (SUPER // GROUP)).astype(jnp.int32)
    o1 = (f1c % (SUPER // GROUP)).astype(jnp.int32)
    byte1 = bytes0.reshape(-1)[f1c].astype(jnp.int32)
    byte1 = jnp.where(v1, byte1, 0)
    # ---- level 2: hit bits (rows) within each hit group byte
    bits = (byte1[:, None] >> jnp.arange(GROUP, dtype=jnp.int32)[None, :]) & 1
    (f2,) = jnp.nonzero(
        bits.reshape(-1) != 0, size=cap, fill_value=capb * GROUP
    )
    v2 = f2 < capb * GROUP
    f2c = jnp.where(v2, f2, 0)
    slot2 = (f2c // GROUP).astype(jnp.int32)
    o2 = (f2c % GROUP).astype(jnp.int32)
    sl = slot1[slot2]
    g = s0[sl] * (SUPER // GROUP) + o1[slot2]  # group index within block
    P = p0[sl]
    row = bi[P] * tm + g * GROUP + o2
    col = bj[P] * tn + c0[sl]
    row = jnp.where(v2, row, -1).astype(jnp.int32)
    col = jnp.where(v2, col, -1).astype(jnp.int32)
    return (row, col), _pack_head(
        row, col, total, groups, supers, pack_head
    )
