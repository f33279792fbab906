"""Core device ops: flat-COO index update, tiled matmul scoring with
on-device pair extraction, top-k.  All ingest paths move sparse batches as ONE packed
``[3, ecap]`` int32 COO transfer (``vector.batch.pack_coo_i32``) and densify
on device inside the consuming call.

This is the device replacement for the reference's hot path — the
``querySimilarItems`` posting-list walk (IndexingWorkerActor.scala:74-111)
plus ``calculateSimilarity``'s per-pair HashMap dot product
(CommonUtils.scala:98-117).  Instead of walking ragged posting lists, the
index is a dense ``[row_cap, dim_cap]`` matrix over *compact* columns (see
``index/compact.py``); scoring is a blocked ``X @ Qᵀ`` matmul, and the
thresholded candidate pairs are *compacted on device* (nonzero with a static
capacity) so only ``O(pairs)`` bytes cross the host link.

Notes kept as executable knowledge:
  - A ``lax.optimization_barrier`` sits between each score matmul and its
    2-D mask epilogue (``rows < cols`` from two broadcasted iotas); it keeps
    the mask out of the matmul fusion, for the price of materializing the
    score tile in device memory.
  - Padded/invalid rows are all-zero, so any ``tau_eff > 0`` threshold
    excludes them for free — no validity iota needed in the hot mask.
  - All jits take static shapes only through ``static_argnames``; every
    (row_cap, dim_cap, tile, cap) bucket compiles exactly once.

Overflow contract: extraction returns the TRUE hit count even when it exceeds
``cap`` (writes past the buffer are dropped); callers must retry with a larger
cap when ``count > cap``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "new_index_matrix",
    "grow",
    "allpairs_extract",
    "match_tile_extract",
    "dense_queries_extract",
    "decode_pairs",
    "topk_scores",
    "MIN_TAU_EFF",
    "overflowed",
    "consume_packed",
    "unpack_head",
    "capb_for",
]


def capb_for(cap: int, group: int) -> int:
    """Level-1 group capacity implied by a pair cap.  THE formula: the
    overflow check and every buffer allocation must agree on it — a
    divergent copy would let a group count in the gap pass the check after
    level-1 nonzero already dropped hit groups (silently missing pairs)."""
    return max(cap // group, 1024)


def overflowed(count: int, groups: int, cap: int, group: int) -> bool:
    """True when an extraction call must be retried with a larger cap."""
    return count > cap or groups > capb_for(cap, group)


def grow_caps(caps, counts):
    """Overflow-retry growth for a (pairs, groups, supers) cap triple: the
    next power-of-two bucket covering each level's TRUE count (monotone —
    never shrinks inside a retry loop).  THE growth rule shared by every
    three-level extraction site."""
    from ..vector.batch import pow2_bucket

    return tuple(
        pow2_bucket(max(int(t), int(c)), 1024) for t, c in zip(counts, caps)
    )


def tighten_caps(counts, caps):
    """Steady-state cap tightening with 8× hysteresis: each level's
    nonzero/gather domain scales with its cap, so a one-off spike (or a
    generous config default) would otherwise tax every later call — but a
    shrink recompiles once per shape and an upward tau switch past a
    shrunk cap pays one overflow retry, so only shrink on gross (≥8×)
    oversize.  Counts get +25% headroom.  THE tightening rule shared by
    every three-level extraction site."""
    from ..vector.batch import pow2_bucket

    tight = tuple(
        pow2_bucket(max(int(v) + (int(v) >> 2), 1024), 1024) for v in counts
    )
    return tuple(t if t * 8 <= c else c for t, c in zip(tight, caps))

# floor for the device threshold: keeps all-zero (padded/invalid) rows out of
# the candidate set without any index arithmetic in the matmul epilogue
MIN_TAU_EFF = 1e-30


def _precision(name: str):
    return {
        "default": jax.lax.Precision.DEFAULT,
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
    }[name]


def new_index_matrix(row_cap: int, dim_cap: int, dtype: str = "float32"):
    return jnp.zeros((row_cap, dim_cap), dtype=jnp.dtype(dtype))


@functools.partial(jax.jit, donate_argnums=(0,))
def scatter_entries(x, rows, cols, vals):
    """COO scatter-add of arbitrary (row, col, val) entries into the index
    matrix (dormant-dim activation path; padding entries carry
    ``rows == row_cap`` and are dropped by the out-of-bounds rule)."""
    return x.at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def scatter_coo(x, coo):
    """``scatter_entries`` from ONE packed ``[3, ecap]`` int32 COO array
    (rows / cols / fp32 value bits — ``vector.batch.pack_coo_i32``): one
    H2D transfer instead of three, O(nnz) bytes instead of the padded
    row layout.  Padding rows carry ``row_cap`` and drop out of bounds."""
    rows, cols = coo[0], coo[1]
    vals = jax.lax.bitcast_convert_type(coo[2], jnp.float32)
    return x.at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )


@functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("bs_cap",)
)
def scatter_rows_sliced(x, coo, s0, bs_cap: int):
    """Scatter a CONTIGUOUS row range of entries via a small dense buffer
    + one sliced read-modify-write, instead of an element scatter into the
    full index.  XLA lowers a scatter into a [row_cap, dim_cap] buffer as
    a full-output pass (batch-size independent), so per-micro-batch
    streaming paid an O(index) tax for O(batch) work.  Here the scatter target is
    only ``[bs_cap, dim_cap]`` and the index update is two DMA slices.

    ``coo`` rows are LOCAL to ``s0`` (padding rows carry ``bs_cap`` —
    dropped out of bounds); caller guarantees ``s0 + bs_cap <= row_cap``
    and no duplicate (row, col) entries."""
    rows, cols = coo[0], coo[1]
    vals = jax.lax.bitcast_convert_type(coo[2], jnp.float32)
    dim_cap = x.shape[1]
    dense = jnp.zeros((bs_cap, dim_cap), x.dtype).at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )
    old = jax.lax.dynamic_slice(x, (s0, 0), (bs_cap, dim_cap))
    return jax.lax.dynamic_update_slice(x, old + dense, (s0, 0))


@functools.partial(jax.jit, static_argnames=("row_cap", "dim_cap"))
def grow(x, row_cap: int, dim_cap: int):
    """Copy into a larger zero matrix (capacity-doubling growth)."""
    out = jnp.zeros((row_cap, dim_cap), dtype=x.dtype)
    return jax.lax.dynamic_update_slice(out, x, (0, 0))


def _score_tile(x, q0, tile, precision):
    """One [row_cap, tile] fp32 score tile: X @ X[q0:q0+tile]ᵀ."""
    row_cap, dim_cap = x.shape
    q = jax.lax.dynamic_slice(x, (q0, 0), (tile, dim_cap))
    s = jax.lax.dot_general(
        x, q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_precision(precision),
    )
    # barrier: keep the 2D index mask OUT of the matmul epilogue (see module
    # docstring)
    return jax.lax.optimization_barrier(s)


def _extract(m, q0, buf_i, buf_j, cursor, cap, group):
    """Two-level compaction of a boolean score-tile mask ``m [row_cap, tile]``
    into int32 (row, col) buffers at ``cursor``.

    Level 1 finds hit *row-groups* (``group`` rows each) — shrinking the
    nonzero/cumsum domain ~``group``× versus a flat scan (the flat scan was
    the dominant cost of the whole join: 1.2 s vs 0.15 s of matmul on Enron).
    Level 2 expands only the hit groups' strips.  Writes are contiguous
    ``dynamic_update_slice`` (no scatter); entries past the true count are
    sentinels that the next tile overwrites, exactly like the flat scheme.

    Returns (buf_i, buf_j, cursor', true_hits, true_groups); the caller must
    retry with a larger cap when ``true_hits > cap`` or
    ``true_groups > max(cap // group, 1024)``.
    """
    row_cap, tile = m.shape
    nb = row_cap // group
    capb = capb_for(cap, group)
    m3 = m.reshape(nb, group, tile)
    mb = m3.any(axis=1)  # [nb, tile]
    total = jnp.sum(m, dtype=jnp.int32)
    groups = jnp.sum(mb, dtype=jnp.int32)
    (bflat,) = jnp.nonzero(mb.reshape(-1), size=capb, fill_value=nb * tile)
    bvalid = bflat < nb * tile
    brow = (bflat // tile).astype(jnp.int32)
    bcol = (bflat % tile).astype(jnp.int32)
    strips = m3[brow.clip(0, nb - 1), :, bcol.clip(0, tile - 1)]  # [capb, group]
    strips = strips & bvalid[:, None]
    (f2,) = jnp.nonzero(strips.reshape(-1), size=cap, fill_value=capb * group)
    f2valid = f2 < capb * group
    slot = (f2 // group).clip(0, capb - 1)
    off = (f2 % group).astype(jnp.int32)
    row = jnp.where(f2valid, brow[slot] * group + off, -1)
    col = jnp.where(f2valid, q0 + bcol[slot], -1)
    buf_i = jax.lax.dynamic_update_slice(buf_i, row, (cursor,))
    buf_j = jax.lax.dynamic_update_slice(buf_j, col, (cursor,))
    # SATURATING cursor: a join with > 2^31 total hits must report
    # INT32_MAX (the head is int32), not wrap negative — a wrapped count
    # would pass the overflow check and truncate silently; consume_packed
    # raises a clear error at the saturation point instead.  (int64 is
    # unavailable without x64, so saturate by detecting the wrap: XLA int32
    # addition is two's-complement.)
    summed = cursor + total
    new_cursor = jnp.where(summed < cursor, jnp.int32(2**31 - 1), summed)
    return buf_i, buf_j, new_cursor, total, groups


def decode_pairs(bufs, count: int):
    """Host-side decode: transfer only a power-of-two prefix of the (row,
    col) buffers — the full buffer is MBs, so fetching ``O(count)``
    matters.  Bucketed lengths keep the slice jit count
    bounded."""
    buf_i, buf_j = bufs
    n = int(buf_i.shape[0])
    length = 1024
    while length < count:
        length *= 2
    length = min(length, n)
    return (
        np.asarray(buf_i[:length])[:count].astype(np.int64),
        np.asarray(buf_j[:length])[:count].astype(np.int64),
    )


HEAD = 4096  # max pairs carried inline in the packed result head (streaming)
HEAD_JOIN = 32768  # larger head for batch joins (128 KB ≈ one fetch anyway)


def _pack_head(buf_i, buf_j, total, groups, head: int = HEAD):
    """One int32 array [2*h+2] carrying the first ``h = min(head, len(buf))``
    pairs + counts, so the host learns everything in a single small fetch
    (counts + typical streaming results fit in 32 KB).  The head size is
    recoverable from the packed length, so small extraction caps stay valid."""
    h = min(head, buf_i.shape[0])
    return jnp.concatenate(
        [
            buf_i[:h],
            buf_j[:h],
            total.reshape(1).astype(jnp.int32),
            groups.reshape(1).astype(jnp.int32),
        ]
    )


def consume_packed(bufs, packed: np.ndarray, cap: int, group: int):
    """Shared packed-head consumption: returns ``((rows, cols), 0)`` on
    success or ``(None, needed_cap)`` on overflow.  One small fetch covers
    counts + the typical result; large results spill to a bounded-prefix
    buffer fetch."""
    rows, cols, count, groups = unpack_head(packed)
    if count >= 2**31 - 1:
        raise ValueError(
            "join produced >= 2^31 candidate pairs (saturated counter); "
            "raise the threshold — fetching/rescoring that many pairs is "
            "beyond the engine's design envelope"
        )
    if overflowed(count, groups, cap, group):
        return None, max(count, groups * group)
    if count <= rows.size:
        return (rows, cols), 0
    return decode_pairs(bufs, count), 0


def unpack_head(packed: np.ndarray):
    """(rows_head, cols_head, count, groups) from a fetched packed head."""
    h = (packed.shape[0] - 2) // 2
    count = int(packed[2 * h])
    groups = int(packed[2 * h + 1])
    k = min(count, h)
    return (
        packed[:k].astype(np.int64),
        packed[h : h + k].astype(np.int64),
        count,
        groups,
    )


@functools.partial(
    jax.jit, static_argnames=("tile", "cap", "mode", "precision", "group")
)
def allpairs_extract(
    x, tau_eff, tile: int, cap: int, mode: str = "upper",
    precision: str = "highest", group: int = 8,
):
    """All-pairs join over the whole index in ONE device call.

    Loops row tiles on device (``fori_loop``), scores each against the full
    index, thresholds at ``tau_eff`` and two-level-compacts the
    surviving pairs into fixed-capacity int32 buffers.  Returns
    ``(bufs, packed_head)``; the packed head carries exact counts even on
    overflow — retry with a larger cap when ``overflowed(...)``.

    mode="upper": strict upper triangle (canonical i<j pairs) — the dedup the
    reference approximates with per-query hash maps
    (IndexingWorkerActor.scala:89-91).  Tiles are grouped into ≤16 buckets;
    bucket b scores only the STATIC row prefix its tiles can pair with
    (rows < bucket_end·tile) instead of the full ``row_cap`` rectangle —
    for T tiles this cuts matmul work and extraction domains toward ½ (the
    triangle) while bounding the compiled matmul shapes at the bucket
    count.  This is the float join (int8 off or demoted) and the hot join
    of the dims-sharded mesh path, where the matmul's contracting dim
    is sharded and XLA inserts the psum — halving M halves both FLOPs and
    psum bytes per device.
    mode="all": every thresholded (row, col) including self/symmetric.
    """
    row_cap, dim_cap = x.shape
    if row_cap % tile:
        # a silent floor here would drop the trailing rows as query columns
        # — every pair involving them would vanish from a "lossless" join
        raise ValueError(f"row_cap {row_cap} not a multiple of tile {tile}")
    if tile % group:
        # bucket prefixes are tile multiples; _extract's group reshape
        # needs them divisible by the group height
        raise ValueError(f"tile {tile} not a multiple of group {group}")
    n_tiles = row_cap // tile

    def body_for(prefix):
        # prefix: static row count this bucket's tiles score against
        # (mode="all": the full row_cap rectangle, one bucket)
        def body(t, carry):
            buf_i, buf_j, cursor, max_groups = carry
            q0 = t * tile
            q = jax.lax.dynamic_slice(x, (q0, 0), (tile, dim_cap))
            s = jax.lax.dot_general(
                jax.lax.slice(x, (0, 0), (prefix, dim_cap)), q,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=_precision(precision),
            )
            # barrier: keep the 2D index mask OUT of the matmul epilogue
            # (see module docstring)
            s = jax.lax.optimization_barrier(s)
            m = s >= tau_eff
            if mode == "upper":
                rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
                cols = q0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
                m &= rows < cols
            buf_i, buf_j, cursor, _, groups = _extract(
                m, q0, buf_i, buf_j, cursor, cap, group
            )
            return buf_i, buf_j, cursor, jnp.maximum(max_groups, groups)

        return body

    carry = (
        jnp.full((2 * cap,), -1, jnp.int32),
        jnp.full((2 * cap,), -1, jnp.int32),
        jnp.int32(0),
        jnp.int32(0),
    )
    if mode == "upper":
        n_buckets = min(n_tiles, 16)
        # bucket boundaries in tiles (near-even split, last gets remainder)
        bounds = [n_tiles * b // n_buckets for b in range(n_buckets + 1)]
        for b in range(n_buckets):
            tb0, tb1 = bounds[b], bounds[b + 1]
            if tb0 == tb1:
                continue
            carry = jax.lax.fori_loop(
                tb0, tb1, body_for(tb1 * tile), carry
            )
    else:
        carry = jax.lax.fori_loop(0, n_tiles, body_for(row_cap), carry)
    bi, bj, cursor, max_groups = carry
    return (bi, bj), _pack_head(bi, bj, cursor, max_groups, HEAD_JOIN)


@functools.partial(
    jax.jit, static_argnames=("tile", "cap", "precision", "group")
)
def match_tile_extract(
    x, q0, lo, tau_eff, tile: int, cap: int, precision: str = "highest",
    group: int = 8,
):
    """Streaming-match one query tile ``x[q0:q0+tile]`` against the full
    index: keep (row, col) with ``s >= tau_eff``, ``col >= lo`` (only columns
    belonging to the new batch) and ``row != col`` (no self-pairs).  Both
    directions of an intra-batch pair surface, matching the reference's
    index-before-query emission (SURVEY.md fine-print #2).
    Returns (bufs, packed_head) — see ``_pack_head``/``unpack_head``."""
    row_cap, _ = x.shape
    s = _score_tile(x, q0, tile, precision)
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    cols = q0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    m = (s >= tau_eff) & (rows != cols) & (cols >= lo)
    # single-tile call: cursor is pinned at 0, so a cap-sized buffer holds
    # every valid write (2*cap is only needed when a multi-tile loop advances
    # the cursor — see allpairs_extract)
    buf_i = jnp.full((cap,), -1, jnp.int32)
    buf_j = jnp.full((cap,), -1, jnp.int32)
    buf_i, buf_j, _, total, groups = _extract(
        m, q0, buf_i, buf_j, jnp.int32(0), cap, group
    )
    return (buf_i, buf_j), _pack_head(buf_i, buf_j, total, groups)


@functools.partial(
    jax.jit,
    donate_argnums=(0,),
    static_argnames=("tile", "cap", "bs_cap", "precision", "group"),
)
def insert_match_fused(
    x, coo, s0, q0, lo, tau_eff, tile: int, cap: int, bs_cap: int,
    precision: str = "highest", group: int = 8,
):
    """Fused streaming step: append the batch AND match the covering query
    tile in ONE device call (halves the per-micro-batch host↔device round
    trips, which dominate small-batch insert latency).

    Entries arrive as ONE ``coo`` int32 array of shape ``[3, ecap]``:
    ``coo[0]`` row ids LOCAL to ``s0``, ``coo[1]`` compact cols, ``coo[2]``
    fp32 values bit-viewed as int32 (bitcast back on device).  A single
    array means a single H2D transfer instead of three serialized ones.
    Flat COO keeps H2D at O(batch nnz).  The append itself goes through a
    small ``[bs_cap, dim_cap]`` dense buffer + two DMA slices instead of an
    element scatter into the full index — XLA lowers the full-index scatter
    as an O(index) output pass, batch-size independent, which was most of
    the streaming insert's device time.  Activated dormant entries (older,
    non-contiguous rows) are scattered by the ENGINE in a separate
    preceding dispatch — that dispatch is async, so it adds device time
    only when dormancy actually activates.  Padding entries carry
    ``rows == bs_cap`` (dropped).

    Only valid when the batch lies within one query-tile window
    (``q0 <= row_offset`` and batch end <= ``q0 + tile``); the engine falls
    back to separate calls otherwise.  Returns (x', bufs, packed).
    On extraction overflow the caller must NOT re-run this op (x was donated
    and already updated) — retry with ``match_tile_extract`` instead.
    """
    rows, cols = coo[0], coo[1]
    vals = jax.lax.bitcast_convert_type(coo[2], jnp.float32)
    dim_cap = x.shape[1]
    dense = jnp.zeros((bs_cap, dim_cap), x.dtype).at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )
    old = jax.lax.dynamic_slice(x, (s0, 0), (bs_cap, dim_cap))
    x = jax.lax.dynamic_update_slice(x, old + dense, (s0, 0))
    s = _score_tile(x, q0, tile, precision)
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    cols = q0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    m = (s >= tau_eff) & (rows != cols) & (cols >= lo)
    buf_i = jnp.full((cap,), -1, jnp.int32)  # cursor 0: cap suffices
    buf_j = jnp.full((cap,), -1, jnp.int32)
    buf_i, buf_j, _, total, groups = _extract(
        m, q0, buf_i, buf_j, jnp.int32(0), cap, group
    )
    return x, (buf_i, buf_j), _pack_head(buf_i, buf_j, total, groups)


@functools.partial(
    jax.jit, static_argnames=("q_rows", "cap", "precision", "group")
)
def queries_match_fused(
    x, coo, tau_eff, q_rows: int, cap: int, precision: str = "highest",
    group: int = 8,
):
    """Fused frozen-index match: densify the query batch ON DEVICE from one
    flat COO transfer and score it — one H2D + one dispatch instead of the
    densify-then-score pair (each dispatch is its own round trip), and the
    COO is O(batch nnz) where the padded layout paid
    for the longest document on every row.  ``coo`` is int32 [3, ecap]:
    local query rows / compact cols / fp32 value bits (padding rows carry
    ``q_rows``, dropped by the out-of-bounds scatter rule).  Same
    (bufs, packed_head) contract as ``dense_queries_extract``."""
    rows, cols = coo[0], coo[1]
    vals = jax.lax.bitcast_convert_type(coo[2], jnp.float32)
    q = jnp.zeros((q_rows, x.shape[1]), x.dtype).at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )
    s = jax.lax.dot_general(
        x, q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_precision(precision),
    )
    s = jax.lax.optimization_barrier(s)
    m = s >= tau_eff
    buf_i = jnp.full((cap,), -1, jnp.int32)  # cursor 0: cap suffices
    buf_j = jnp.full((cap,), -1, jnp.int32)
    buf_i, buf_j, _, total, groups = _extract(
        m, jnp.int32(0), buf_i, buf_j, jnp.int32(0), cap, group
    )
    return (buf_i, buf_j), _pack_head(buf_i, buf_j, total, groups)


@functools.partial(jax.jit, static_argnames=("cap", "precision", "group"))
def dense_queries_extract(
    x, q, tau_eff, cap: int, precision: str = "highest", group: int = 8
):
    """Score externally-supplied dense query rows ``q [T, dim_cap]`` (NOT part
    of the index — the frozen-index benchmark path) and compact hits.
    Returns (bufs, packed_head); decoded pairs are (index_row, query_col)."""
    s = jax.lax.dot_general(
        x, q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_precision(precision),
    )
    s = jax.lax.optimization_barrier(s)
    m = s >= tau_eff
    buf_i = jnp.full((cap,), -1, jnp.int32)  # cursor 0: cap suffices
    buf_j = jnp.full((cap,), -1, jnp.int32)
    buf_i, buf_j, _, total, groups = _extract(
        m, jnp.int32(0), buf_i, buf_j, jnp.int32(0), cap, group
    )
    return (buf_i, buf_j), _pack_head(buf_i, buf_j, total, groups)


@functools.partial(
    jax.jit, static_argnames=("q_rows", "k", "precision")
)
def topk_scores_fused(
    x, coo, n_rows, q_rows: int, k: int, precision: str = "highest"
):
    """``topk_scores`` with the query densify fused in (one flat-COO H2D +
    one dispatch — same contract as ``queries_match_fused``)."""
    rows, cols = coo[0], coo[1]
    vals = jax.lax.bitcast_convert_type(coo[2], jnp.float32)
    q = jnp.zeros((q_rows, x.shape[1]), x.dtype).at[rows, cols].add(
        vals.astype(x.dtype), mode="drop", unique_indices=True
    )
    return topk_scores(x, q, n_rows, k, precision)


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def topk_scores(x, q, n_rows, k: int, precision: str = "highest"):
    """Top-k cosine neighbors per dense query row: (scores [T, k],
    row indices [T, k]); rows past ``n_rows`` masked to -inf."""
    s = jax.lax.dot_general(
        q, x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_precision(precision),
    )  # [T, row_cap]
    row_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    s = jnp.where(row_ids < n_rows, s, -jnp.inf)
    return jax.lax.top_k(s, k)
