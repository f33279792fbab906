"""Chunked-sparse scoring: exact joins without a resident dense index.

The dense engine materializes ``X [rows, dim_cap]`` (HBM ceiling ≈ 130k rows
at Enron-like vocabularies).  This mode keeps the index as per-chunk COO
entry buffers and densifies ONE ``[row_cap, C]`` slab at a time:

    S_super = Σ_c  slab_c @ slab_c[q0:q0+super]ᵀ

Memory: ``O(nnz + rows·C + rows·super)`` — a few GB at 1M rows — instead of
``O(rows · dims)``.

Device layout (round 2, streaming-capable): entries live in 2-D per-chunk
buffers ``rows/cols/vals [n_chunks, chunk_cap]`` with a device count vector
``counts [n_chunks]`` — the WriteWorker buffer analog
(WriteWorkerActor.scala:185-202) as fixed-capacity device arrays.  Appends
are one donated scatter at ``(chunk, counts[chunk] + i)``; capacity doubles
(one pad-copy) when any chunk fills.  Entries within a chunk are unordered —
the slab scatter-add is order-independent — so appends never re-sort.

Structure notes (learned on hardware):
  - the tile loop lives on the HOST; each device call handles one
    ``super``-wide query stripe with an internal ``fori`` over chunks, so
    per-stripe programs stay small and stable instead of one giant fused
    program with both loops (tiles × chunks) nested.
  - ``super`` ≫ tile amortizes the per-chunk slab scatter (the dominant cost)
    over more query columns.

Chunk assignment interleaves frequency-ranked compact dims
(``chunk = col % n_chunks``, ``local = col // n_chunks``) so chunk loads are
balanced and the static per-chunk entry capacity wastes little.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .score import HEAD_JOIN, _extract, _pack_head, _precision

__all__ = [
    "bucket_entries",
    "bucket_split_entries",
    "append_entries_packed",
    "grow_entry_cap",
    "chunked_stripe_extract",
    "chunked_match_extract",
    "chunked_match_extract_bits",
    "cached_match_extract_bits",
    "match_epilogue_bits",
    "build_match_slabs",
    "append_match_slabs_packed",
    "cached_topk",
    "chunked_topk",
    "join_epilogue_bits",
    "match_epilogue",
]


def split_chunks(cols: np.ndarray, n_chunks: int):
    """(chunk, local) of compact columns — interleaved assignment.

    Kept in the input's integer dtype: fresh int64 copies of 100M+-entry
    arrays are page-fault-bound (~0.5 s per 176 MB temporary at 22M
    entries), and every consumer (bincount, jnp indices) takes int32."""
    cols = np.asarray(cols)
    return cols % n_chunks, cols // n_chunks


def bucket_entries(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_chunks: int,
    chunk_cap: int, pad_row: int,
):
    """Host-side: bucket COO entries into per-chunk 2-D buffers.

    Returns ``(rows2d, cols2d, vals2d, counts)`` with shapes
    ``[n_chunks, chunk_cap]`` / ``[n_chunks]``; unused slots carry
    ``row == pad_row`` (out-of-bounds ⇒ the slab scatter drops them).
    Entries land contiguously in slots ``[0, counts[c])`` preserving input
    order (the panel densifier's ``pos < counts`` validity mask and the
    append path's slot cursor both rely on front-contiguity).

    One boolean scan + gather per chunk beats the former
    stable-argsort + fancy-scatter (4.1x at 22M entries: no O(n log n)
    sort, no int64 temporaries, sequential writes per chunk row)."""
    chunk, local = split_chunks(cols, n_chunks)
    counts = np.bincount(chunk, minlength=n_chunks).astype(np.int64)
    return bucket_split_entries(
        rows, chunk, local, vals, counts, chunk_cap, pad_row
    )


def bucket_split_entries(
    rows: np.ndarray, chunk: np.ndarray, local: np.ndarray,
    vals: np.ndarray, counts: np.ndarray, chunk_cap: int, pad_row: int,
):
    """``bucket_entries`` with the (chunk, local, counts) split precomputed
    — callers that size ``chunk_cap`` from the counts reuse the same pass."""
    n_chunks = counts.size
    rows = np.asarray(rows)
    vals = np.asarray(vals)
    if counts.size and int(counts.max()) > chunk_cap:
        raise ValueError("chunk_cap too small")
    rows2d = np.full((n_chunks, chunk_cap), pad_row, np.int32)
    cols2d = np.zeros((n_chunks, chunk_cap), np.int32)
    vals2d = np.zeros((n_chunks, chunk_cap), np.float32)
    for c in range(n_chunks):
        sel = np.flatnonzero(chunk == c)
        k = sel.size
        rows2d[c, :k] = rows[sel]
        cols2d[c, :k] = local[sel]
        vals2d[c, :k] = vals[sel]
    return rows2d, cols2d, vals2d, counts


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def append_entries_packed(rows2d, cols2d, vals2d, coo5):
    """Donated scatter-append of new entries at (chunk, slot) from ONE
    packed ``[5, ecap]`` int32 array — rows: chunk / slot / global row /
    local col / fp32 value bits.  One H2D transfer instead of five (each
    separate ``jnp.asarray`` is its own serialized round trip).  Padding entries carry
    ``chunk == n_chunks`` and are dropped."""
    chunk_idx, slot_idx, r, lc = coo5[0], coo5[1], coo5[2], coo5[3]
    v = jax.lax.bitcast_convert_type(coo5[4], jnp.float32)
    rows2d = rows2d.at[chunk_idx, slot_idx].set(r, mode="drop")
    cols2d = cols2d.at[chunk_idx, slot_idx].set(lc, mode="drop")
    vals2d = vals2d.at[chunk_idx, slot_idx].set(v, mode="drop")
    return rows2d, cols2d, vals2d


@functools.partial(jax.jit, donate_argnums=(0,))
def append_match_slabs_packed(mslab, coo5):
    """Incremental resident-slab update fed by the same packed array as
    ``append_entries_packed`` (slot row unused here): scatter-set the
    batch's (chunk, row, local-col, value) entries (donated, in-place).
    Padding entries carry ``chunk == n_chunks`` and drop via the
    out-of-bounds rule — the same contract as the entry-buffer append, so
    the two structures stay bit-consistent (fp32→slab-dtype rounding is
    identical to ``_densify_chunk``'s)."""
    chunk_idx, r, lc = coo5[0], coo5[2], coo5[3]
    v = jax.lax.bitcast_convert_type(coo5[4], jnp.float32)
    return mslab.at[chunk_idx, r, lc].set(
        v.astype(mslab.dtype), mode="drop", unique_indices=True
    )


@functools.partial(jax.jit, static_argnames=("new_cap", "pad_row"))
def grow_entry_cap(rows2d, cols2d, vals2d, new_cap: int, pad_row: int):
    """Capacity-doubling pad of the per-chunk buffers."""
    n_chunks, old = rows2d.shape
    nr = jnp.full((n_chunks, new_cap), pad_row, jnp.int32)
    nc = jnp.zeros((n_chunks, new_cap), jnp.int32)
    nv = jnp.zeros((n_chunks, new_cap), jnp.float32)
    return (
        jax.lax.dynamic_update_slice(nr, rows2d, (0, 0)),
        jax.lax.dynamic_update_slice(nc, cols2d, (0, 0)),
        jax.lax.dynamic_update_slice(nv, vals2d, (0, 0)),
    )


@functools.partial(
    jax.jit, static_argnames=("row_cap", "chunk_dim", "dtype")
)
def build_match_slabs(
    rows2d, cols2d, vals2d, counts, row_cap: int, chunk_dim: int,
    dtype: str = "bfloat16",
):
    """Densify EVERY chunk into one stacked ``[n_chunks, row_cap, chunk_dim]``
    slab array — the resident form behind the streaming fast path.  One full
    corpus scatter here replaces the per-micro-batch rebuild that dominated
    chunked insert latency (the element-bound scatter is paid on EVERY
    insert without the cache)."""
    n_chunks = rows2d.shape[0]
    dt = jnp.dtype(dtype)

    def body(c, out):
        slab = _densify_chunk(
            rows2d, cols2d, vals2d, counts, c, row_cap, chunk_dim, dt
        )
        return jax.lax.dynamic_update_index_in_dim(out, slab, c, 0)

    return jax.lax.fori_loop(
        0, n_chunks, body,
        jnp.zeros((n_chunks, row_cap, chunk_dim), dt),
    )


def _chunk_score_loop(
    slab_of, q_rows2d, q_cols2d, q_vals2d, q_counts,
    n_chunks: int, row_cap: int, chunk_dim: int, q_rows_cap: int,
    sdt, prec, queries_lead: bool = False,
):
    """Shared ``Σ_c slab_c · qslab_cᵀ`` accumulation behind every chunked
    match/topk variant.  ``slab_of(c)`` supplies the index side — densified
    from the entry buffers or dynamic-indexed out of the resident stack —
    so the loop/barrier scaffold has ONE definition.  ``queries_lead``
    transposes the accumulator to ``[q_rows_cap, row_cap]`` (topk layout)."""

    def chunk_body(c, acc):
        slab = slab_of(c)
        qslab = _densify_chunk(
            q_rows2d, q_cols2d, q_vals2d, q_counts, c, q_rows_cap, chunk_dim,
            sdt,
        )
        a, b = (qslab, slab) if queries_lead else (slab, qslab)
        return acc + jax.lax.dot_general(
            a, b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=prec,
        )

    shape = (q_rows_cap, row_cap) if queries_lead else (row_cap, q_rows_cap)
    s = jax.lax.fori_loop(
        0, n_chunks, chunk_body, jnp.zeros(shape, jnp.float32)
    )
    return jax.lax.optimization_barrier(s)


def _ent_slab_of(rows2d, cols2d, vals2d, counts, row_cap, chunk_dim, sdt):
    return lambda c: _densify_chunk(
        rows2d, cols2d, vals2d, counts, c, row_cap, chunk_dim, sdt
    )


def _resident_slab_of(mslab):
    return lambda c: jax.lax.dynamic_index_in_dim(
        mslab, c, 0, keepdims=False
    )


@functools.partial(jax.jit, static_argnames=("q_rows_cap", "k", "precision"))
def cached_topk(
    mslab, q_rows2d, q_cols2d, q_vals2d, q_counts, n_rows,
    q_rows_cap: int, k: int, precision: str = "default",
):
    """Top-k against the RESIDENT slabs (streaming fast path).  Scores carry
    the slab dtype's rounding (bf16 unless ``matmul_precision="highest"``,
    whose fp32 slabs must also be scored at ``precision="highest"`` to keep
    the narrow fetch margin valid); the engine widens the exact-fetch margin
    for bf16 slabs — the provably-exact fetch + fp64 re-rank contract is
    unchanged."""
    n_chunks, row_cap, chunk_dim = mslab.shape
    s = _chunk_score_loop(
        _resident_slab_of(mslab), q_rows2d, q_cols2d, q_vals2d, q_counts,
        n_chunks, row_cap, chunk_dim, q_rows_cap, mslab.dtype,
        _precision(precision), queries_lead=True,
    )
    col_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    s = jnp.where(col_ids < n_rows, s, -jnp.inf)
    return jax.lax.top_k(s, k)


def _densify_chunk(rows2d, cols2d, vals2d, counts, c, cap_rows, chunk_dim,
                   dtype=jnp.float32):
    """One [cap_rows, chunk_dim] slab from chunk ``c``'s buffer.

    ``dtype=bfloat16`` feeds the matrix units a native single-pass input —
    the engine's 2e-2 relative margin already covers bf16 rounding.

    Entries within a chunk are UNIQUE (one (row, ext-dim) pair each; the
    interleaved local mapping is injective per chunk), so this is a scatter
    **set** straight into the target dtype — no fp32 zeros + accumulate +
    cast pass.  That halves slab-build HBM traffic, and the value rounding
    (fp32→bf16 once per entry) is bit-identical to
    casting after an uncontended add."""
    r = jax.lax.dynamic_index_in_dim(rows2d, c, 0, keepdims=False)
    lc = jax.lax.dynamic_index_in_dim(cols2d, c, 0, keepdims=False)
    v = jax.lax.dynamic_index_in_dim(vals2d, c, 0, keepdims=False)
    cnt = jax.lax.dynamic_index_in_dim(counts, c, 0, keepdims=False)
    pos = jax.lax.broadcasted_iota(jnp.int32, (r.shape[0], 1), 0).squeeze(-1)
    valid = pos < cnt
    r = jnp.where(valid, r, cap_rows)  # OOB row -> dropped by scatter
    lc = jnp.where(valid, lc, 0)
    v = jnp.where(valid, v, 0.0)
    slab = jnp.zeros((cap_rows, chunk_dim), dtype)
    return slab.at[r, lc].set(
        v.astype(dtype), mode="drop", unique_indices=True
    )


def join_epilogue_bits(
    s, q0, tau_eff, cap: int, capb: int, cap0: int
):
    """Three-level bit-packed join epilogue for a chunked score stripe.

    The two-level ``_extract`` scans a ``row_cap/8 × super_tile`` group mask
    with ``jnp.nonzero`` — at out-of-core scale that scan IS the join.  This
    builds the shared bit-packed hierarchy (group bytes → 64-row supers →
    exact counts, ``ops/bits.py``) and compacts with ``bits._compact_bits``,
    so the only stripe-sized scan is ``row_cap/64 × super_tile`` (8×
    smaller) and the deeper levels scale with the candidate caps.

    Returns ``((rows, cols), packed_head)`` — the ``bits.unpack_head``
    layout, not ``_pack_head``'s.
    """
    row_cap, tile = s.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    cols = q0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    mi = ((s >= tau_eff) & (rows < cols)).astype(jnp.int32)
    # one "block" covering the whole stripe: rows are global, cols offset by
    # the stripe start (bj·tile == q0 — stripes are tile-aligned)
    return _epilogue_bits(mi, q0 // tile, cap, capb, cap0)


def _epilogue_bits(mi, bj0, cap: int, capb: int, cap0: int):
    """Shared single-block three-level compaction tail: bit-pack the hit
    mask, assemble the (saturating) count head, run
    ``bits._compact_bits``.  Used by the stripe-join AND streaming-match
    epilogues so the hierarchy has one definition.

    The counts saturate (``bits.bits_and_counts``): at the ~1M-row scale a
    wide stripe or large flush batch crosses 2^31 mask CELLS, and a wrapped
    NEGATIVE total would pass every overflow check and silently truncate
    the result."""
    from .bits import _compact_bits, bits_and_counts

    row_cap, tile = mi.shape
    gb, g64, cnt = bits_and_counts(mi)
    bi = jnp.zeros((1,), jnp.int32)
    bj = jnp.full((1,), bj0, jnp.int32)
    return _compact_bits(
        gb[None], g64[None], cnt[None], bi, bj, cap, capb, cap0, row_cap,
        tile,
    )


def match_epilogue_bits(s, q_base, tau_eff, cap: int, capb: int, cap0: int):
    """Three-level bit-packed STREAMING-MATCH epilogue (the
    ``join_epilogue_bits`` recipe with the match mask): threshold +
    self-pair exclusion, then the group-byte/64-row-super hierarchy so the
    only batch-sized scan is ``row_cap/512 × q_rows_cap`` — the two-level
    ``_extract`` scan (``row_cap/8 × q_rows_cap``) grows linearly with the
    flush batch and dominated large-batch inserts at out-of-core scale
    (~1.2 s of a 2.8 s / 2048-row batch at 500k rows).

    Emitted pairs are (index_row, query_local); returns
    ``((rows, cols), packed_head)`` — the ``bits.unpack_head`` layout, not
    ``_pack_head``'s."""
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    qglob = q_base + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    mi = ((s >= tau_eff) & (rows != qglob)).astype(jnp.int32)
    # rows global (bi=0), cols are query LOCALS (bj=0)
    return _epilogue_bits(mi, 0, cap, capb, cap0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "row_cap", "chunk_dim", "q_rows_cap", "cap", "capb", "cap0",
        "precision",
    ),
)
def chunked_match_extract_bits(
    rows2d, cols2d, vals2d, counts,
    q_rows2d, q_cols2d, q_vals2d, q_counts,
    q_base, tau_eff,
    row_cap: int, chunk_dim: int, q_rows_cap: int, cap: int, capb: int,
    cap0: int, precision: str = "default",
):
    """``chunked_match_extract`` with the three-level bit-packed epilogue
    (see ``match_epilogue_bits``); ``bits`` head overflow contract."""
    n_chunks = rows2d.shape[0]
    sdt = jnp.float32 if precision == "highest" else jnp.bfloat16
    s = _chunk_score_loop(
        _ent_slab_of(rows2d, cols2d, vals2d, counts, row_cap, chunk_dim,
                     sdt),
        q_rows2d, q_cols2d, q_vals2d, q_counts,
        n_chunks, row_cap, chunk_dim, q_rows_cap, sdt,
        _precision(precision),
    )
    return match_epilogue_bits(s, q_base, tau_eff, cap, capb, cap0)


@functools.partial(
    jax.jit,
    static_argnames=("q_rows_cap", "cap", "capb", "cap0", "precision"),
)
def cached_match_extract_bits(
    mslab, q_rows2d, q_cols2d, q_vals2d, q_counts, q_base, tau_eff,
    q_rows_cap: int, cap: int, capb: int, cap0: int,
    precision: str = "default",
):
    """Streaming match against RESIDENT slabs (identical scores to
    ``chunked_match_extract_bits`` — same slab dtype/rounding, same dot,
    same epilogue — with the per-chunk index densify replaced by a
    ``dynamic_index`` into the cached stack); ``bits`` head contract."""
    n_chunks, row_cap, chunk_dim = mslab.shape
    s = _chunk_score_loop(
        _resident_slab_of(mslab), q_rows2d, q_cols2d, q_vals2d, q_counts,
        n_chunks, row_cap, chunk_dim, q_rows_cap, mslab.dtype,
        _precision(precision),
    )
    return match_epilogue_bits(s, q_base, tau_eff, cap, capb, cap0)


def match_epilogue(s, q_base, tau_eff, cap: int, group: int):
    """Shared streaming-match epilogue over a complete score matrix
    ``s [row_cap, q_rows_cap]``: threshold, self-pair exclusion (global query
    row = ``q_base + local``), two-level compaction."""
    rows = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    qglob = q_base + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    m = (s >= tau_eff) & (rows != qglob)
    buf_i = jnp.full((cap,), -1, jnp.int32)  # cursor 0: cap suffices
    buf_j = jnp.full((cap,), -1, jnp.int32)
    buf_i, buf_j, _, total, groups = _extract(
        m, jnp.int32(0), buf_i, buf_j, jnp.int32(0), cap, group
    )
    return (buf_i, buf_j), _pack_head(buf_i, buf_j, total, groups, HEAD_JOIN)


@functools.partial(
    jax.jit,
    static_argnames=(
        "row_cap", "chunk_dim", "super_tile", "cap", "capb", "cap0",
        "precision",
    ),
)
def chunked_stripe_extract(
    rows2d, cols2d, vals2d, counts, q0, tau_eff,
    row_cap: int, chunk_dim: int, super_tile: int, cap: int,
    capb: int = 0, cap0: int = 0, precision: str = "default",
):
    """Score one ``super_tile``-wide query stripe of the upper-triangle join
    over chunked COO entries; returns ``((rows, cols), packed_head)``
    (three-level bit-packed extraction — see ``join_epilogue_bits``)."""
    from .bits import GROUP

    capb = capb or max(cap // GROUP, 1024)
    cap0 = cap0 or capb  # level-0 cap only sizes a tiny gather; a
    # generous default avoids a first-call overflow retry (a whole extra
    # executable compile cold -- VERDICT r2 cold-start item)
    n_chunks = rows2d.shape[0]
    prec = _precision(precision)
    sdt = jnp.float32 if precision == "highest" else jnp.bfloat16

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
        0, n_chunks, chunk_body,
        jnp.zeros((row_cap, super_tile), jnp.float32),
    )
    s = jax.lax.optimization_barrier(s)
    return join_epilogue_bits(s, q0, tau_eff, cap, capb, cap0)


@functools.partial(jax.jit, static_argnames=("row_cap",))
def quantize_chunk_entries(rows2d, vals2d, row_cap: int):
    """Device-side per-row symmetric int8 quantization of chunk entries.

    One pass over the entry buffers: per-row ``α = max|v|/127`` via
    scatter-max (padded slots carry an out-of-bounds row → dropped), then
    ``q = round(v/α)`` stored back in the [n_chunks, chunk_cap] layout, plus
    the per-pair bound ingredients ``aux = [α, α·L1(q), nnz]`` (fp32
    [3, row_cap]) and the max device-row nnz (int32 accumulator safety
    gate).  α covers DEVICE-resident entries only, which is exactly what the
    bound must bound — dormant-archived values never enter the device dot.
    All-zero rows get α = 0 ⇒ zero score and zero bound (the padded-row
    lesson from the dense int8 path)."""
    flat_r = rows2d.reshape(-1)
    flat_v = vals2d.reshape(-1)
    absv = jnp.abs(flat_v)
    mx = jnp.zeros((row_cap,), jnp.float32).at[flat_r].max(absv, mode="drop")
    alpha = jnp.where(mx > 0, mx / 127.0, 0.0)
    safe_r = jnp.minimum(flat_r, row_cap - 1)
    div = jnp.where(alpha[safe_r] > 0, alpha[safe_r], 1.0)
    q = jnp.clip(jnp.round(flat_v / div), -127, 127).astype(jnp.int8)
    l1q = jnp.zeros((row_cap,), jnp.float32).at[flat_r].add(
        jnp.abs(q).astype(jnp.float32), mode="drop"
    )
    nnz = jnp.zeros((row_cap,), jnp.float32).at[flat_r].add(
        (flat_v != 0).astype(jnp.float32), mode="drop"
    )
    aux = jnp.stack([alpha, alpha * l1q, nnz])
    return q.reshape(rows2d.shape), aux, jnp.max(nnz).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "row_cap", "chunk_dim", "super_tile", "cap", "capb", "cap0",
    ),
)
def chunked_stripe_extract_int8(
    rows2d, cols2d, q2d, counts, aux, q0, tau_eff,
    row_cap: int, chunk_dim: int, super_tile: int, cap: int,
    capb: int = 0, cap0: int = 0,
):
    """int8 variant of ``chunked_stripe_extract``: int8 slabs, int32
    accumulation (EXACT — no fp rounding in the dot), per-pair quantization
    bound in the epilogue (same proof as the dense int8 kernel:
    ``|x_i·x_j − α_iα_j D| ≤ 0.5(α_j b_i + α_i b_j) +
    0.25 α_iα_j min(n_i, n_j)``), then the shared bit-packed compaction."""
    from .bits import GROUP

    capb = capb or max(cap // GROUP, 1024)
    cap0 = cap0 or capb  # level-0 cap only sizes a tiny gather; a
    # generous default avoids a first-call overflow retry (a whole extra
    # executable compile cold -- VERDICT r2 cold-start item)
    n_chunks = rows2d.shape[0]

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
        0, n_chunks, chunk_body,
        jnp.zeros((row_cap, super_tile), jnp.int32),
    )
    d = jax.lax.optimization_barrier(d)
    return int8_join_epilogue(d, aux, q0, tau_eff, cap, capb, cap0)


def int8_join_epilogue(d, aux, q0, tau_eff, cap: int, capb: int, cap0: int):
    """Shared int8 stripe epilogue: rescale the EXACT int32 dot stripe,
    apply the per-pair quantization bound + strict-upper mask (ONE
    definition: ``panel.int8_bound_mask``), bit-pack and compact via
    ``_epilogue_bits`` (saturating hit count — a ~1M-row wide stripe can
    cross 2^31 mask cells).  Used by the single-device int8 stripe AND the
    mesh-sharded one (where ``d`` arrives as a psum of per-device partial
    int32 dots — the sum is exact, so the bound proof is unchanged)."""
    row_cap, super_tile = d.shape
    from .panel import int8_bound_mask

    aux_j = jax.lax.dynamic_slice(aux, (0, q0), (3, super_tile))
    rows = jax.lax.broadcasted_iota(jnp.int32, d.shape, 0)
    cols = q0 + jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    mi = int8_bound_mask(d, aux, aux_j, rows, cols, tau_eff).astype(
        jnp.int32
    )
    return _epilogue_bits(mi, q0 // super_tile, cap, capb, cap0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "row_cap", "chunk_dim", "q_rows_cap", "cap", "group", "precision",
    ),
)
def chunked_match_extract(
    rows2d, cols2d, vals2d, counts,
    q_rows2d, q_cols2d, q_vals2d, q_counts,
    q_base, tau_eff,
    row_cap: int, chunk_dim: int, q_rows_cap: int, cap: int,
    group: int = 8, precision: str = "default",
):
    """Streaming match: score the batch's chunk-bucketed queries against the
    FULL chunked index, keep ``s >= tau_eff`` excluding self-pairs (global
    query row = ``q_base + local``).  Returns (bufs, packed_head); decoded
    pairs are (index_row, query_local) — the chunked analog of
    ``score.match_tile_extract`` (index-before-query emission,
    SURVEY.md fine-print #2)."""
    n_chunks = rows2d.shape[0]
    sdt = jnp.float32 if precision == "highest" else jnp.bfloat16
    s = _chunk_score_loop(
        _ent_slab_of(rows2d, cols2d, vals2d, counts, row_cap, chunk_dim,
                     sdt),
        q_rows2d, q_cols2d, q_vals2d, q_counts,
        n_chunks, row_cap, chunk_dim, q_rows_cap, sdt,
        _precision(precision),
    )
    return match_epilogue(s, q_base, tau_eff, cap, group)


@functools.partial(
    jax.jit,
    static_argnames=(
        "row_cap", "chunk_dim", "q_rows_cap", "k", "precision",
    ),
)
def chunked_topk(
    rows2d, cols2d, vals2d, counts,
    q_rows2d, q_cols2d, q_vals2d, q_counts, n_rows,
    row_cap: int, chunk_dim: int, q_rows_cap: int, k: int,
    precision: str = "default",
):
    """Top-k over chunked entries: both the index AND the queries arrive as
    chunk-bucketed COO, so neither side ever materializes its full dense
    width.  Returns (scores [q_rows_cap, k], index row ids [q_rows_cap, k])."""
    n_chunks = rows2d.shape[0]
    sdt = jnp.float32 if precision == "highest" else jnp.bfloat16
    s = _chunk_score_loop(
        _ent_slab_of(rows2d, cols2d, vals2d, counts, row_cap, chunk_dim,
                     sdt),
        q_rows2d, q_cols2d, q_vals2d, q_counts,
        n_chunks, row_cap, chunk_dim, q_rows_cap, sdt,
        _precision(precision), queries_lead=True,
    )
    col_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    s = jnp.where(col_ids < n_rows, s, -jnp.inf)
    return jax.lax.top_k(s, k)


# --------------------------------------------- paneled streaming match
# Beyond the resident-slab budget, every streaming match used to pay (a) a
# full O(corpus-nnz) per-chunk re-scatter and (b) a [row_cap, q] fp32
# accumulator whose HBM footprint capped the query width at 2048 — so the
# O(corpus) cost amortized over at most 2048 queries.  This path keeps the
# corpus as ONE row-sorted flat COO (maintained incrementally by the
# engine: batch appends extend the tail in row order; dormant activations
# go to a small unsorted overflow region consolidated by a periodic
# re-sort) and scores ph-row PANELS
# under a lax.scan:
#
#     for panel p:  slab_p [ph, d_cap]  <-  sorted slice + overflow
#                   s_p = slab_p @ qslabT          [ph, q_rows_cap] fp32
#                   bit-pack mask -> block p
#     one multi-block _compact_bits over all panels
#
# The scatter total stays O(corpus nnz) (sorted slices touch only their
# panel's entries), the accumulator is [ph, q] (so q lifts to 8192+), and
# empty trailing panels (row_cap padding) skip entirely via lax.cond —
# which makes the geometric row_cap headroom ~free on this path.  Same
# numerics contract as chunked_match_extract_bits: values rounded once to
# the slab dtype at scatter, fp32 accumulation, tau_eff margin + fp64
# host rescore decide the final pairs.


@functools.partial(jax.jit, static_argnames=("cap_s",))
def sort_entries_fp(rows2d, cols2d, vals2d, counts, cap_s: int):
    """Row-sorted flat COO carrying fp32 value BITS (int32) from the
    per-chunk entry buffers; padding slots carry ``row == 2^30`` and sort
    to the tail.  Global compact col = ``local * n_chunks + chunk``
    (split_chunks inverted — equal to the original compact id)."""
    n_chunks, cap = rows2d.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (n_chunks, cap), 1)
    valid = pos < counts[:, None]
    r = jnp.where(valid, rows2d, jnp.int32(1 << 30)).reshape(-1)
    chunk_of = jax.lax.broadcasted_iota(jnp.int32, (n_chunks, cap), 0)
    gc = jnp.where(valid, cols2d * n_chunks + chunk_of, 0).reshape(-1)
    vb = jnp.where(
        valid, jax.lax.bitcast_convert_type(vals2d, jnp.int32), 0
    ).reshape(-1)
    order = jnp.argsort(r)
    r_s, gc_s, vb_s = r[order], gc[order], vb[order]
    flat = int(r_s.shape[0])
    if cap_s > flat:
        pad = cap_s - flat
        r_s = jnp.pad(r_s, (0, pad), constant_values=1 << 30)
        gc_s = jnp.pad(gc_s, (0, pad))
        vb_s = jnp.pad(vb_s, (0, pad))
    elif cap_s < flat:
        # live entries are front-contiguous after the sort; the caller
        # guarantees cap_s >= live count
        r_s, gc_s, vb_s = r_s[:cap_s], gc_s[:cap_s], vb_s[:cap_s]
    return r_s, gc_s, vb_s


@functools.partial(
    jax.jit, donate_argnums=(0, 1, 2), static_argnames=("n_chunks", "sort")
)
def append_sorted_packed(r_s, gc_s, vb_s, coo5, off, n_chunks: int,
                         sort: bool = True):
    """Donated append of one packed ``[5, ecap]`` batch (the SAME array the
    entry-buffer append ships — zero extra H2D) into the sorted flat COO at
    ``off``.  ``sort=True`` row-sorts the batch on device first (batch rows
    are >= every existing row, so the array stays globally row-sorted even
    when the batch straddles a panel boundary); ``sort=False`` is the
    overflow append (order-free region).  Padding entries (chunk ==
    n_chunks) carry row 2^30.  Caller guarantees ``off + ecap <= cap``."""
    valid = coo5[0] < n_chunks
    r = jnp.where(valid, coo5[2], jnp.int32(1 << 30))
    gc = jnp.where(valid, coo5[3] * n_chunks + coo5[0], 0)
    vb = jnp.where(valid, coo5[4], 0)
    if sort:
        order = jnp.argsort(r)
        r, gc, vb = r[order], gc[order], vb[order]
    return (
        jax.lax.dynamic_update_slice(r_s, r, (off,)),
        jax.lax.dynamic_update_slice(gc_s, gc, (off,)),
        jax.lax.dynamic_update_slice(vb_s, vb, (off,)),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "ph", "n_panels", "d_cap", "p_cap", "q_ecap", "q_rows_cap",
        "cap", "capb", "cap0", "precision",
    ),
)
def paneled_match_extract_bits(
    r_s, gc_s, vb_s, r_o, gc_o, vb_o, pk, tau_eff,
    ph: int, n_panels: int, d_cap: int, p_cap: int, q_ecap: int,
    q_rows_cap: int, cap: int, capb: int, cap0: int,
    precision: str = "default",
):
    """Streaming match of a query batch against the full index via ph-row
    panels over the row-sorted COO (see the section comment above).

    ``pk`` is ONE packed int32 array: ``[starts (n_panels+1)] [q_base]
    [n_live_rows] [q rows local (q_ecap)] [q compact cols (q_ecap)]
    [q fp32 bits (q_ecap)]`` — a single H2D per call.  Query padding
    entries carry ``row == q_rows_cap`` (scatter-dropped).  Emitted pairs
    are (global index row, query LOCAL); ``bits.unpack_head`` overflow
    contract."""
    from .bits import _compact_bits, bits_and_counts

    sdt = jnp.float32 if precision == "highest" else jnp.bfloat16
    prec = _precision(precision)
    hdr = n_panels + 3
    starts = pk[: n_panels + 1]
    q_base = pk[n_panels + 1]
    n_live = pk[n_panels + 2]
    qr = pk[hdr : hdr + q_ecap]
    qc = pk[hdr + q_ecap : hdr + 2 * q_ecap]
    qv = jax.lax.bitcast_convert_type(
        pk[hdr + 2 * q_ecap : hdr + 3 * q_ecap], jnp.float32
    )
    qslab = jnp.zeros((q_rows_cap, d_cap), sdt).at[qr, qc].set(
        qv.astype(sdt), mode="drop", unique_indices=True
    )

    def body(carry, xs):
        start, p = xs
        row0 = p * ph

        def live(_):
            r = jax.lax.dynamic_slice(r_s, (start,), (p_cap,))
            g = jax.lax.dynamic_slice(gc_s, (start,), (p_cap,))
            vb = jax.lax.dynamic_slice(vb_s, (start,), (p_cap,))
            # membership by ROW RANGE, not slice position: dynamic_slice
            # start-clamping near the tail only widens the window with
            # entries the range test drops
            ok = (r >= row0) & (r < row0 + ph)
            rl = jnp.where(ok, r - row0, ph)
            v = jax.lax.bitcast_convert_type(vb, jnp.float32)
            slab = jnp.zeros((ph, d_cap), sdt).at[rl, g].set(
                v.astype(sdt), mode="drop", unique_indices=True
            )
            # overflow region: activation entries for OLD rows (new compact
            # cols only, so never a duplicate of a sorted entry)
            ok_o = (r_o >= row0) & (r_o < row0 + ph)
            rlo = jnp.where(ok_o, r_o - row0, ph)
            vo = jax.lax.bitcast_convert_type(vb_o, jnp.float32)
            slab = slab.at[rlo, gc_o].set(
                vo.astype(sdt), mode="drop", unique_indices=True
            )
            s = jax.lax.dot_general(
                slab, qslab,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )
            s = jax.lax.optimization_barrier(s)
            rows = row0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
            qg = q_base + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
            mi = ((s >= tau_eff) & (rows != qg)).astype(jnp.int32)
            return bits_and_counts(mi)

        def empty(_):
            # row_cap padding panels: no live rows, no entries — skipping
            # them makes the geometric row_cap headroom ~free here
            return (
                jnp.zeros((ph // 8, q_rows_cap), jnp.uint8),
                jnp.zeros((ph // 64, q_rows_cap), jnp.uint8),
                jnp.zeros((3,), jnp.int32),
            )

        return carry, jax.lax.cond(row0 < n_live, live, empty, 0)

    ps = jnp.arange(n_panels, dtype=jnp.int32)
    _, (gb, g64, cnt) = jax.lax.scan(body, 0, (starts[:-1], ps))
    bi = jnp.arange(n_panels, dtype=jnp.int32)
    bj = jnp.zeros((n_panels,), jnp.int32)
    return _compact_bits(gb, g64, cnt, bi, bj, cap, capb, cap0, ph,
                         q_rows_cap)
