"""Single-slice all-pairs similarity engine.

This collapses the reference's actor pipeline —
EntryProxyActor (admission pruning, EntryProxyActor.scala:81-111)
→ WriteWorkerActor (ingest buffering + dim partitioning,
WriteWorkerActor.scala:164-202)
→ IndexingWorkerActor (inverted index + scoring,
IndexingWorkerActor.scala:61-141) —
into one object holding:

  - a device-resident dense index matrix ``X [row_cap, dim_cap]`` over compact
    frequency-ordered columns (the CSR-posting/inverted-index replacement),
  - a host float64 CSR shadow (exact rescoring, checkpointing),
  - running per-dimension max weights (real max-weight admission pruning —
    the reference stubs these to 1.0, EntryProxyActor.scala:51-57).

Capabilities (SURVEY.md §7): bulk ``build``, exact thresholded ``all_pairs``,
streaming ``insert`` micro-batches matched online against the live index
(index-before-query, so intra-batch pairs are found — fine-print #2),
``topk`` queries, freeze semantics for benchmarking
(IndexingWorkerActor.scala:143-144), checkpoint/restore.

Known deviation from the reference, by design (SURVEY.md fine-print #3): the
reference's first-dimension dedup bug nondeterministically *drops* pairs; we
compute the exact pair set, a superset on affected inputs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import AllPairsConfig
from ..index.compact import CompactSpace
from ..utils.jaxsetup import setup_jax
from ..ops import rescore as rescore_ops
from ..ops import score as score_ops
from ..vector.batch import CSRMatrix, pack_coo_i32, round_up
from ..vector.sparse import SparseVector
from .output import PairResult, SimilarityOutput

__all__ = ["Engine", "BuildStats"]


class BuildStats(dict):
    pass


def _next_cap(cap: int, count: int) -> int:
    """Grow the extraction capacity past ``count`` in ×4 steps (bounded
    recompiles; each new cap compiles once)."""
    while cap < count:
        cap *= 4
    return cap


class _CompletedInsert:
    """Already-finished insert result (the non-fused paths)."""

    def __init__(self, out: SimilarityOutput):
        self._out = out

    def result(self) -> SimilarityOutput:
        return self._out


class PendingInsert:
    """Deferred completion of a fused streaming insert.

    The index update happened on device inside the fused call; only the
    result fetch + fp64 rescore remain.  Calling :meth:`result` later lets
    the caller overlap that host work with the NEXT batch's device work
    (the server's ingest pipelining).  Safe across subsequent inserts: the
    packed candidates were computed against the index state at insert time,
    and the overflow-retry path filters any rows appended afterwards.
    """

    def __init__(self, eng: "Engine", bufs, packed, cap, grp, n0, n_after,
                 first_tile, tau_eff, tile, tau):
        self._e = (eng, bufs, packed, cap, grp, n0, n_after, first_tile,
                   tau_eff, tile, tau)
        self._out: SimilarityOutput | None = None
        # start the packed-head D2H NOW: the transfer runs as soon as the
        # device finishes the fused insert, so by the time result() fires
        # (next server tick, after batch N+1's host prep + H2D) the bytes
        # are already host-side — without this, result() pays the full
        # fetch round trip serially
        try:
            packed.copy_to_host_async()
        except AttributeError:  # non-jax array (tests, fallbacks)
            pass

    def result(self) -> SimilarityOutput:
        if self._out is not None:
            return self._out
        (eng, bufs, packed, cap, grp, n0, n_after, first_tile, tau_eff,
         tile, tau) = self._e
        pairs = eng._consume_match(bufs, packed, cap, grp)
        if pairs is None:
            # x is already updated (donated); retry ONLY the match — and
            # restrict BOTH sides to this insert's snapshot: candidate rows
            # appended later re-find those pairs from their own query side,
            # and later query columns belong to the later batch's output
            rows, cols = eng._match_tile_retry(
                first_tile, n0, tau_eff, tile,
                _next_cap(cap, eng._last_needed), grp,
            )
            keep = (rows < n_after) & (cols < n_after)
            pairs = (rows[keep], cols[keep])
        else:
            eng._note_insert_cap(pairs[0].size, cap)
        self._out = eng._emit_query_results(pairs[1], pairs[0], tau)
        return self._out


def _as_csr(
    vectors: Sequence[Tuple[str, SparseVector]] | CSRMatrix,
    ids: Sequence[str] | None,
    vector_dim: int,
) -> Tuple[CSRMatrix, List[str]]:
    if isinstance(vectors, CSRMatrix):
        csr = vectors
        out_ids = list(ids) if ids is not None else [str(i) for i in range(csr.n_rows)]
    else:
        out_ids = [vid for vid, _ in vectors]
        csr = CSRMatrix.from_vectors([v for _, v in vectors], vector_dim)
    if len(out_ids) != csr.n_rows:
        raise ValueError("ids length mismatch")
    return csr, out_ids


def assemble_topk(qids, qi_idx, cand_idx, sims, k_eff: int, ids):
    """Group flat (query, candidate, sim) triples per query, dedup
    candidates (dormant-hit extras may repeat a fetched row) and return the
    fp64-ranked top ``k_eff`` per query id.  One stable argsort over the
    flat arrays instead of a per-query boolean mask — O(total·log total),
    not O(nq·total)."""
    out = {}
    qi_idx = np.asarray(qi_idx)
    order = np.argsort(qi_idx, kind="stable")
    qs = qi_idx[order]
    bounds = np.searchsorted(qs, np.arange(len(qids) + 1))
    for qi, qid in enumerate(qids):
        sel = order[bounds[qi] : bounds[qi + 1]]
        rr, ss = np.asarray(cand_idx)[sel], np.asarray(sims)[sel]
        uniq, first = np.unique(rr, return_index=True)
        rr, ss = uniq, ss[first]
        top = np.argsort(-ss, kind="stable")[:k_eff]
        out[qid] = [(ids[int(rr[t])], float(ss[t])) for t in top]
    return out


def fetch_exact_topk(fetch, n_rows: int, k_eff: int, margin: float):
    """Grow the candidate fetch until it provably contains the true top-k.

    ``fetch(k_fetch) -> (dev_scores [nq, k_fetch], rows [nq, k_fetch])``
    returns the device's top ``k_fetch`` per query, scores descending.  The
    fetched set is sufficient for query q once
    ``dev_scores[q, -1] < dev_scores[q, k_eff-1] - margin`` with
    ``margin = 2m`` (see Engine.topk docstring for the bound), because every
    unfetched candidate scores at most the minimum fetched score.  Fetching
    all ``n_rows`` is trivially sufficient.  Depths double (shape-bucketed by
    the caller's jit) so at most O(log n) device calls happen, and only on
    adversarially tie-dense corpora.

    Returns ``(rows, k_fetch)`` of the final sufficient fetch.
    """
    k_fetch = min(n_rows, max(4 * k_eff, k_eff + 64))
    while True:
        scores, rows = fetch(k_fetch)
        if k_fetch >= n_rows:
            return rows, k_fetch
        cutoff = scores[:, k_eff - 1] - margin
        if bool(np.all(scores[:, -1] < cutoff)):
            return rows, k_fetch
        k_fetch = min(n_rows, 2 * k_fetch)


class Engine:
    def __init__(self, config: AllPairsConfig | None = None):
        setup_jax()
        self.cfg = config or AllPairsConfig()
        self.compact = CompactSpace(self.cfg.vector_dim, self.cfg.dim_bucket)
        self.x = None  # device [row_cap, dim_cap] (property: see below)
        self.n_rows = 0
        self.ids: List[str] = []
        self.id_to_row: Dict[str, int] = {}
        # host fp64 shadow (external dim space): growable CSR arrays with
        # capacity doubling — appends are O(batch), not O(corpus)
        self._sh_indptr = np.zeros(1, dtype=np.int64)
        self._sh_rows = 0
        self._sh_indices = np.empty(0, dtype=np.int32)
        self._sh_data = np.empty(0, dtype=np.float64)
        self._sh_nnz = 0
        self._scipy_cache: tuple | None = None
        self.max_weights = np.zeros(self.cfg.vector_dim, dtype=np.float64)
        self._max_norm = 0.0  # largest row L2 norm seen (margin scaling)
        self._frozen = False
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "vectors_dropped_admission": 0,
            "candidates_scored": 0,
            "pairs_emitted": 0,
            "insert_batches": 0,
            "dormant_dims": 0,
            # dispatch-path mix: 1-tile fused / 2-tile fused window /
            # separate scatter + windowed per-tile match
            "insert_fused": 0,
            "insert_fused2": 0,
            "insert_slowpath": 0,
        }
        from ..utils.logging import Timer

        self.timer = Timer()  # per-stage wall timings (stats["timings"])
        # int8 scoring state: demoted-to-bf16 flag + whether the last
        # all_pairs actually scored at int8 (drives the demotion check)
        self._int8_off = False
        self._used_int8 = False
        # dormant-dim archive: df==1 dims are kept OFF the device index (they
        # cannot contribute to any i != j pair) and their single (row, value)
        # entry lives here until an insert shares the dim (activation)
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dormant_of_ext: np.ndarray | None = None

    # ------------------------------------------------------------------ sizes
    @property
    def x(self):
        """The device index matrix."""
        return self._x

    @x.setter
    def x(self, val):
        # the int8 score copy is keyed by the identity of x; drop it
        # eagerly on every reassignment so a replaced (grown, donated, or
        # released) index never pins its derived HBM copy — without this,
        # an engine that served one all_pairs and then streamed inserts
        # held the stale copy (and the dead donated buffer's Python object)
        # until the next all_pairs call
        self._x = val
        self._int8_cache = None

    @property
    def row_cap(self) -> int:
        return 0 if self.x is None else int(self.x.shape[0])

    @property
    def dim_cap(self) -> int:
        return 0 if self.x is None else int(self.x.shape[1])

    def _tile(self) -> int:
        return int(self.cfg.query_tile)

    def _row_quantum(self) -> int:
        # row capacity must stay a multiple of both the packing unit (8) and
        # the query tile so tile slices never run off the end; a row_bucket
        # that isn't tile-aligned would let _score_tile's dynamic_slice clamp
        # the last tile to a wrong offset, so round up to the tile
        return round_up(max(self.cfg.row_bucket, self._tile()), self._tile())

    def _place(self, x):
        """Sharding hook: the mesh engine overrides this to pin the index
        matrix's device layout; single-device engines pass through."""
        return x

    def _margin(self, tau: float) -> float:
        """Device-error superset margin.

        The base margins are *relative* error bounds for a single dot
        product (bf16 mantissa rounding ≲ 2e-3 of ``‖a‖·‖b‖``; fp32
        accumulate ≲ 1e-6), scaled by the largest pairwise norm product so
        thresholding stays lossless for unnormalized corpora too (the
        reference's HBase path stores unnormalized TF-IDF — SURVEY.md
        fine-print #1)."""
        scale = max(self._max_norm * self._max_norm, 1.0)
        return self._margin_rel() * scale

    def _max_row_nnz(self) -> int:
        """Largest SHADOW row nnz — an upper bound on any device row's nnz
        (the device may hold fewer entries: dormant dims)."""
        if self._sh_rows == 0:
            return 0
        return int(
            np.diff(self._sh_indptr[: self._sh_rows + 1]).max()
        )

    def _margin_rel(self, precision: str | None = None) -> float:
        """Relative device-error bound for one dot product (unscaled).

        THE margin policy: the chunked engine aliases this (and ``_margin``
        / ``_tau_eff``), so the exactness guarantee cannot diverge between
        engine flavors."""
        if precision is None:
            precision = self.cfg.matmul_precision
        # fp32-highest path: |err| <= (n+2)·2^-24·Σ|a_i b_i|
        # <= (n+2)·2^-24·‖a‖·‖b‖ — n·eps for a sequential sum over n
        # overlapping nonzeros (XLA's tree orders are tighter) plus 2·eps
        # for the fp64→fp32 operand casts.  Scaling by the corpus' max row
        # nnz makes this a PROOF, not an empirical calibration;
        # rescore_margin stays as the config floor.
        m = max(
            self.cfg.rescore_margin,
            (self._max_row_nnz() + 2) * 2.0 ** -24,
        )
        if self.cfg.dtype != "float32":
            m = max(m, rescore_ops.default_margin(self.cfg.dtype))
        if precision != "highest":
            # a "default"-precision f32 dot may round both operands: to
            # bf16 (2^-8 relative each) or, on the GPU's tensor cores, to
            # TF32 (10-bit mantissa, ~2^-11 each).  bf16 is the worse case:
            # |err| <= ~2^-7 * sum|a_i b_i| <= 0.008 * ||a||*||b||, so 2e-2
            # relative gives ~2.5x worst-case headroom for both roundings
            m = max(m, 2e-2)
        return m

    def _tau_eff(self, tau: float) -> np.float32:
        m = self._margin(tau)
        if tau - m < score_ops.MIN_TAU_EFF and not getattr(
            self, "_warned_low_tau", False
        ):
            # the raw-score device paths test ``score >= tau_eff`` with a
            # non-negative threshold, so a margin >= tau cannot be
            # expressed: a true pair whose device score rounds to <= 0 is
            # not in the candidate superset (reachable with unnormalized
            # corpora at bf16, or tau below ~2e-2 of the norm scale).  The
            # int8 paths are immune (their error bound is added back
            # device-side).  Warn ONCE instead of failing: tiny-tau "all
            # overlapping pairs" queries are legitimate, and the pairs at
            # risk have |sim| <= margin.  Documented in PARITY.md.
            self._warned_low_tau = True
            from ..utils.logging import get_logger

            get_logger().warning(
                "tau=%g is below the device-error margin %.4g (row norms "
                "up to %.4g, precision=%r): pairs with similarity within "
                "the margin of zero may be missed on non-int8 score paths. "
                "L2-normalize the vectors, raise tau, or set "
                "matmul_precision='highest' for a tighter margin.",
                tau, m, self._max_norm, self.cfg.matmul_precision,
            )
        return np.float32(max(tau - m, score_ops.MIN_TAU_EFF))

    def _note_norms(self, csr: CSRMatrix) -> None:
        norms = csr.row_norms()
        if norms.size:
            self._max_norm = max(self._max_norm, float(norms.max()))

    # ------------------------------------------------------------------ build
    def build(
        self,
        vectors: Sequence[Tuple[str, SparseVector]] | CSRMatrix,
        ids: Sequence[str] | None = None,
    ) -> BuildStats:
        """Bulk index build (the LoadData/HBase path — no admission pruning,
        no component filter, matching WriteWorkerActor.scala:132-161)."""
        t0 = time.time()
        csr, new_ids = _as_csr(vectors, ids, self.cfg.vector_dim)
        if self.n_rows:
            raise RuntimeError("build() on a non-empty engine; use insert()")
        self.compact = CompactSpace.from_csr(
            csr, self.cfg.dim_bucket,
            min_df=2 if self.cfg.dormant_dims else 1,
        )
        compact_csr = self.compact.map_csr(self._archive_dormant(csr))
        row_cap = round_up(max(csr.n_rows, 1), self._row_quantum())
        dim_cap = self.compact.capacity
        self.x = self._place(
            score_ops.new_index_matrix(row_cap, dim_cap, self.cfg.dtype)
        )
        self._scatter_rows(compact_csr, row_offset=0)
        self.n_rows = csr.n_rows
        self.ids = list(new_ids)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._append_shadow(csr)
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self._note_norms(csr)
        self.stats["vectors_indexed"] += csr.n_rows
        import jax

        jax.block_until_ready(self.x)
        return BuildStats(
            n_rows=self.n_rows,
            n_active_dims=self.compact.n_active,
            row_cap=row_cap,
            dim_cap=dim_cap,
            build_seconds=time.time() - t0,
        )

    def _scatter_rows(self, compact_csr: CSRMatrix, row_offset: int) -> None:
        """Chunked flat-COO scatter of compact CSR rows into the device
        matrix: one O(nnz) packed H2D + one donated dispatch per ~4M-entry
        chunk (the padded ``[rows, max_nnz]`` form this replaced paid for
        the longest document on every row and transferred dims and vals
        separately).  Entry counts are pow2-bucketed inside the pack so a
        stream of arbitrary batch shapes compiles O(log) variants."""
        import jax.numpy as jnp

        nnz = int(compact_csr.indptr[-1])
        if row_offset > 0:
            # streaming append: the rows are CONTIGUOUS, so scatter via a
            # small dense buffer + DMA slice per ≤2048-row chunk — XLA
            # lowers a scatter into the full index as an O(index) output
            # pass (batch-size independent), which dominated every
            # slow-path streaming batch
            from ..vector.batch import pow2_bucket

            rows_per = 2048
            for r0 in range(0, compact_csr.n_rows, rows_per):
                r1 = min(r0 + rows_per, compact_csr.n_rows)
                e0 = int(compact_csr.indptr[r0])
                e1 = int(compact_csr.indptr[r1])
                bs_cap = min(pow2_bucket(r1 - r0, 256), self.row_cap)
                s0 = max(0, min(row_offset + r0, self.row_cap - bs_cap))
                rows_local = (
                    row_offset + r0 - s0
                ) + np.repeat(
                    np.arange(r1 - r0, dtype=np.int64),
                    np.diff(compact_csr.indptr[r0 : r1 + 1]),
                )
                coo = pack_coo_i32(
                    rows_local, compact_csr.indices[e0:e1],
                    compact_csr.data[e0:e1], bs_cap,
                )
                self.x = score_ops.scatter_rows_sliced(
                    self.x, jnp.asarray(coo), np.int32(s0), bs_cap
                )
            return
        rows_all = row_offset + np.repeat(
            np.arange(compact_csr.n_rows, dtype=np.int64),
            np.diff(compact_csr.indptr),
        )
        chunk = 1 << 22  # ~48 MB of packed COO per dispatch
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            coo = pack_coo_i32(
                rows_all[s:e], compact_csr.indices[s:e],
                compact_csr.data[s:e], self.row_cap,
            )
            self.x = score_ops.scatter_coo(self.x, jnp.asarray(coo))

    def _append_shadow(self, csr: CSRMatrix) -> None:
        nnz = int(csr.indptr[-1])
        need_rows = self._sh_rows + csr.n_rows + 1
        if need_rows > self._sh_indptr.size:
            cap = max(self._sh_indptr.size * 2, need_rows, 1024)
            grown = np.zeros(cap, dtype=np.int64)
            grown[: self._sh_rows + 1] = self._sh_indptr[: self._sh_rows + 1]
            self._sh_indptr = grown
        need_nnz = self._sh_nnz + nnz
        if need_nnz > self._sh_indices.size:
            cap = max(self._sh_indices.size * 2, need_nnz, 4096)
            gi = np.empty(cap, dtype=np.int32)
            gi[: self._sh_nnz] = self._sh_indices[: self._sh_nnz]
            gd = np.empty(cap, dtype=np.float64)
            gd[: self._sh_nnz] = self._sh_data[: self._sh_nnz]
            self._sh_indices, self._sh_data = gi, gd
        base = self._sh_indptr[self._sh_rows]
        self._sh_indptr[
            self._sh_rows + 1 : self._sh_rows + csr.n_rows + 1
        ] = base + csr.indptr[1:]
        self._sh_indices[self._sh_nnz : self._sh_nnz + nnz] = csr.indices[:nnz]
        self._sh_data[self._sh_nnz : self._sh_nnz + nnz] = csr.data[:nnz]
        self._sh_rows += csr.n_rows
        self._sh_nnz += nnz

    def shadow_csr(self) -> CSRMatrix:
        """Host fp64 CSR over the external dim space (exact oracle view).
        Returns views into the growable arrays — treat as read-only."""
        return CSRMatrix(
            self._sh_rows,
            self.cfg.vector_dim,
            self._sh_indptr[: self._sh_rows + 1],
            self._sh_indices[: self._sh_nnz],
            self._sh_data[: self._sh_nnz],
        )

    def _shadow_scipy(self):
        """Cached prebuilt scipy matrix for bulk rescores (keyed by corpus
        state; construction costs O(corpus nnz))."""
        key = (self._sh_rows, self._sh_nnz)
        if self._scipy_cache is None or self._scipy_cache[0] != key:
            sh = self.shadow_csr()
            self._scipy_cache = (
                key,
                rescore_ops.as_scipy(
                    sh.indptr, sh.indices, sh.data, sh.n_cols
                ),
            )
        return self._scipy_cache[1]

    def _shadow_compact(self):
        """Cached compact-dim translation of the shadow CSR for the grouped
        native rescore (keyed by corpus state like the scipy cache; build is
        O(vector_dim + nnz) ~10 ms at Enron scale, so bulk joins amortize it
        but per-insert-batch rebuilds would not — streaming rescores keep the
        merge path)."""
        if not rescore_ops.grouped_available():
            return None  # pair_dots would discard it (no native lib)
        key = (self._sh_rows, self._sh_nnz)
        cached = getattr(self, "_compact_cache", None)
        if cached is None or cached[0] != key:
            sh = self.shadow_csr()
            cached = (
                key,
                rescore_ops.build_compact(sh.indices, sh.n_cols),
            )
            self._compact_cache = cached
        return cached[1]

    # -------------------------------------------------------------- all_pairs
    def all_pairs(self, tau: float | None = None) -> PairResult:
        """Exact thresholded all-pairs cosine join over the current index.

        Device pass keeps candidates at ``tau - margin`` (fused matmul +
        threshold + bitpack per tile); host fp64 rescore decides the final
        set — identical to the float64 brute-force oracle by construction.
        """
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        if self.n_rows == 0:
            return PairResult(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), [],
            )
        with self._maybe_trace(), self.timer.section("all_pairs"):
            return self._all_pairs_timed(tau)

    def _maybe_trace(self):
        """jax.profiler trace context when ``profile_dir`` is configured
        (SURVEY.md §5 tracing hook); no-op otherwise."""
        import contextlib

        if not self.cfg.profile_dir:
            return contextlib.nullcontext()
        from ..utils.logging import profile_trace

        return profile_trace(self.cfg.profile_dir)

    def _all_pairs_timed(self, tau: float) -> PairResult:
        tau_eff = self._tau_eff(tau)
        tile = self._tile()
        cap = int(self.cfg.extract_cap)
        grp = int(self.cfg.extract_group)
        if self._int8_ok():
            with self.timer.section("score_extract"):
                i, j = self._all_pairs_int8(tau_eff, cap)
        else:
            self._used_int8 = False  # XLA path: demotion check must not act
            with self.timer.section("score_extract"):
                while True:
                    bufs, packed = score_ops.allpairs_extract(
                        self.x, tau_eff, tile, cap, "upper",
                        self.cfg.matmul_precision, grp,
                    )
                    pairs = self._consume_match(bufs, packed, cap, grp)
                    if pairs is not None:
                        break
                    cap = _next_cap(cap, self._last_needed)
                i, j = pairs
        self.stats["candidates_scored"] += self.n_rows * self.n_rows
        with self.timer.section("rescore"):
            res = self._finalize_pairs(i, j, tau)
        # adaptive int8 demotion: the quantization bound is a proven superset
        # on ANY data, but if a corpus makes it admit vastly more candidates
        # than the true result, the extraction/fetch/rescore tax outweighs
        # the int8 rate — fall back to the float path (narrower margin)
        # from the next call on
        if self._used_int8 and len(i) > max(16 * res.n_pairs, 1_000_000):
            self._int8_off = True
            self._int8_cache = None  # release the q8+aux HBM copies now
            from ..utils.logging import get_logger

            get_logger().info(
                "int8 bound admitted %d candidates for %d pairs; "
                "demoting this engine to float scoring", len(i), res.n_pairs,
            )
        return res

    def _int8_allowed(self) -> bool:
        """int8 scoring is enabled, not demoted, not overridden by the
        "highest" precision policy, and safe for the int32 accumulator
        (D <= 127^2 * max_nnz)."""
        return (
            bool(self.cfg.pallas_int8)
            and not self._int8_off
            and self.cfg.matmul_precision != "highest"
            and self._max_row_nnz() < ((1 << 30) // (127 * 127))
        )

    def _int8_ok(self) -> bool:
        """Score all_pairs at int8 over panel pairs (``ops/panel.py``)?
        Needs a single-device index whose row capacity tiles into 64-row
        supers and whose bit-packed hit structure (~row_cap²/14 bytes) fits
        its device-memory share; otherwise the XLA float path runs."""
        if self.x is None or len(self.x.devices()) != 1:
            return False
        from ..utils import memory

        fits = self.row_cap * self.row_cap // 14 <= memory.budget(
            memory.HIT_BITS
        )
        return self._int8_allowed() and self.row_cap % 64 == 0 and fits

    # tallest panel of the dense int8 join: its int32 score rectangle is
    # rb² · 4 bytes (268 MB at 8192)
    _int8_panel_rows = 8192

    def _int8_index(self):
        """(q8, aux) int8 copy of the index, cached by the identity of x."""
        from ..ops import panel

        cached = self._int8_cache
        if cached is None or cached[0] is not self.x:
            q8, aux = panel.quantize_rows(self.x)
            cached = (self.x, q8, aux)
            self._int8_cache = cached
        return cached[1], cached[2]

    def _all_pairs_int8(self, tau_eff, cap: int):
        import jax.numpy as jnp

        from ..ops import bits, panel
        from ..vector.batch import pow2_bucket

        self._used_int8 = True
        x_q8, x_aux = self._int8_index()
        rb = panel.panel_rows_for(self.row_cap, self._int8_panel_rows)
        pi, pj = (jnp.asarray(a) for a in
                  panel.upper_panel_pairs(self.row_cap // rb))
        # per-level caps, cached across calls so steady-state joins hit the
        # compiled shapes immediately (pow2-bucketed to bound recompiles)
        cap, capb, cap0 = getattr(
            self, "_int8_caps",
            (pow2_bucket(cap, 1024), 0, 0),
        )
        # u32-packed result head (row<<16|col) halves the dominant D2H
        # transfer whenever rows and cols fit 16 bits
        pack = self.row_cap <= 65536
        while True:
            eff_capb = capb or score_ops.capb_for(cap, bits.GROUP)
            eff_cap0 = cap0 or eff_capb  # generous: avoids a first-call
            # overflow retry (an extra cold executable); tightening shrinks
            # it to the observed counts from call 2 on
            bufs, packed = panel.allpairs_extract_int8(
                x_q8, x_aux, pi, pj, tau_eff, rb, cap, eff_capb, eff_cap0,
                pack_head=pack,
            )
            rows, cols, total, groups, supers = bits.unpack_head(
                np.asarray(packed)
            )
            if total > cap or groups > eff_capb or supers > eff_cap0:
                cap = pow2_bucket(max(total, cap), 1024)
                capb = pow2_bucket(max(groups, eff_capb), 1024)
                cap0 = pow2_bucket(max(supers, eff_cap0), 1024)
                continue
            # steady-state cap TIGHTENING (8x hysteresis): each level's
            # nonzero/gather domain scales with its cap, so a one-off spike
            # (or a generous config default) would otherwise tax every later
            # join.  A shrink recompiles once per shape (persistent cache)
            # and an upward tau switch past the shrunk cap pays one overflow
            # retry, so only shrink on gross (≥8x) oversize — tau sweeps
            # within an 8x pair-count band never flap.
            self._int8_caps = score_ops.tighten_caps(
                (total, groups, supers), (cap, eff_capb, eff_cap0)
            )
            if total <= rows.size:
                return rows, cols
            return score_ops.decode_pairs(bufs, total)

    def _finalize_pairs(self, i: np.ndarray, j: np.ndarray, tau: float) -> PairResult:
        if i.size == 0:
            return PairResult(i, j, np.empty(0, np.float64), list(self.ids))
        shadow = self.shadow_csr()
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data, i, j, shadow.n_cols,
            mat_fn=self._shadow_scipy,
            compact=self._shadow_compact(),
        )
        keep = sims >= tau
        i, j, sims = i[keep], j[keep], sims[keep]
        self.stats["pairs_emitted"] += i.size
        return PairResult(i, j, sims, list(self.ids))

    # ----------------------------------------------------------------- insert
    def insert(
        self,
        vectors: Sequence[Tuple[str, SparseVector]],
        tau: float | None = None,
        bulk: bool = False,
        defer: bool = False,
    ) -> "SimilarityOutput | PendingInsert":
        with self._maybe_trace(), self.timer.section("insert"):
            return self._insert_impl(vectors, tau, bulk, defer)

    def _insert_impl(
        self,
        vectors: Sequence[Tuple[str, SparseVector]],
        tau: float | None = None,
        bulk: bool = False,
        defer: bool = False,
    ) -> "SimilarityOutput | PendingInsert":
        """Streaming micro-batch insert matched online against the live index.

        Reproduces the reference streaming path semantics in order:
          1. drop components with ``value <= index_threshold``
             (WriteWorkerActor.scala:192, fine-print #5);
          2. max-weight admission pruning at the entry
             (EntryProxyActor.scala:81-93) — configurable: the reference's
             all-1.0 stub, real running max weights, or off;
          3. index-before-query: the batch joins the index first, then every
             batch vector queries, so intra-batch pairs surface symmetrically
             (IndexingWorkerActor.scala:123-132, fine-print #2);
          4. when frozen (benchmark mode), skip indexing but keep querying
             (IndexingWorkerActor.scala:143-144).

        ``bulk=True`` is the LoadData/HBase ingest path: it skips the
        component filter and admission pruning (both live on the VectorIOMsg
        path only — WriteWorkerActor.scala:185-202 vs :153-161) but still
        matches online.
        """
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        self.stats["insert_batches"] += 1
        filtered: List[Tuple[str, SparseVector]] = []
        for vid, vec in vectors:
            if not bulk:
                if self.cfg.index_threshold > 0:
                    vec = vec.filter_values_above(self.cfg.index_threshold)
                if not self._admit(vec, tau):
                    self.stats["vectors_dropped_admission"] += 1
                    continue
            filtered.append((vid, vec))
        if not filtered:
            empty = SimilarityOutput({}, time.time())
            return _CompletedInsert(empty) if defer else empty
        csr, new_ids = _as_csr(filtered, None, self.cfg.vector_dim)

        if self._frozen:
            out = self._match_external(csr, new_ids, tau)
            return _CompletedInsert(out) if defer else out

        n0 = self.n_rows
        dorm0 = self._dorm_rows.size  # archive rollback point (see below)
        keep_csr = self._stream_archive_singletons(csr, n0)
        self._grow_for(csr, extend=False)
        # activation entries are COLLECTED so the fused path can scatter
        # them in the same device call as the batch (saves one round trip)
        act = self._activate_dormant(csr.indices, collect=True)
        compact_csr = self.compact.map_csr(keep_csr, extend=False)
        # host bookkeeping first so the error margin (tau_eff) already covers
        # the batch's norms before any device scoring
        self.n_rows = n0 + csr.n_rows
        for k, vid in enumerate(new_ids):
            self.id_to_row[vid] = n0 + k
        self.ids.extend(new_ids)
        self._append_shadow(csr)
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self._note_norms(csr)
        self.stats["vectors_indexed"] += csr.n_rows

        try:
            return self._insert_device_phase(
                csr, new_ids, act, compact_csr, n0, tau, defer
            )
        except Exception:
            # device failure after the host commit: roll back to the
            # pre-batch state so the caller's drop/retry sees a consistent
            # engine (no phantom rows) — see _recover_insert
            self._recover_insert(n0, csr.n_rows, dorm0)
            raise

    def _insert_device_phase(self, csr, new_ids, act, compact_csr, n0, tau,
                             defer):
        tau_eff = self._tau_eff(tau)
        tile = self._tile()
        first_tile = (n0 // tile) * tile
        grp = int(self.cfg.extract_group)
        cap = self._insert_cap or int(self.cfg.extract_cap)
        cand_q: List[np.ndarray] = []
        cand_c: List[np.ndarray] = []

        single_tile = (self.n_rows - 1) // tile == n0 // tile
        # boundary-crossing batches (every tile/batch-th insert) used to
        # fall to the separate scatter + per-tile match path (3 dispatches
        # ≈ 3 host-link round trips); a 2-tile window keeps them fused —
        # one extra compiled shape, and the window must not run off the
        # row capacity (row_cap is tile-aligned, not necessarily 2·tile)
        two_tile = (
            not single_tile
            and (self.n_rows - 1) // tile == n0 // tile + 1
            and first_tile + 2 * tile <= self.row_cap
        )
        if (single_tile or two_tile) and csr.n_rows <= 4096:
            win = tile if single_tile else 2 * tile
            self.stats["insert_fused" if single_tile else "insert_fused2"] += 1
            # fused append+match: one device round trip per micro-batch;
            # flat COO keeps H2D at O(nnz).  The batch's rows are shipped
            # LOCAL to a slice window so the device append is a small-buffer
            # scatter + DMA slice, not an O(index) full-output scatter pass
            # (see insert_match_fused).  Activated dormant entries touch
            # older non-contiguous rows — they go through their own async
            # scatter dispatch first (index-before-query order preserved)
            from ..vector.batch import pow2_bucket
            import jax.numpy as jnp

            if act is not None:
                self._scatter_activation(act)
                self._commit_activation(act)
            bs_cap = min(pow2_bucket(csr.n_rows, 256), self.row_cap)
            s0 = max(0, min(n0, self.row_cap - bs_cap))
            rows_b = (n0 - s0) + np.repeat(
                np.arange(csr.n_rows, dtype=np.int64),
                np.diff(compact_csr.indptr),
            )
            cols_b = compact_csr.indices.astype(np.int64)
            vals_b = compact_csr.data
            coo = pack_coo_i32(rows_b, cols_b, vals_b, bs_cap)
            self.x, bufs, packed = score_ops.insert_match_fused(
                self.x, jnp.asarray(coo),
                np.int32(s0), np.int32(first_tile), np.int32(n0), tau_eff,
                win, cap, bs_cap, self.cfg.matmul_precision, grp,
            )
            self.stats["candidates_scored"] += self.n_rows * min(
                win, self.n_rows - first_tile
            )
            # the pending carries the WINDOW as its tile so an overflow
            # retry re-matches the same [first_tile, first_tile+win) span
            pending = PendingInsert(
                self, bufs, packed, cap, grp, n0, self.n_rows,
                first_tile, tau_eff, win, tau,
            )
            return pending if defer else pending.result()
        self.stats["insert_slowpath"] += 1
        if act is not None:
            self._scatter_activation(act)
            self._commit_activation(act)
        self._scatter_rows(compact_csr, row_offset=n0)
        # windowed dispatch: enqueue up to 8 tile matches before consuming
        # any — each consume is a blocking head fetch, so the serialized
        # per-tile fetch dominated large
        # flush batches; async prefetch overlaps all of a window's fetches
        # with each other and with the later tiles' device work.  8 tiles
        # bound the in-flight candidate buffers to 8 × 2 × cap int32s.
        tiles = list(range(first_tile, self.n_rows, tile))
        for w0 in range(0, len(tiles), 8):
            calls = []
            for q0 in tiles[w0 : w0 + 8]:
                bufs, packed = score_ops.match_tile_extract(
                    self.x, np.int32(q0), np.int32(n0), tau_eff, tile, cap,
                    self.cfg.matmul_precision, grp,
                )
                try:
                    packed.copy_to_host_async()
                except AttributeError:
                    pass
                calls.append((q0, bufs, packed))
                self.stats["candidates_scored"] += self.n_rows * min(
                    tile, self.n_rows - q0
                )
            for q0, bufs, packed in calls:
                pairs = self._consume_match(bufs, packed, cap, grp)
                if pairs is None:  # overflow: retry this tile, grown cap
                    pairs = self._match_tile_retry(
                        q0, n0, tau_eff, tile,
                        _next_cap(cap, self._last_needed), grp,
                    )
                else:
                    self._note_insert_cap(pairs[0].size, cap)
                cand_c.append(pairs[0])
                cand_q.append(pairs[1])
        out = self._emit_query_results(
            np.concatenate(cand_q), np.concatenate(cand_c), tau
        )
        return _CompletedInsert(out) if defer else out

    def _recover_insert(self, n0: int, n_batch: int,
                        dorm0: int | None = None) -> None:
        """Roll back a failed micro-batch insert: truncate host bookkeeping
        to the pre-batch state and rebuild the device index from the shadow
        (the donated/poisoned device buffers cannot be trusted after an
        execution error).  Without this, a device failure left PHANTOM rows
        — present in the shadow/ids but absent from every device result —
        and the server's poison-drop handler persisted them as indexed.
        max_weights and the norm margin are NOT rolled back: both are upper
        bounds, so keeping the dropped batch's contribution is conservative.
        Only safe when nothing was appended after the failed batch (the
        server's one-deep pipeline guarantees that); otherwise we re-raise
        without touching state."""
        if self.n_rows != n0 + n_batch:
            return  # later inserts landed; cannot roll back safely
        if dorm0 is not None and self._dorm_rows.size > dorm0:
            # roll back this batch's dormant-archive appends too: a stale
            # entry references a rolled-back row, so a later _dormant_hits
            # would emit candidate rows >= n_rows (out-of-range into the
            # shadow/ids) and a later activation would scatter the value
            # into a device row owned by a DIFFERENT re-inserted vector
            dims_added = self._dorm_dims[dorm0:]
            self._dormant_of_ext[dims_added] = -1
            self._dorm_rows = self._dorm_rows[:dorm0]
            self._dorm_dims = self._dorm_dims[:dorm0]
            self._dorm_vals = self._dorm_vals[:dorm0]
            self.stats["dormant_dims"] -= int(dims_added.size)
        row_cap, dim_cap = self.row_cap, self.dim_cap
        self.n_rows = n0
        del self.ids[n0:]
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        # truncate the growable shadow arrays (O(1): tail reused on append)
        self._sh_rows = n0
        self._sh_nnz = int(self._sh_indptr[n0])
        self._scipy_cache = None
        self.stats["vectors_indexed"] -= n_batch
        shadow = self.shadow_csr()
        compact_csr = self.compact.map_csr(
            self._drop_unmapped(shadow), extend=False
        )
        self.x = self._place(
            score_ops.new_index_matrix(row_cap, dim_cap, self.cfg.dtype)
        )
        self._scatter_rows(compact_csr, row_offset=0)
        # the rebuild just scattered EVERY mapped shadow entry — including
        # archived entries whose dim this batch promoted (compact.extend is
        # not rolled back).  Their archive marks are now stale: a later
        # activation would scatter the value a SECOND time, inflating that
        # row's device score beyond the margin and breaking topk's exact
        # fetch.  Commit (clear) the marks of every mapped dim now.
        if self._dormant_of_ext is not None:
            marked = np.nonzero(self._dormant_of_ext >= 0)[0]
            if marked.size:
                mapped = self.compact.cols_of(marked) >= 0
                n_clear = int(mapped.sum())
                if n_clear:
                    self._dormant_of_ext[marked[mapped]] = -1
                    self.stats["dormant_dims"] -= n_clear
        self._int8_cache = None

    def _match_tile_retry(self, q0, lo, tau_eff, tile, cap, grp):
        """Match one tile, auto-growing cap; returns (rows, cols) arrays."""
        while True:
            bufs, packed = score_ops.match_tile_extract(
                self.x, np.int32(q0), np.int32(lo), tau_eff, tile, cap,
                self.cfg.matmul_precision, grp,
            )
            pairs = self._consume_match(bufs, packed, cap, grp)
            if pairs is not None:
                self._note_insert_cap(pairs[0].size, cap)
                return pairs
            cap = _next_cap(cap, self._last_needed)

    # adaptive streaming-insert extraction cap (r3 #4): None = config default
    _insert_cap: int | None = None

    def _note_insert_cap(self, total: int, cap_used: int) -> None:
        """Adapt the streaming-insert extraction cap to observed candidate
        counts.  The fused insert used the generous config default (2^18)
        on EVERY micro-batch, paying cap-scaled compaction + buffer cost
        for counts that are typically a few hundred — the same oversize tax
        the join's ``_int8_caps`` tightening removed.  Same 8x-hysteresis
        shrink rule; an overflow-retry's grown cap persists so later batches skip the
        retry.  Each adopted cap is one new compiled shape (pow2 ladder,
        persistent cache)."""
        from ..vector.batch import pow2_bucket

        cur = self._insert_cap or int(self.cfg.extract_cap)
        tight = pow2_bucket(max(int(total) + (int(total) >> 2), 1024), 1024)
        if cap_used > cur:
            self._insert_cap = cap_used
        elif tight * 8 <= cur:
            self._insert_cap = tight

    def _consume_match(self, bufs, packed, cap: int, grp: int):
        """Parse a match result; returns (rows, cols) or None on capacity
        overflow (setting ``self._last_needed``)."""
        pairs, needed = score_ops.consume_packed(
            bufs, np.asarray(packed), cap, grp
        )
        if pairs is None:
            self._last_needed = needed
        return pairs

    def set_max_weight_map(self, weights: np.ndarray) -> None:
        """Install precomputed corpus-wide per-dim max weights (the
        ``<table>_MAX`` statistic, ``VectorStore.max_weights``) for exact
        ``admission="real"`` pruning — the thing the reference computes
        (HBaseUpLoader.scala:113-123) but never loads back."""
        if weights.shape != (self.cfg.vector_dim,):
            raise ValueError("max weight map must cover vector_dim")
        self._static_max_weights = np.asarray(weights, dtype=np.float64)

    def _admit(self, vec: SparseVector, tau: float) -> bool:
        """Upper-bound admission: dot(max_weights|support, v) >= tau
        (EntryProxyActor.scala:81-93).

        "real" with a static corpus map (``set_max_weight_map``) is exactly
        lossless: the bound covers every corpus vector.  Without one, the
        running-maxima bound is made self-inclusive (``max(m_d, v_d)``) so it
        still dominates the similarity against everything seen so far — but a
        *later* vector with larger weights can in principle form a pair with
        an already-dropped one; use the static map when strict losslessness
        against future inserts matters (documented in PARITY.md).
        """
        mode = getattr(self.cfg, "admission", "ones")
        if mode == "off" or vec.nnz == 0:
            return vec.nnz > 0
        if mode == "real":
            static = getattr(self, "_static_max_weights", None)
            if static is not None:
                # the static map covers the STORED corpus; streamed vectors
                # may exceed it, so fold in the running maxima (and the
                # vector itself) — otherwise a heavy streamed v1 followed by
                # a light v2 could drop v2 despite cos(v1, v2) >= tau,
                # breaking the "exactly lossless" contract
                bound = np.maximum(
                    static[vec.indices],
                    np.maximum(self.max_weights[vec.indices], vec.values),
                )
                admit = float(np.dot(bound, vec.values)) >= tau
            else:
                bound = np.maximum(self.max_weights[vec.indices], vec.values)
                admit = float(np.dot(bound, vec.values)) >= tau
            if not admit:
                # record the dropped vector's weights so future bounds
                # account for it
                np.maximum.at(self.max_weights, vec.indices, vec.values)
            return admit
        # "ones": the reference's stub map (all weights 1.0)
        return float(np.sum(vec.values)) >= tau

    def _stream_archive_singletons(
        self, csr: CSRMatrix, row_offset: int
    ) -> CSRMatrix:
        """Streaming analog of the build-time dormant tier: a brand-new dim
        seen exactly ONCE (once in this batch, never before, not already
        archived) cannot contribute to any i≠j pair yet, so its single entry
        is archived host-side instead of minting a compact column — without
        this, long streams inflate dim_cap far past the build path's
        (Enron streamed end-to-end: K = 131072 vs 73728 built, ~1.8× extra
        matmul/extract work on every later insert).  Dims appearing ≥2×
        in the batch, or whose archived partner just arrived, are promoted
        (extended; `_activate_dormant` then moves the archived entry onto
        the device).  Returns the csr filtered to device-bound entries; the
        caller's shadow append keeps every entry, so exactness is untouched.
        """
        if not self.cfg.dormant_dims:
            self.compact.extend(csr.indices)
            return csr
        cols = self.compact.cols_of(csr.indices)
        newm = cols < 0
        if not newm.any():
            return csr
        if self._dormant_of_ext is None:
            self._dormant_of_ext = np.full(
                self.cfg.vector_dim, -1, np.int32
            )
        uniq, counts = np.unique(csr.indices[newm], return_counts=True)
        in_archive = self._dormant_of_ext[uniq] >= 0
        promote = uniq[(counts >= 2) | in_archive]
        singles = uniq[(counts == 1) & ~in_archive]
        if promote.size:
            self.compact.extend(promote)
        if singles.size == 0:
            return csr
        mark = np.zeros(self.cfg.vector_dim, bool)
        mark[singles] = True
        sel = mark[csr.indices]
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        arch_dims = csr.indices[sel].astype(np.int64)
        base = self._dorm_append(
            (row_offset + row_of[sel]).astype(np.int64),
            arch_dims,
            csr.data[sel].astype(np.float64),
        )
        self._dormant_of_ext[arch_dims] = base + np.arange(
            arch_dims.size, dtype=np.int32
        )
        self.stats["dormant_dims"] += int(arch_dims.size)
        keep = ~sel
        row_counts = np.zeros(csr.n_rows, np.int64)
        np.add.at(row_counts, row_of[keep], 1)
        indptr = np.zeros(csr.n_rows + 1, np.int64)
        np.cumsum(row_counts, out=indptr[1:])
        return CSRMatrix(
            csr.n_rows, csr.n_cols, indptr, csr.indices[keep],
            csr.data[keep],
        )

    def _dorm_append(self, rows, dims, vals) -> int:
        """Amortized append to the dormant archive (capacity-doubling
        buffers, exposed as views — per-batch cost O(batch), not
        O(archive)); returns the first new archive index."""
        n0 = self._dorm_rows.size
        need = n0 + rows.size
        buf = getattr(self, "_dorm_buf", None)
        if buf is None or need > buf[0].size:
            cap = 1024
            while cap < need:
                cap *= 2
            buf = (
                np.empty(cap, np.int64),
                np.empty(cap, np.int64),
                np.empty(cap, np.float64),
            )
            buf[0][:n0] = self._dorm_rows
            buf[1][:n0] = self._dorm_dims
            buf[2][:n0] = self._dorm_vals
            self._dorm_buf = buf
        buf[0][n0:need] = rows
        buf[1][n0:need] = dims
        buf[2][n0:need] = vals
        self._dorm_rows = buf[0][:need]
        self._dorm_dims = buf[1][:need]
        self._dorm_vals = buf[2][:need]
        return n0

    def _grow_for(self, csr: CSRMatrix, extend: bool = True) -> None:
        if extend:
            self.compact.extend(csr.indices)
        need_rows = round_up(self.n_rows + csr.n_rows, self._row_quantum())
        new_row_cap = self.row_cap
        while new_row_cap < need_rows:
            new_row_cap = max(new_row_cap * 2, self._row_quantum())
        new_dim_cap = self.compact.capacity
        if self.x is None:
            self.x = self._place(
                score_ops.new_index_matrix(new_row_cap, new_dim_cap, self.cfg.dtype)
            )
        elif new_row_cap != self.row_cap or new_dim_cap != self.dim_cap:
            self.x = self._place(
                score_ops.grow(self.x, new_row_cap, new_dim_cap)
            )

    def _match_external(
        self, csr: CSRMatrix, qids: List[str], tau: float
    ) -> SimilarityOutput:
        """Frozen-index matching: queries are scored but not indexed."""
        qn = csr.row_norms()
        if qn.size and float(qn.max()) > self._max_norm:
            # widen the margin for out-of-distribution query norms
            saved, self._max_norm = self._max_norm, float(qn.max())
        else:
            saved = None
        compact = self.compact.map_csr(
            self._drop_unmapped(csr), extend=False
        )
        from ..vector.batch import pow2_bucket
        import jax.numpy as jnp

        # one flat-COO H2D + one fused densify+score dispatch (the separate
        # densify call was a second round trip per frozen flush, and
        # its padded layout paid for the longest document on every row)
        q_rows = pow2_bucket(compact.n_rows, 32)
        rows_b = np.repeat(
            np.arange(compact.n_rows, dtype=np.int64),
            np.diff(compact.indptr),
        )
        coo_d = jnp.asarray(
            pack_coo_i32(rows_b, compact.indices, compact.data, q_rows)
        )
        tau_eff = self._tau_eff(tau)
        cap = int(self.cfg.extract_cap)
        grp = int(self.cfg.extract_group)
        while True:
            bufs, packed = score_ops.queries_match_fused(
                self.x, coo_d, tau_eff, q_rows, cap,
                self.cfg.matmul_precision, grp,
            )
            pairs = self._consume_match(bufs, packed, cap, grp)
            if pairs is not None:
                break
            cap = _next_cap(cap, self._last_needed)
        self.stats["candidates_scored"] += self.n_rows * len(qids)
        rows, qcols = pairs
        # queries sharing a dormant dim with an indexed row: the device score
        # missed that contribution — add those rows as explicit candidates
        extra_q, extra_r = self._dormant_hits(csr)
        if extra_q.size:
            rows = np.concatenate([np.asarray(rows), extra_r])
            qcols = np.concatenate([np.asarray(qcols), extra_q])
        # exact fp64 rescore via the native cross-pair path (this is the
        # frozen-BENCHMARK hot loop — the per-pair Python SparseVector.dot
        # it replaces cost seconds per flush at 1e5 candidates)
        shadow = self.shadow_csr()
        out: Dict[str, Dict[str, float]] = {}
        if len(rows):
            rows_a = np.asarray(rows, np.int64)
            qcols_a = np.asarray(qcols, np.int64)
            sims = rescore_ops.cross_pair_dots(
                shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                csr.indptr, csr.indices, csr.data, qcols_a, rows_a,
            )
            keep = sims >= tau
            for r, qc, s in zip(rows_a[keep], qcols_a[keep], sims[keep]):
                out.setdefault(qids[int(qc)], {})[self.ids[int(r)]] = float(s)
        self.stats["pairs_emitted"] += sum(len(v) for v in out.values())
        if saved is not None:
            self._max_norm = saved
        return SimilarityOutput(out, time.time())

    def _drop_unmapped(self, csr: CSRMatrix) -> CSRMatrix:
        """Remove components in dims absent from the device index.  For a
        QUERY this may drop dormant dims that live only in the host archive —
        callers on the query path must add back ``_dormant_hits`` candidates
        so no pair is lost."""
        mapped = self.compact.cols_of(csr.indices) >= 0
        if mapped.all():
            return csr
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        counts = np.zeros(csr.n_rows, dtype=np.int64)
        np.add.at(counts, row_of[mapped], 1)
        indptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRMatrix(
            csr.n_rows, csr.n_cols, indptr, csr.indices[mapped], csr.data[mapped]
        )

    # ------------------------------------------------------------ dormant dims
    def _archive_dormant(self, csr: CSRMatrix) -> CSRMatrix:
        """Archive build entries in dims the compact space left unmapped
        (df==1: no i≠j pair can use them) and return the filtered CSR.  The
        shadow CSR keeps EVERY entry, so the fp64 rescore — and thus the
        emitted pair set — is unaffected; only the device matmul K shrinks."""
        # reset any previous build's archive FIRST: a rebuild whose corpus has
        # no df==1 dims must not leave stale (_dorm_rows, _dormant_of_ext)
        # pointing at rows of the old corpus (stale entries would feed
        # out-of-range candidate rows into _dormant_hits)
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dorm_buf = None
        self._dormant_of_ext = None
        self.stats["dormant_dims"] = 0
        mapped = self.compact.cols_of(csr.indices) >= 0
        if mapped.all():
            return csr
        keep = ~mapped
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        self._dorm_rows = row_of[keep].astype(np.int64)
        self._dorm_dims = csr.indices[keep].astype(np.int64)
        self._dorm_vals = csr.data[keep].astype(np.float64)
        self._dormant_of_ext = np.full(self.cfg.vector_dim, -1, np.int32)
        # df==1 ⇒ each dormant dim has exactly one archived entry
        self._dormant_of_ext[self._dorm_dims] = np.arange(
            self._dorm_dims.size, dtype=np.int32
        )
        self.stats["dormant_dims"] = int(self._dorm_dims.size)
        return self._drop_unmapped(csr)

    def _activate_dormant(self, ext_dims: np.ndarray, collect: bool = False):
        """Insert-time activation: dims of the incoming batch that were
        dormant just received compact columns; their archived entries must
        now live on the device so new×old pairs through those dims score
        correctly.  With ``collect=True`` the (rows, compact cols, vals)
        arrays are RETURNED instead of scattered so the caller can fold them
        into an already-planned device call (the fused insert) — saving one
        dispatch round trip per micro-batch."""
        if self._dormant_of_ext is None:
            return None
        uniq = np.unique(np.asarray(ext_dims))
        idxs = self._dormant_of_ext[uniq]
        sel = idxs >= 0
        if not sel.any():
            return None
        dims, idxs = uniq[sel], idxs[sel]
        cols = self.compact.cols_of(dims).astype(np.int64)
        # still-unmapped archived dims (this batch's fresh singletons) stay
        # archived — only dims that just received a compact column activate
        ok = cols >= 0
        if not ok.any():
            return None
        dims, idxs, cols = dims[ok], idxs[ok], cols[ok]
        rows = self._dorm_rows[idxs]
        vals = self._dorm_vals[idxs]
        # NOTE: the archive marks are NOT cleared here — the caller commits
        # them (``_commit_activation``) after the device call that scatters
        # the entries succeeds.  Clearing first would silently lose the
        # entries if anything raises in between; the opposite failure mode
        # (entries scattered but still marked → a later activation adds them
        # again) only inflates device scores, which the margin/rescore
        # contract absorbs as a superset.
        act = (rows, cols, vals, dims)
        if collect:
            return act
        self._scatter_activation(act)
        self._commit_activation(act)
        return None

    def _commit_activation(self, act) -> None:
        dims = act[3]
        self._dormant_of_ext[dims] = -1
        self.stats["dormant_dims"] -= int(dims.size)

    def _scatter_activation(self, act) -> None:
        rows, cols, vals = act[0], act[1], act[2]
        from ..vector.batch import pow2_bucket

        cap = pow2_bucket(rows.size, 256)
        pad = cap - rows.size
        self.x = score_ops.scatter_entries(
            self.x,
            np.concatenate(
                [rows, np.full(pad, self.row_cap, np.int64)]
            ).astype(np.int32),
            np.concatenate([cols, np.zeros(pad, np.int64)]).astype(np.int32),
            np.concatenate([vals, np.zeros(pad)]).astype(np.float32),
        )

    def _dormant_hits(self, csr: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
        """External-query correction: unique (query_idx, index_row) pairs
        that share a dormant dim — the device score misses that contribution,
        so these rows must join the rescore candidate set explicitly."""
        if self._dormant_of_ext is None or self._dorm_dims.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        look = self._dormant_of_ext[csr.indices]
        hit = look >= 0
        if not hit.any():
            return np.empty(0, np.int64), np.empty(0, np.int64)
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        q = row_of[hit].astype(np.int64)
        r = self._dorm_rows[look[hit]]
        key = q * (self.n_rows + 1) + r
        _, first = np.unique(key, return_index=True)
        return q[first], r[first]

    def _emit_query_results(
        self, qrows: np.ndarray, crows: np.ndarray, tau: float
    ) -> SimilarityOutput:
        """qrows: query row index (batch member), crows: candidate row index;
        exact-rescore and shape into the reference's query->candidates map."""
        if qrows.size == 0:
            return SimilarityOutput({}, time.time())
        shadow = self.shadow_csr()
        # mat_fn (not an eager mat): with the native merge available the
        # scipy matrix is never touched, and eagerly rebuilding it here cost
        # O(corpus nnz) on EVERY streaming batch (the cache key changes per
        # insert).  No compact= either, for the same per-batch-rebuild reason.
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data, qrows, crows,
            shadow.n_cols, mat_fn=self._shadow_scipy,
        )
        keep = sims >= tau
        out: Dict[str, Dict[str, float]] = {}
        for q, c, s in zip(qrows[keep], crows[keep], sims[keep]):
            out.setdefault(self.ids[int(q)], {})[self.ids[int(c)]] = float(s)
        self.stats["pairs_emitted"] += int(keep.sum())
        return SimilarityOutput(out, time.time())

    # ------------------------------------------------------------------- topk
    def topk(
        self,
        queries: Sequence[Tuple[str, SparseVector]],
        k: int,
    ) -> Dict[str, List[Tuple[str, float]]]:
        """k nearest cosine neighbors per query over the static index
        (BASELINE.json config #4).

        Reported scores are exact float64 and the RESULT SET is provably
        exact (up to ties at the k-th true score, where any valid selection
        is returned): the device ranks candidates, we fetch the top
        ``k_fetch`` and keep growing ``k_fetch`` until the margin condition
        ``min(fetched device scores) < (k-th fetched device score) − 2m``
        holds, where ``m`` bounds the device scoring error.  Proof sketch:
        every true-top-k member c has ``dev(c) ≥ true(c) − m ≥ t* − m``
        where ``t*`` is the k-th largest true score, and ``t* ≥ dev_k − m``
        since the k best-by-device candidates all have true score
        ``≥ dev_k − m``; hence ``dev(c) ≥ dev_k − 2m`` and c is fetched once
        every candidate scoring above that cutoff is.  The fetched set is
        then rescored in float64 and re-ranked — the same
        superset-then-exact-rescore contract as the thresholded join.
        Device scoring always runs at "highest" precision here so the margin
        (and thus the fetch depth) stays small even in bf16 index mode.
        """
        if self.n_rows == 0:
            return {qid: [] for qid, _ in queries}
        k_eff = min(k, self.n_rows)
        csr, qids = _as_csr(list(queries), None, self.cfg.vector_dim)
        compact = self.compact.map_csr(self._drop_unmapped(csr), extend=False)
        from ..vector.batch import pow2_bucket

        import jax.numpy as jnp

        # flat-COO query transfer + fused on-device densify (the separate
        # densify was one extra dispatch round trip per topk call; the
        # densify re-runs per margin-growth fetch, but that scatter is
        # O(batch nnz) — noise next to the [q, row_cap] scoring matmul)
        q_rows = pow2_bucket(compact.n_rows, 32)
        rows_b = np.repeat(
            np.arange(compact.n_rows, dtype=np.int64),
            np.diff(compact.indptr),
        )
        coo_d = jnp.asarray(
            pack_coo_i32(rows_b, compact.indices, compact.data, q_rows)
        )
        nq = len(qids)

        def fetch(kf: int):
            s, r = score_ops.topk_scores_fused(
                self.x, coo_d, np.int32(self.n_rows), q_rows, kf, "highest"
            )
            return np.asarray(s)[:nq], np.asarray(r)[:nq]

        q_norms = csr.row_norms()
        qmax = float(q_norms.max()) if q_norms.size else 0.0
        m = self._margin_rel("highest") * max(self._max_norm * qmax, 1.0)
        rows, k_fetch = fetch_exact_topk(fetch, self.n_rows, k_eff, 2 * m)
        # exact fp64 rescore of the fetched candidates (queries vs shadow;
        # no stacked copy of the corpus); rows reachable only through a
        # dormant dim join the candidate set explicitly (the device score
        # missed that contribution, so the margin bound alone can't cover them)
        shadow = self.shadow_csr()
        qi_idx = np.repeat(np.arange(nq), k_fetch)
        cand_idx = rows.reshape(-1).astype(np.int64)
        extra_q, extra_r = self._dormant_hits(csr)
        if extra_q.size:
            qi_idx = np.concatenate([qi_idx, extra_q])
            cand_idx = np.concatenate([cand_idx, extra_r])
        sims = rescore_ops.cross_pair_dots(
            shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
            csr.indptr, csr.indices, csr.data, qi_idx, cand_idx,
        )
        return assemble_topk(qids, qi_idx, cand_idx, sims, k_eff, self.ids)

    # ----------------------------------------------------------------- freeze
    def freeze(self) -> None:
        """Benchmark freeze: stop index updates, keep serving queries
        (the ReceiveTimeout branch, IndexingWorkerActor.scala:143-144)."""
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Checkpoint = host CSR shadow + id table + compact order + stats
        (SURVEY.md §5: the reference has no checkpointing at all; its index is
        lost on actor relocation)."""
        os.makedirs(path, exist_ok=True)
        shadow = self.shadow_csr()
        meta = {
            "ids": self.ids,
            "n_rows": self.n_rows,
            "config": {
                "vector_dim": self.cfg.vector_dim,
                "similarity_threshold": self.cfg.similarity_threshold,
                "dtype": self.cfg.dtype,
            },
            "stats": self.stats,
        }
        # crash-safe: all restore state lives in ONE npz (meta embedded as a
        # JSON string) swapped into place with os.replace; meta.json is a
        # human-readable mirror written second, so a crash at any point
        # leaves either the old or the new snapshot, never a torn mix
        npz_tmp = os.path.join(path, ".index.npz.tmp")
        with open(npz_tmp, "wb") as f:
            # NOTE: the compact column order is NOT stored — restore()
            # re-derives it with from_csr (df-ordered), which is what every
            # reader does; serializing the live order implied a round-trip
            # guarantee nothing consumed
            # uncompressed: fp64 TF-IDF data is near-incompressible, and
            # zlib dominated the roundtrip (20 of 22 s at 200k rows) while
            # restore must cost << build at 1M rows (VERDICT r3 #7)
            np.savez(
                f,
                indptr=shadow.indptr,
                indices=shadow.indices,
                data=shadow.data,
                max_weights=self.max_weights,
                static_max_weights=getattr(
                    self, "_static_max_weights", np.empty(0)
                ),
                shape=np.array([shadow.n_rows, shadow.n_cols], np.int64),
                meta_json=np.array(json.dumps(meta)),
                **self._extra_npz(),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(npz_tmp, os.path.join(path, "index.npz"))
        meta_tmp = os.path.join(path, ".meta.json.tmp")
        with open(meta_tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(meta_tmp, os.path.join(path, "meta.json"))

    def _extra_npz(self) -> dict:
        """Flavor-specific extra checkpoint arrays (the chunked engine
        stores its device-layout mirror here so restore can skip the
        rebuild pass).  The base snapshot stays flavor-agnostic: every
        reader ignores keys it does not know."""
        return {}

    @staticmethod
    def read_checkpoint(path: str):
        """Host-only checkpoint read: (csr, ids, max_weights, config_dict) —
        no device state is touched, so any engine flavor can rebuild from it."""
        z = np.load(os.path.join(path, "index.npz"))
        if "meta_json" in z:  # self-contained snapshot (atomic save path)
            meta = json.loads(str(z["meta_json"]))
        else:  # pre-round-2 checkpoints kept meta only in meta.json
            with open(
                os.path.join(path, "meta.json"), "r", encoding="utf-8"
            ) as f:
                meta = json.load(f)
        n_rows, n_cols = (int(v) for v in z["shape"])
        csr = CSRMatrix(n_rows, n_cols, z["indptr"], z["indices"], z["data"])
        return csr, meta["ids"], z["max_weights"], meta["config"]

    @staticmethod
    def read_checkpoint_config(path: str) -> dict:
        """Config dict only — NpzFile members decompress lazily per access,
        so this skips the corpus arrays entirely (Engine.load used to
        materialize the full multi-GB snapshot once for the config and a
        second time inside restore())."""
        z = np.load(os.path.join(path, "index.npz"))
        if "meta_json" in z:
            return json.loads(str(z["meta_json"]))["config"]
        with open(
            os.path.join(path, "meta.json"), "r", encoding="utf-8"
        ) as f:
            return json.load(f)["config"]

    def restore(self, path: str) -> None:
        """Rebuild this (empty) engine from a checkpoint."""
        if self.n_rows:
            raise RuntimeError("restore() on a non-empty engine")
        csr, ids, max_weights, ckpt_cfg = Engine.read_checkpoint(path)
        if int(ckpt_cfg["vector_dim"]) != self.cfg.vector_dim:
            # fail with the actual mismatch instead of the downstream numpy
            # broadcast error / compact-space IndexError it would cause
            raise ValueError(
                f"checkpoint vector_dim {ckpt_cfg['vector_dim']} != engine "
                f"config vector_dim {self.cfg.vector_dim} ({path})"
            )
        if csr.n_rows:
            self.build(csr, ids)
        # merge, don't overwrite: build() recomputed maxima from the corpus
        # (covers checkpoints written before maxima were maintained on every
        # flavor), while the stored map may additionally record admission-
        # dropped vectors' weights — the running-bound contract needs both
        self.max_weights = np.maximum(self.max_weights, max_weights)
        Engine._restore_static_map(self, path)

    @staticmethod
    def _restore_static_map(eng: "Engine", path: str) -> None:
        z = np.load(os.path.join(path, "index.npz"))
        if "static_max_weights" in z and z["static_max_weights"].size:
            eng._static_max_weights = z["static_max_weights"]

    @classmethod
    def load(cls, path: str, config: AllPairsConfig | None = None) -> "Engine":
        ckpt_cfg = cls.read_checkpoint_config(path)
        cfg = config or AllPairsConfig().replace(
            vector_dim=int(ckpt_cfg["vector_dim"]),
            similarity_threshold=float(ckpt_cfg["similarity_threshold"]),
            dtype=str(ckpt_cfg["dtype"]),
        )
        eng = cls(cfg)
        eng.restore(path)  # one rebuild path: build + maxima merge + static map
        return eng
