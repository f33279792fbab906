"""Chunked-sparse engine — exact all-pairs + streaming beyond the dense-index
HBM ceiling.

The dense :class:`Engine` needs ``rows × dim_cap`` floats resident.
``ChunkedAllPairs`` keeps only per-chunk COO entry buffers + one dim-chunk
slab on device (``O(nnz + rows·chunk_dim)``) and runs the same exact join —
fp64 host rescore included — far beyond the dense engine's row ceiling.

Round 2 adds STREAMING INSERTS (the reference's WriteWorkerActor.scala:185-202
capability at out-of-core scale): entries live in fixed-capacity per-chunk
device buffers with capacity-doubling growth; an insert is one donated
scatter-append plus a chunked cross-match of the batch against the full
index (index-before-query, so intra-batch pairs surface symmetrically —
SURVEY.md fine-print #2).  Round 2b adds the dormant-dim tier (build +
streaming, shared with the dense engine), cross-flavor checkpointing, the
full serving surface, and the three-level bit-packed stripe extraction.
Round 3 adds max-weight ADMISSION PRUNING (shared with the dense engine, so
one config admits the same corpus on every flavor) and the int8 PANEL join
(``ops/panel.py``): row-sorted int8 COO → per-panel slabs → one int8 dot +
bound epilogue per panel pair — with the XLA stripe path kept as the
fallback.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import AllPairsConfig
from ..index.compact import CompactSpace
from ..ops import chunked as chunked_ops
from ..ops import rescore as rescore_ops
from ..ops import score as score_ops
from ..utils import memory
from ..utils.jaxsetup import setup_jax
from ..utils.logging import Timer
from ..vector.batch import CSRMatrix, GrowableCSR, pow2_bucket, round_up
from .engine import Engine, _as_csr, _next_cap
from .output import PairResult, SimilarityOutput

__all__ = ["ChunkedAllPairs"]


def _panel_aux(aux, rb: int, n_panels: int) -> list:
    """Per-panel ``[3, rb]`` slices of the int8 bound table, zero-padded
    (α = 0 scores nothing) to ``n_panels · rb`` rows."""
    import jax.numpy as jnp

    padded = n_panels * rb
    if padded > aux.shape[1]:
        aux = jnp.pad(aux, ((0, 0), (0, padded - aux.shape[1])))
    return [aux[:, p * rb : (p + 1) * rb] for p in range(n_panels)]


_compiles = 0
_compile_listener = False


def _compile_count() -> int:
    """Backend compiles this process has run so far (a ``jax.monitoring``
    listener, registered on first use)."""
    global _compile_listener
    if not _compile_listener:
        import jax

        def on_event(event, duration, **_):
            global _compiles
            if event == "/jax/core/compile/backend_compile_duration":
                _compiles += 1

        jax.monitoring.register_event_duration_secs_listener(on_event)
        _compile_listener = True
    return _compiles


def _prewarm_atexit(ref) -> None:
    """Interpreter-exit hook (weakref — must not pin the engine): stop the
    background prewarmer BETWEEN compiles and wait for an in-flight one.
    A daemon thread killed inside an XLA compile aborts the process
    ("terminate called after throwing an instance of ''" at the end of the
    round-5 serve-probe logs); one bounded join beats an abort."""
    eng = ref()
    if eng is None:
        return
    eng._prewarm_stop.set()
    t = eng._prewarm_thread
    if t is not None and t.is_alive():
        t.join(90)


class ChunkedAllPairs:
    def __init__(self, config: AllPairsConfig | None = None,
                 chunk_dim: int = 2048, super_tile: int | None = None,
                 panel_rows: int | None = None):
        setup_jax()
        self.cfg = config or AllPairsConfig()
        self.chunk_dim = int(chunk_dim)
        # panel-join row-block override (tests / tuning); None = auto
        self.panel_rows = None if panel_rows is None else int(panel_rows)
        # query-stripe width: wide stripes amortize the per-chunk slab
        # densify (the join's second-largest cost after the matmul) over
        # more query columns; auto-sized to the fp32 accumulator budget
        # (re-evaluated as the corpus grows) unless overridden here
        self.super_tile = None if super_tile is None else int(super_tile)
        self._ent = None  # (rows2d, cols2d, vals2d) jnp [n_chunks, chunk_cap]
        # host mirror of _ent, maintained through build/append/grow at
        # O(batch nnz) marginal cost: checkpoints write it so restore is a
        # plain device placement instead of a full rebuild pass
        # (VERDICT r3 #7 / r4 #5 — incremental restore)
        self._ent_host = None
        self._mslab = None  # resident match slabs [n_chunks, row_cap, width]
        self._counts = None  # np int64 [n_chunks] (host truth)
        self._counts_dev = None  # jnp int32 copy for kernels
        self._chunk_cap = 0
        self._shadow: GrowableCSR | None = None
        self.ids: List[str] = []
        self.id_to_row: Dict[str, int] = {}
        self.n_rows = 0
        self._max_norm = 0.0
        self._frozen = False
        # serving surface (SimilarityServer duck-types the engine): empty
        # compact space until build, counters, per-stage timings
        self._compact = CompactSpace(self.cfg.vector_dim, self.cfg.dim_bucket)
        self.max_weights = np.zeros(self.cfg.vector_dim, dtype=np.float64)
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "candidates_scored": 0,
            "pairs_emitted": 0,
            "insert_batches": 0,
            "dormant_dims": 0,
            "vectors_dropped_admission": 0,
        }
        self.timer = Timer()
        # dormant-dim archive (same tier as the dense engine: df==1 dims stay
        # off-device until an insert shares the dim) — shrinks the compact
        # space, so every chunk slab and its scatter get narrower
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dormant_of_ext: np.ndarray | None = None
        # stateful row_cap (see the property) + background prewarm of the
        # NEXT cap's match program — together they keep a sustained stream
        # from stalling on every row_cap-crossing recompile
        self._row_cap_state: int | None = None
        self._prewarm_lock = threading.Lock()
        self._prewarm_specs: "OrderedDict" = OrderedDict()  # MRU geometry
        self._prewarm_done: set = set()
        self._prewarm_fail: Dict[tuple, int] = {}
        self._prewarm_thread: threading.Thread | None = None
        # checked between compiles; set at interpreter exit so the daemon
        # thread never dies INSIDE an XLA compile (that aborts the process
        # with "terminate called after throwing" — seen at serve-probe exit)
        self._prewarm_stop = threading.Event()
        atexit.register(_prewarm_atexit, weakref.ref(self))
        # row-sorted flat-COO state behind the paneled streaming match
        # (built lazily; dropped for lazy consolidation/rebuild)
        self._sort_state: dict | None = None
        # q_rows_cap bucket -> max q_ecap served (monotone floor): the
        # query-nnz cap used to flap between adjacent pow2 buckets across
        # same-bucket flushes (8192-row batches straddling nnz 2^20),
        # minting a fresh static-arg variant — a cold compile mid-serve.
        # Padding the query COO up to the bucket's floor
        # costs at most 2x H2D bytes and keeps ONE executable per bucket.
        self._paneled_qgeom: Dict[int, int] = {}
        # which route the last all_pairs took: "panels" | "stripes"
        self.join_route: str | None = None

    # dormant-dim machinery shared verbatim with the dense engine (it only
    # touches the compact space, the archive arrays, and host CSR filtering)
    _drop_unmapped = Engine._drop_unmapped
    _archive_dormant = Engine._archive_dormant
    _dormant_hits = Engine._dormant_hits
    _stream_archive_singletons = Engine._stream_archive_singletons
    _dorm_append = Engine._dorm_append

    @property
    def compact(self) -> CompactSpace:
        return self._compact

    def shadow_csr(self) -> CSRMatrix:
        return self._shadow.view() if self._shadow is not None else CSRMatrix(
            0, self.cfg.vector_dim, np.zeros(1, np.int64),
            np.empty(0, np.int32), np.empty(0, np.float64),
        )

    # admission pruning shared with the dense engine (EntryProxyActor.scala
    # :81-93 semantics): the bound only reads max_weights / the static map —
    # both maintained identically here — so the same config gives the same
    # admitted corpus across engine flavors
    set_max_weight_map = Engine.set_max_weight_map
    _admit = Engine._admit

    # ------------------------------------------------------------------ sizes
    @staticmethod
    def _row_cap_law(n: int, streaming: bool) -> int:
        """Slab-height law: quantum-rounded at build, GEOMETRIC while
        streaming at scale.  Every crossing re-specializes the
        row_cap-keyed jits, and a cold compile there stalls serving, so
        at serving scale the cap jumps ~25% past the corpus: a sustained
        1k vec/s stream at 500k rows crosses once per ~125 s of arrivals —
        enough headroom for :meth:`_maybe_prewarm` to compile the next
        geometry in the background before it is needed.  The ≤25% row
        padding costs matmul zeros (~12% mean), strictly cheaper than the
        stall.  Fresh builds pay no padding (streaming=False → exact
        quantum)."""
        q = min(8192, pow2_bucket(n, 1024))
        if n > 131_072:
            q = 16_384
        if n > 262_144:
            q = 32_768
        base = round_up(n, q)
        if streaming and n > 262_144:
            return max(base, round_up(int(n * 1.25), 32_768))
        return base

    @property
    def row_cap(self) -> int:
        """Slab height for the current row count — a compile-time parameter
        only (row growth costs no device copies in this mode); monotone,
        following :meth:`_row_cap_law`.  ``_row_cap_state`` is reset by
        build/restore (exact cap, zero padding) and then only ever grows."""
        n = max(self.n_rows, 1)
        cur = self._row_cap_state
        if cur is not None and cur >= n:
            return cur
        self._row_cap_state = self._row_cap_law(n, streaming=cur is not None)
        return self._row_cap_state

    def _peek_next_row_cap(self) -> int:
        """The row_cap that will apply after the next crossing — the
        prewarm target."""
        return self._row_cap_law(self.row_cap + 1, streaming=True)

    @property
    def _chunk_width(self) -> int:
        """Slab width covering the largest local dim so far; grows in
        ``chunk_dim`` doublings when inserts mint new compact dims."""
        need = -(-self._compact.capacity // self._n_chunks)
        w = self.chunk_dim
        while w < need:
            w *= 2
        return w

    def _q_super(self) -> int:
        """Stripe width: the widest power of two whose fp32 accumulator
        (row_cap × stripe) stays under its device-memory share, clamped to
        the row capacity so small corpora pay small programs (pow2 ⇒ it
        always divides row_cap).
        Wide stripes amortize the per-chunk slab densify — the join's
        second-largest cost after the matmul — over more query columns
        (100k rows: 4096 → 25 densify passes, 8192 → 13).  The auto choice
        is RE-EVALUATED whenever the padded row count changes: a width
        cached at build size would blow the accumulator budget after enough
        streaming growth (e.g. 8192 picked at 100k rows is an 8.3 GB
        accumulator at 250k)."""
        if self.super_tile is not None:
            # round DOWN to a power of two that DIVIDES row_cap.  row_cap is
            # quantized to multiples of min(8192, pow2) — above 8192 rows it
            # is a multiple of 8192 but NOT a power of two, so a pow2 stripe
            # above 8192 (e.g. 16384 at row_cap=24576) may not divide it.
            # A non-divisor stripe width would make the last stripe's
            # dynamic_slice CLAMP its start: the scores would be computed
            # against shifted rows while the epilogue still labels columns
            # q0+i — silently losing the clamped rows' true pairs
            st = 1
            while st * 2 <= self.super_tile:
                st *= 2
            st = min(st, self.row_cap)
            while self.row_cap % st:
                st //= 2
            return st
        padded = round_up(max(self.n_rows, 1), 8192)
        cached = getattr(self, "_auto_super", None)
        if cached is None or cached[1] != padded:
            budget = memory.budget(memory.ACCUMULATOR) // (4 * padded)
            st = 1024
            while st * 2 <= min(budget, 8192):
                st *= 2
            cached = (st, padded)
            self._auto_super = cached
        return min(cached[0], self.row_cap)

    # ---------------------------------------------------------------- op hooks
    # Device-facing seams: the mesh-sharded subclass
    # (:class:`~apsim.parallel.chunked_mesh.MeshChunkedAllPairs`) reroutes
    # these through shard_map'd collectives; all host logic stays shared.

    def _round_chunks(self, n: int) -> int:
        return n

    def _place_ent(self, rows2d, cols2d, vals2d):
        import jax.numpy as jnp

        return (jnp.asarray(rows2d), jnp.asarray(cols2d), jnp.asarray(vals2d))

    def _place_counts(self, counts: np.ndarray):
        import jax.numpy as jnp

        return jnp.asarray(counts.astype(np.int32))

    def _place_q(self, q):
        return q

    def _op_append(self, coo5):
        """Append one packed ``[5, ecap]`` int32 device array of entries
        (chunk / slot / row / local / fp32 bits) into the chunk buffers."""
        self._ent = chunked_ops.append_entries_packed(*self._ent, coo5)
        # keep the resident match slabs consistent: same (chunk, row, local,
        # value) scatter, same OOB-drop padding contract.  A geometry change
        # (row_cap quantum crossed / chunk width doubled) drops the cache
        # instead of growing it — growth would transiently hold old + new
        # slab stacks at exactly the moment HBM is fullest; a lazy rebuild
        # from the entry buffers costs one densify sweep (~0.3 s at 100k
        # rows) every few thousand inserted rows and keeps peak HBM at one
        # stack
        m = self._mslab
        if m is not None:
            if (m.shape[1], m.shape[2]) != (self.row_cap, self._chunk_width):
                self._mslab = None
            else:
                self._mslab = chunked_ops.append_match_slabs_packed(m, coo5)

    def _op_grow(self, new_cap: int):
        self._ent = chunked_ops.grow_entry_cap(
            *self._ent, new_cap=new_cap, pad_row=self._pad_row()
        )

    # ----------------------------------------------- resident match slabs
    # Streaming fast path: the per-batch cross-match used to re-scatter the
    # ENTIRE corpus into chunk slabs on every insert (the element-bound
    # scatter dominated each micro-batch).  While the stacked slabs fit
    # their memory budget (``match_slab_budget_mb``) they stay
    # resident and inserts update them incrementally, making the match
    # dots-only.  Beyond the budget (true out-of-core scale) the engine
    # falls back to the rebuild path unchanged.

    _match_slab_cache_ok = True  # mesh subclass keeps its sharded path

    def _slab_dtype(self) -> str:
        return (
            "float32" if self.cfg.matmul_precision == "highest"
            else "bfloat16"
        )

    def _match_slabs(self):
        """The resident slab stack for the CURRENT geometry, building or
        rebuilding lazily; None when disabled or over budget."""
        if not self._match_slab_cache_ok or self._ent is None:
            return None
        dt = self._slab_dtype()
        rows, width = self.row_cap, self._chunk_width
        itemsize = 4 if dt == "float32" else 2
        mb = self.cfg.match_slab_budget_mb
        budget = (
            memory.budget(memory.MATCH_SLABS) if mb is None
            else int(mb) << 20
        )
        if self._n_chunks * rows * width * itemsize > budget:
            self._mslab = None
            return None
        m = self._mslab
        if m is not None and (m.shape[1], m.shape[2]) != (rows, width):
            self._mslab = m = None  # geometry moved: rebuild below
        if m is None:
            self._mslab = chunked_ops.build_match_slabs(
                *self._ent, self._counts_dev, rows, width, dt
            )
        return self._mslab

    # int8 stripes: an opt-in (set the attribute True) for the stripe
    # fallback path — int8 slabs, int32 accumulation, per-pair bound.  Not
    # measured on the GPU yet.  Instances also self-demote when the
    # int32-accumulator safety gate trips.
    _int8_stripes = False

    def _int8_slabs(self):
        """Cached (q2d int8, aux) for int8 stripe scoring, quantized on
        device from the CURRENT entry buffers (cache keyed by the immutable
        values array — any append invalidates it automatically); returns
        None when int8 stripes are disabled or unsafe."""
        if not (self._int8_stripes and self.cfg.pallas_int8):
            return None
        key = self._ent[2]
        cached = getattr(self, "_q8_cache", None)
        if cached is not None and cached[0] is key:
            return cached[1]
        q2d, aux, max_nnz = chunked_ops.quantize_chunk_entries(
            self._ent[0], self._ent[2], self.row_cap
        )
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
            return chunked_ops.chunked_stripe_extract_int8(
                self._ent[0], self._ent[1], q2d, self._counts_dev, aux,
                np.int32(q0), tau_eff, self.row_cap, self._chunk_width,
                super_tile, cap, capb, cap0,
            )
        return chunked_ops.chunked_stripe_extract(
            *self._ent, self._counts_dev, np.int32(q0), tau_eff,
            self.row_cap, self._chunk_width, super_tile, cap, capb, cap0,
            self.cfg.matmul_precision,
        )

    def _op_match(self, q, q_base: int, tau_eff, q_rows_cap: int, cap: int,
                  grp: int):
        # two-level-head fallback: only the mesh subclass (whose shard_map'd
        # override replaces this) and the _match_bits=False debug opt-out
        # land here — no resident-slab branch on purpose (it would be
        # unreachable, untested device code)
        return chunked_ops.chunked_match_extract(
            *self._ent, self._counts_dev, *q, np.int32(q_base), tau_eff,
            self.row_cap, self._chunk_width, q_rows_cap, cap, grp,
            self.cfg.matmul_precision,
        )

    # Streaming match runs the three-level bit-packed epilogue on the
    # single-device engine (the two-level _extract scan grows linearly
    # with the flush batch: ~1.2 s of a 2.8 s / 2048-row batch at 500k
    # rows).  The mesh subclass keeps the two-level head (its shard_map'd
    # match replicates match_epilogue across devices) — flag, not override,
    # so _run_match stays shared.
    _match_bits = True

    def _op_match_bits(self, q, q_base: int, tau_eff, q_rows_cap: int,
                       caps):
        cap, capb, cap0 = caps
        mslab = self._match_slabs()
        if mslab is not None:
            return chunked_ops.cached_match_extract_bits(
                mslab, *q, np.int32(q_base), tau_eff, q_rows_cap,
                cap, capb, cap0, self.cfg.matmul_precision,
            )
        self._note_match_geom(q, q_rows_cap, caps)
        return chunked_ops.chunked_match_extract_bits(
            *self._ent, self._counts_dev, *q, np.int32(q_base), tau_eff,
            self.row_cap, self._chunk_width, q_rows_cap, cap, capb, cap0,
            self.cfg.matmul_precision,
        )

    # -------------------------------------------- next-row_cap prewarm
    # Beyond the resident-slab budget every row_cap crossing re-specializes
    # chunked_match_extract_bits, and a cold compile on the serving thread
    # stalls ingest through the crossing.  The law
    # above makes crossings geometrically rare; this prewarmer makes them
    # CHEAP: after each insert it AOT-lowers+compiles the next cap's match
    # program in a daemon thread from shape specs only (no device buffers
    # touched — no donation races with concurrent appends), populating the
    # persistent compile cache (utils/jaxsetup.py) so the real call at the
    # crossing re-traces and hits it in ~1 s.
    _prewarm_min_rows = 262_144  # below this, compiles are cheap anyway
    _prewarm_max_geoms = 4       # MRU geometries compiled per pass

    def _note_match_geom(self, q, q_rows_cap: int, caps) -> None:
        """Record the aval signature of a rebuild-path match call (MRU)."""
        import jax

        ent_avals = tuple(
            jax.ShapeDtypeStruct(a.shape, a.dtype)
            for a in (*self._ent, self._counts_dev, *q)
        )
        key = (q_rows_cap, caps, ent_avals)
        with self._prewarm_lock:
            self._prewarm_specs[key] = None
            self._prewarm_specs.move_to_end(key)
            while len(self._prewarm_specs) > 8:
                self._prewarm_specs.popitem(last=False)

    def _maybe_prewarm(self) -> None:
        """Kick one background compile pass for the next row_cap (no-op
        when already warmed/compiling, below scale, or on the slab path)."""
        if self.n_rows < self._prewarm_min_rows or self._ent is None:
            return
        if self._prewarm_thread is not None and self._prewarm_thread.is_alive():
            return
        nxt = self._peek_next_row_cap()
        if not self._prewarm_select(nxt):
            return
        width, prec = self._chunk_width, self.cfg.matmul_precision
        t = threading.Thread(
            target=self._prewarm_worker, args=(nxt, width, prec),
            daemon=True, name="apsim-prewarm",
        )
        self._prewarm_thread = t
        t.start()

    def _prewarm_select(self, nxt: int):
        """Up to ``_prewarm_max_geoms`` not-yet-compiled specs, MRU first."""
        with self._prewarm_lock:
            return [
                k for k in reversed(self._prewarm_specs)
                # paneled/sortfp specs are self-contained (own geometry);
                # rebuild-path specs compile against the next row_cap
                if (0 if k[0] in ("paneled", "sortfp") else nxt, k)
                not in self._prewarm_done
            ][: self._prewarm_max_geoms]

    def _prewarm_worker(self, row_cap: int, width: int, prec: str) -> None:
        """Drains the spec queue: compiles MRU batches until every queued
        spec is done (serving threads keep enqueueing new variants while
        this runs) or the interpreter is exiting."""
        import jax

        scal_i = jax.ShapeDtypeStruct((), np.int32)
        scal_f = jax.ShapeDtypeStruct((), np.float32)
        while keys := self._prewarm_select(row_cap):
            self._prewarm_batch(keys, row_cap, width, prec, scal_i, scal_f)
            if self._prewarm_stop.is_set():
                return

    def _prewarm_batch(self, keys, row_cap: int, width: int, prec: str,
                       scal_i, scal_f) -> None:
        import jax

        for key in keys:
            if self._prewarm_stop.is_set():
                return
            try:
                if key[0] == "paneled":
                    (_, n_panels, ph, d_cap, p_cap, q_ecap, q_rows_cap,
                     caps, avals) = key
                    pk_aval = jax.ShapeDtypeStruct(
                        (n_panels + 3 + 3 * q_ecap,), np.int32
                    )
                    chunked_ops.paneled_match_extract_bits.lower(
                        *avals, pk_aval, scal_f,
                        ph=ph, n_panels=n_panels, d_cap=d_cap, p_cap=p_cap,
                        q_ecap=q_ecap, q_rows_cap=q_rows_cap, cap=caps[0],
                        capb=caps[1], cap0=caps[2], precision=prec,
                    ).compile()
                elif key[0] == "sortfp":
                    _, ent_avals, counts_aval, cap_s = key
                    chunked_ops.sort_entries_fp.lower(
                        *ent_avals, counts_aval, cap_s
                    ).compile()
                else:
                    q_rows_cap, caps, ent_avals = key
                    chunked_ops.chunked_match_extract_bits.lower(
                        *ent_avals, scal_i, scal_f,
                        row_cap=row_cap, chunk_dim=width,
                        q_rows_cap=q_rows_cap, cap=caps[0], capb=caps[1],
                        cap0=caps[2], precision=prec,
                    ).compile()
                self.stats["prewarm_compiles"] = (
                    self.stats.get("prewarm_compiles", 0) + 1
                )
            except Exception:  # best-effort: a miss just means a cold stall
                from ..utils.logging import get_logger

                with self._prewarm_lock:
                    n = self._prewarm_fail[key] = (
                        self._prewarm_fail.get(key, 0) + 1
                    )
                if n < 3:
                    # Transient: jax 0.9.0's mlir lowering cache races when
                    # a serving thread traces concurrently with this one
                    # (KeyError: Var / cached_primitive_lowerings; a miss
                    # becomes a cold stall mid-serve).  Leave the spec
                    # queued and back off; the retry lands once the
                    # foreground trace finishes.
                    get_logger().warning(
                        "row_cap prewarm attempt %d failed; will retry",
                        n, exc_info=True,
                    )
                    time.sleep(float(n))
                    continue
                get_logger().exception("row_cap prewarm failed (non-fatal)")
            with self._prewarm_lock:
                self._prewarm_done.add(
                    (0 if key[0] in ("paneled", "sortfp") else row_cap, key)
                )

    # ------------------------------------------- paneled streaming match
    # Beyond the resident-slab budget the per-batch match used to pay a
    # full O(corpus-nnz) per-chunk re-scatter AND a [row_cap, q] fp32
    # accumulator that capped the query width at 2048.  The paneled path
    # keeps the corpus as one row-sorted flat COO, maintained INCREMENTALLY
    # (batch appends extend the tail in row order; dormant activations land
    # in a small unsorted overflow region; a periodic device re-sort
    # consolidates), and scores
    # ph-row panels under a lax.scan with a [ph, q] accumulator — query
    # width lifts to 8192, the O(corpus) scatter amortizes 4x further, and
    # empty row_cap-padding panels skip via lax.cond.  Numerics contract
    # identical to the rebuild path (bf16-at-scatter + fp32 accumulation +
    # tau_eff margin + fp64 host rescore).  ops/chunked.py section comment
    # has the op-level design.
    _paneled_match = True   # class-level opt-out
    _sort_o_cap = 32768     # overflow region entries (activation spill)
    _paneled_q_cap = 8192   # query width limit ([ph, q] fp32 ~= 1 GB)
    _paneled_ph_cap = 32768  # max panel height (tests shrink to force
                             # multi-panel scans on tiny corpora)

    def _paneled_ph(self, row_cap: int | None = None) -> int:
        """Panel height: the largest divisor of row_cap that is <=
        ``_paneled_ph_cap`` and a multiple of 64 (bit-pack granularity).
        At serving scale the row_cap law keeps row_cap 32768-aligned, so
        ph == 32768 and crossings change only the panel COUNT (a cheap
        scan-length recompile, prewarmed like the rebuild path's)."""
        rc = self.row_cap if row_cap is None else row_cap
        k = -(-rc // int(self._paneled_ph_cap))
        while rc % k or (rc // k) % 64:
            k += 1
        return rc // k

    def _paneled_ok(self) -> bool:
        return (
            self._paneled_match
            and self._match_slab_cache_ok  # mesh keeps its shard_map path
            and self._ent is not None
            and self._match_slabs() is None  # resident path wins under it
        )

    def _sort_state_get(self):
        """The sorted flat-COO state for the current corpus, (re)building
        lazily: one device sort of the entry buffers + a host per-panel
        count pass over the entry-host mirror."""
        st = self._sort_state
        ph = self._paneled_ph()
        if st is not None and st["ph"] != ph:
            st = self._sort_state = None  # panel height moved: recount
        if st is not None:
            return st
        live = int(self._counts.sum())
        cap_s = pow2_bucket(live + max(65536, live // 4), 4096)
        r_s, gc_s, vb_s = chunked_ops.sort_entries_fp(
            *self._ent, self._counts_dev, cap_s
        )
        import jax.numpy as jnp

        rows2d = self._ent_host[0]
        pos_ok = (
            np.arange(rows2d.shape[1])[None, :] < self._counts[:, None]
        )
        pcounts = np.bincount(
            (rows2d[pos_ok] // ph).astype(np.int64),
            minlength=-(-self.row_cap // ph),
        ).astype(np.int64)
        o_cap = int(self._sort_o_cap)
        st = {
            "ph": ph, "cap_s": cap_s, "n_ent": live,
            "r_s": r_s, "gc_s": gc_s, "vb_s": vb_s,
            "r_o": jnp.full((o_cap,), 1 << 30, jnp.int32),
            # distinct buffers: both are donated by the overflow append
            "gc_o": jnp.zeros((o_cap,), jnp.int32),
            "vb_o": jnp.zeros((o_cap,), jnp.int32),
            "n_o": 0,
            "pcounts": pcounts,
        }
        self._sort_state = st
        return st

    def _sort_state_append(self, coo5_dev, rows_of, n_new: int,
                           tail: bool) -> None:
        """Keep the sorted state consistent through an entry append, using
        the SAME packed device array the entry-buffer append shipped (zero
        extra H2D).  Capacity or overflow exhaustion just drops the state —
        the next match rebuilds it with headroom (lazy consolidation)."""
        st = self._sort_state
        if st is None or n_new == 0:
            return
        ecap = int(coo5_dev.shape[1])
        if tail:
            if st["n_ent"] + ecap > st["cap_s"]:
                self._sort_state = None
                return
            st["r_s"], st["gc_s"], st["vb_s"] = (
                chunked_ops.append_sorted_packed(
                    st["r_s"], st["gc_s"], st["vb_s"], coo5_dev,
                    np.int32(st["n_ent"]), self._n_chunks, True,
                )
            )
            st["n_ent"] += n_new
        else:
            if st["n_o"] + ecap > int(self._sort_o_cap):
                self._sort_state = None  # consolidate on next match
                return
            st["r_o"], st["gc_o"], st["vb_o"] = (
                chunked_ops.append_sorted_packed(
                    st["r_o"], st["gc_o"], st["vb_o"], coo5_dev,
                    np.int32(st["n_o"]), self._n_chunks, False,
                )
            )
            st["n_o"] += n_new
        pan = np.asarray(rows_of) // st["ph"]
        add = np.bincount(pan, minlength=st["pcounts"].size)
        if add.size > st["pcounts"].size:  # batch crossed into new panels
            st["pcounts"] = np.pad(
                st["pcounts"], (0, add.size - st["pcounts"].size)
            )
        st["pcounts"] = st["pcounts"] + add

    def _run_match_paneled(self, ccsr: CSRMatrix, q_base: int, tau_eff):
        """One paneled streaming match (+ overflow retry): pack the query
        COO + panel starts + scalars into ONE int32 H2D, run the scan-of-
        panels op, decode the pallas head."""
        from ..ops import bits

        st = self._sort_state_get()
        ph = st["ph"]
        n_panels = self.row_cap // ph
        pc = st["pcounts"]
        if pc.size < n_panels:
            pc = np.pad(pc, (0, n_panels - pc.size))
        # tail entries (activation overflow lives separately; sorted
        # padding rows carry 2^30 and fall past every panel)
        starts = np.zeros(n_panels + 1, np.int64)
        np.cumsum(pc[:n_panels], out=starts[1:])
        p_cap = min(
            pow2_bucket(max(int(pc.max()) if pc.size else 1, 1), 4096),
            st["cap_s"],
        )
        nq = ccsr.n_rows
        q_rows_cap = min(pow2_bucket(nq, 256), self._paneled_q_cap)
        nnz_q = int(ccsr.indptr[-1])
        q_ecap = max(
            pow2_bucket(max(nnz_q, 1), 1024),
            self._paneled_qgeom.get(q_rows_cap, 0),
        )
        self._paneled_qgeom[q_rows_cap] = q_ecap
        hdr = n_panels + 3
        pk = np.zeros(hdr + 3 * q_ecap, np.int32)
        pk[: n_panels + 1] = starts
        pk[n_panels + 1] = q_base
        pk[n_panels + 2] = self.n_rows
        qr = np.repeat(
            np.arange(nq, dtype=np.int32), np.diff(ccsr.indptr)
        )
        pk[hdr : hdr + nnz_q] = qr
        pk[hdr + nnz_q : hdr + q_ecap] = q_rows_cap  # padding -> dropped
        pk[hdr + q_ecap : hdr + q_ecap + nnz_q] = ccsr.indices
        pk[hdr + 2 * q_ecap : hdr + 2 * q_ecap + nnz_q] = (
            ccsr.data.astype(np.float32).view(np.int32)
        )
        import jax.numpy as jnp

        pk_dev = jnp.asarray(pk)
        d_cap = self._n_chunks * self._chunk_width
        caps = getattr(self, "_pmatch_caps", None)
        if caps is None:
            c = pow2_bucket(int(self.cfg.extract_cap), 1024)
            cb = max(c // bits.GROUP, 1024)
            caps = (c, cb, cb)
        while True:
            bufs, packed = chunked_ops.paneled_match_extract_bits(
                st["r_s"], st["gc_s"], st["vb_s"],
                st["r_o"], st["gc_o"], st["vb_o"], pk_dev, tau_eff,
                ph, n_panels, d_cap, p_cap, q_ecap, q_rows_cap,
                caps[0], caps[1], caps[2], self.cfg.matmul_precision,
            )
            rows_h, cols_h, total, groups, supers = (
                bits.unpack_head(np.asarray(packed))
            )
            if total > caps[0] or groups > caps[1] or supers > caps[2]:
                caps = score_ops.grow_caps(caps, (total, groups, supers))
                continue
            break
        self._note_paneled_geom(st, pk_dev, ph, d_cap, p_cap, q_ecap,
                                q_rows_cap, caps)
        # DEFERRED cap tightening: a cap change is new static args — a
        # fresh compile if it lands on the serving thread.  Adopt
        # the tightened caps only once the background prewarmer has
        # compiled that variant into the persistent cache; until then the
        # current (looser, correct) caps keep serving.
        tight = score_ops.tighten_caps((total, groups, supers), caps)
        if tight == caps:
            self._pmatch_caps = caps
        else:
            key = self._paneled_spec(st, ph, d_cap, p_cap, q_ecap,
                                     q_rows_cap, tight)
            with self._prewarm_lock:
                ready = (0, key) in self._prewarm_done
                self._prewarm_specs[key] = None
                self._prewarm_specs.move_to_end(key)
            self._pmatch_caps = tight if ready else caps
        if total <= rows_h.size:
            return rows_h, cols_h
        return score_ops.decode_pairs(bufs, total)

    def _paneled_spec(self, st, ph, d_cap, p_cap, q_ecap, q_rows_cap,
                      caps, n_panels=None, cap_s=None):
        """Self-contained prewarm spec for one paneled-match geometry —
        exactly the static args + avals ``paneled_match_extract_bits``
        will be jitted against, so a background ``.lower().compile()``
        lands the executable in the persistent cache before the serving
        thread needs it."""
        import jax

        cs = int(st["cap_s"]) if cap_s is None else int(cap_s)
        npan = (self.row_cap // ph) if n_panels is None else int(n_panels)
        vdt = st["r_s"].dtype
        sa = tuple(jax.ShapeDtypeStruct((cs,), vdt) for _ in range(3))
        o_avals = tuple(
            jax.ShapeDtypeStruct(a.shape, a.dtype)
            for a in (st["r_o"], st["gc_o"], st["vb_o"])
        )
        return ("paneled", npan, ph, d_cap, min(int(p_cap), cs), q_ecap,
                q_rows_cap, caps, sa + o_avals)

    def _note_paneled_geom(self, st, pk_dev, ph, d_cap, p_cap, q_ecap,
                           q_rows_cap, caps) -> None:
        """Record this paneled-match geometry's IMMINENT CROSSING variants
        for the background prewarmer.  Unlike the rebuild path (whose only
        compile cliff is row_cap), the paneled path has four: the sorted
        capacity cap_s (consolidation doubles the sorted avals AND
        recompiles the device sort), the per-panel slice cap, the panel
        count at a row_cap crossing, and EXTRACTION-CAP GROWTH (an overflow
        retry mints new static args mid-serve; prewarmed here so the retry
        hits the persistent cache instead).  Specs are
        fully self-contained; the worker compiles them verbatim.  Order
        matters: the worker drains MRU-first, so the most-likely-imminent
        variants (cap growth) are enqueued LAST."""
        import jax

        def aval(a):
            return jax.ShapeDtypeStruct(a.shape, a.dtype)

        cap_s = int(st["cap_s"])
        n_panels = self.row_cap // ph

        def spec(npan, cs, pc, cp=caps, qe=q_ecap, qr=q_rows_cap):
            return self._paneled_spec(st, ph, d_cap, pc, qe, qr,
                                      cp, npan, cs)

        variants = [
            spec(n_panels, 2 * cap_s, p_cap),   # sorted-capacity crossing
            spec(n_panels, cap_s, 2 * p_cap),   # per-panel slice crossing
        ]
        nxt_rc = self._peek_next_row_cap()
        nxt_np = (nxt_rc // ph) if self._paneled_ph(nxt_rc) == ph else None
        if nxt_np is not None:
            variants.append(spec(nxt_np, cap_s, p_cap))
        # Every OTHER query bucket served so far, at the current geometry
        # AND the next panel count: a row_cap crossing re-specializes the
        # op for every bucket at once, but only the bucket that happened
        # to flush next used to get prewarmed — the rest (first flushes
        # of a phase, drain-tail remainders) each hit a cold compile.
        # Bounded: buckets are pow2 in
        # [256, _paneled_q_cap], so at most 6 entries.
        for qr, qe in list(self._paneled_qgeom.items()):
            if qr == q_rows_cap:
                continue
            variants.append(spec(n_panels, cap_s, p_cap, qe=qe, qr=qr))
            if nxt_np is not None:
                variants.append(spec(nxt_np, cap_s, p_cap, qe=qe, qr=qr))
        # next q_ecap doubling for the current bucket (nnz drift upward
        # crosses the pow2 boundary eventually; monotone floor makes the
        # flap one-way, this makes the crossing warm)
        variants.append(spec(n_panels, cap_s, p_cap, qe=2 * q_ecap))
        if self._ent is not None:
            # the consolidation itself re-sorts on device at the new cap
            ent_avals = tuple(aval(a) for a in self._ent)
            variants.append(
                ("sortfp", ent_avals, aval(self._counts_dev), 2 * cap_s)
            )
        # cap-growth variants LAST (drained first): candidate counts rise
        # with the live row count, so the pairs level (and eventually all
        # three) WILL overflow at steady ingest — the single-level and
        # all-level doublings cover grow_caps' two realistic next states
        c0, c1, c2 = caps
        variants.append(spec(n_panels, cap_s, p_cap,
                             (2 * c0, 2 * c1, 2 * c2)))
        variants.append(spec(n_panels, cap_s, p_cap, (2 * c0, c1, c2)))
        with self._prewarm_lock:
            for key in variants:
                self._prewarm_specs[key] = None
                self._prewarm_specs.move_to_end(key)
            # bound must hold the full cross-bucket fan-out (6 buckets x
            # 2 panel counts + 5 geometry/cap variants), or enqueueing one
            # round would evict the previous round before the worker runs
            while len(self._prewarm_specs) > 32:
                self._prewarm_specs.popitem(last=False)

    def _run_match(self, q, q_base: int, q_rows_cap: int, tau_eff):
        """Dispatch one streaming match with overflow retry; returns
        (index_rows, query_locals) candidate arrays."""
        if self._match_bits:
            from ..ops import bits

            caps = getattr(self, "_match_caps", None)
            if caps is None:
                c = pow2_bucket(int(self.cfg.extract_cap), 1024)
                cb = max(c // bits.GROUP, 1024)
                caps = (c, cb, cb)
            while True:
                bufs, packed = self._op_match_bits(
                    q, q_base, tau_eff, q_rows_cap, caps
                )
                rows_h, cols_h, total, groups, supers = (
                    bits.unpack_head(np.asarray(packed))
                )
                if (
                    total > caps[0] or groups > caps[1] or supers > caps[2]
                ):
                    caps = score_ops.grow_caps(
                        caps, (total, groups, supers)
                    )
                    continue
                break
            # tighten toward observed counts (shared 8x-hysteresis rule)
            self._match_caps = score_ops.tighten_caps(
                (total, groups, supers), caps
            )
            if total <= rows_h.size:
                return rows_h, cols_h
            return score_ops.decode_pairs(bufs, total)
        cap = int(self.cfg.extract_cap)
        grp = int(self.cfg.extract_group)
        while True:
            bufs, packed = self._op_match(
                q, q_base, tau_eff, q_rows_cap, cap, grp
            )
            pairs, needed = score_ops.consume_packed(
                bufs, np.asarray(packed), cap, grp
            )
            if pairs is not None:
                return pairs
            cap = _next_cap(cap, needed)

    def _op_topk(self, q, q_rows_cap: int, kf: int):
        mslab = self._match_slabs()
        if mslab is not None:
            # precision must match the slab dtype the engine promised the
            # fetch margin for: fp32 slabs (matmul_precision="highest")
            # keep the narrow margin ONLY if the dot is fp32-exact too
            return chunked_ops.cached_topk(
                mslab, *q, np.int32(self.n_rows), q_rows_cap, kf,
                self.cfg.matmul_precision,
            )
        return chunked_ops.chunked_topk(
            *self._ent, self._counts_dev, *q, np.int32(self.n_rows),
            self.row_cap, self._chunk_width, q_rows_cap, kf, "highest",
        )

    # ------------------------------------------------------------------ build
    def build(self, vectors, ids: Sequence[str] | None = None) -> dict:
        import jax.numpy as jnp

        t0 = time.time()
        csr, self.ids = _as_csr(vectors, ids, self.cfg.vector_dim)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._row_cap_state = None  # fresh corpus: exact cap, no padding
        self._sort_state = None
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
        # per-external-dim document frequencies for host-match routing
        self._ext_df = np.bincount(
            csr.indices, minlength=self.cfg.vector_dim
        ).astype(np.int64)
        self.n_rows = csr.n_rows
        self._compact = CompactSpace.from_csr(
            csr, self.cfg.dim_bucket,
            min_df=2 if self.cfg.dormant_dims else 1,
        )
        kept = self._archive_dormant(csr)
        # gather-only dim remap: the bucketing below is order-free, so the
        # row-sorted CSR ``map_csr`` builds (a 22M-entry lexsort + re-gather
        # at 200k rows) is pure waste on this path
        ccols = self._compact.map_cols(kept.indices)
        self._q_super()
        n_chunks = self._round_chunks(
            max(1, -(-self._compact.n_active // self.chunk_dim))
        )
        self._n_chunks = n_chunks
        rows_of = np.repeat(
            np.arange(kept.n_rows, dtype=np.int32), np.diff(kept.indptr)
        )
        chunk, local = chunked_ops.split_chunks(ccols, n_chunks)
        per = np.bincount(chunk, minlength=n_chunks).astype(np.int64)
        self._chunk_cap = pow2_bucket(max(int(per.max()) if per.size else 1, 1), 1024)
        rows2d, cols2d, vals2d, counts = chunked_ops.bucket_split_entries(
            rows_of, chunk, local, kept.data,
            per, self._chunk_cap, self._pad_row(),
        )
        self._ent_host = (rows2d, cols2d, vals2d)  # retained: see __init__
        self._ent = self._place_ent(rows2d, cols2d, vals2d)
        self._mslab = None  # new corpus: resident slabs rebuild lazily
        self._counts = counts
        self._counts_dev = self._place_counts(counts)
        self._stripe_caps = None  # new corpus: forget grown extraction caps
        self._panel_caps = None
        self._match_caps = None
        # the compact-dim rescore translation is keyed only by
        # (n_rows, nnz) — a rebuilt same-shaped corpus would collide and
        # feed the fp64 rescore a STALE translation (wrong dots)
        self._compact_rescore_cache = None
        # margin bookkeeping (same policy as the dense engine)
        norms = csr.row_norms()
        self._max_norm = float(norms.max()) if norms.size else 0.0
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self.stats["vectors_indexed"] += csr.n_rows
        return {
            "n_rows": self.n_rows,
            "row_cap": self.row_cap,
            "n_chunks": n_chunks,
            "chunk_dim": self.chunk_dim,
            "entries": int(csr.indptr[-1]),
            "chunk_cap": self._chunk_cap,
            "build_seconds": time.time() - t0,
        }

    def _pad_row(self) -> int:
        # pad entries scatter out of bounds for ANY current/future row_cap:
        # use a row index no slab will ever reach
        return (1 << 30)

    # margin policy shared with the dense engine (ONE definition — see
    # Engine._margin_rel): same bf16 slack, same nnz-scaled fp32 bound,
    # same loud failure when tau is below the margin
    _margin_rel = Engine._margin_rel
    _margin = Engine._margin
    _tau_eff = Engine._tau_eff

    def _max_row_nnz(self) -> int:
        """Largest shadow-row nnz (the n in the fp32 accumulation bound)."""
        if self._shadow is None:
            return 0
        sh = self._shadow.view()
        if sh.n_rows == 0:
            return 0
        return int(sh.row_nnz().max())

    # profiling hook shared with the dense engine (profile_dir config ->
    # jax.profiler trace around every all_pairs/insert)
    _maybe_trace = Engine._maybe_trace

    # ----------------------------------------------------------------- insert
    def insert(
        self,
        vectors: Sequence[Tuple[str, "object"]],
        tau: float | None = None,
        bulk: bool = False,
        defer: bool = False,
    ):
        with self._maybe_trace(), self.timer.section("insert"):
            return self._insert_impl(vectors, tau, bulk, defer)

    def _insert_impl(
        self,
        vectors: Sequence[Tuple[str, "object"]],
        tau: float | None = None,
        bulk: bool = False,
        defer: bool = False,
    ):
        """Streaming micro-batch insert matched online against the live
        chunked index (WriteWorkerActor.scala:185-202 semantics at
        out-of-core scale): index-before-query, intra-batch pairs emitted
        symmetrically; component filter (``index_threshold``) on the
        streaming path only (fine-print #5)."""
        import jax.numpy as jnp

        from .engine import _CompletedInsert

        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        filtered = []
        for vid, vec in vectors:
            if not bulk:
                if self.cfg.index_threshold > 0:
                    vec = vec.filter_values_above(self.cfg.index_threshold)
                if not self._admit(vec, tau):
                    self.stats["vectors_dropped_admission"] += 1
                    continue
            filtered.append((vid, vec))
        if not filtered:
            out = SimilarityOutput({}, time.time())
            return _CompletedInsert(out) if defer else out
        csr, new_ids = _as_csr(filtered, None, self.cfg.vector_dim)
        if self._shadow is None:
            if self._frozen:
                # frozen before anything was indexed: match-only against an
                # empty index — nothing to match, and nothing may be indexed
                # (the dense engine's frozen-first ordering)
                out = SimilarityOutput({}, time.time())
                return _CompletedInsert(out) if defer else out
            st = self.build(csr, new_ids)
            # match the fresh corpus against itself for the emission contract
            out = self._emit(self._match_rows(0, tau), new_ids, 0, tau)
            return _CompletedInsert(out) if defer else out

        n0 = self.n_rows
        if self._frozen:
            out = self._match_external(csr, new_ids, tau)
            return _CompletedInsert(out) if defer else out
        self.stats["insert_batches"] += 1
        self.stats["vectors_indexed"] += csr.n_rows

        # host bookkeeping first (margins must cover the batch's norms)
        norms = csr.row_norms()
        if norms.size:
            self._max_norm = max(self._max_norm, float(norms.max()))
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self._shadow.append(csr)
        if getattr(self, "_ext_df", None) is not None:
            np.add.at(self._ext_df, csr.indices, 1)
        self.ids.extend(new_ids)
        for k, vid in enumerate(new_ids):
            self.id_to_row[vid] = n0 + k
        self.n_rows = n0 + csr.n_rows

        # map to compact cols (minting columns for promoted dims only —
        # fresh df==1 dims stay archived host-side), activate any archived
        # partners, bucket by chunk, append
        keep_csr = self._stream_archive_singletons(csr, n0)
        self._activate_dormant(csr.indices)
        ccsr = self._compact.map_csr(keep_csr, extend=False)
        rows_of = n0 + np.repeat(
            np.arange(csr.n_rows, dtype=np.int64), np.diff(ccsr.indptr)
        )
        self._append_ccoo(rows_of, ccsr.indices, ccsr.data)

        out = self._emit(self._match_rows(n0, tau), new_ids, n0, tau)
        self._maybe_prewarm()
        return _CompletedInsert(out) if defer else out

    def _append_ccoo(self, rows_of, ccols, vals, tail: bool = True) -> None:
        """Append COO entries (global rows, COMPACT cols, values) into the
        per-chunk device buffers: chunk-bucket, grow capacity as needed, one
        padded scatter-append, counts refresh.  ``tail=True`` marks a
        streaming batch (rows >= every existing row — extends the sorted
        flat COO in place); ``tail=False`` marks a dormant ACTIVATION
        (old, non-contiguous rows — routed to the sorted state's overflow
        region)."""
        import jax.numpy as jnp

        chunk, local = chunked_ops.split_chunks(ccols, self._n_chunks)
        add = np.bincount(chunk, minlength=self._n_chunks).astype(np.int64)
        need = int((self._counts + add).max()) if chunk.size else 0
        while need > self._chunk_cap:
            self._chunk_cap *= 2
            self._op_grow(self._chunk_cap)
            if self._ent_host is not None:  # mirror the pad (same contract)
                r, c, v = self._ent_host
                grow = self._chunk_cap - r.shape[1]
                self._ent_host = (
                    np.pad(r, ((0, 0), (0, grow)),
                           constant_values=self._pad_row()),
                    np.pad(c, ((0, 0), (0, grow))),
                    np.pad(v, ((0, 0), (0, grow))),
                )
        order = np.argsort(chunk, kind="stable")
        ch = chunk[order]
        starts = np.zeros(self._n_chunks + 1, np.int64)
        np.cumsum(add, out=starts[1:])
        slot = (
            np.arange(chunk.size) - starts[ch] + self._counts[ch]
        ).astype(np.int32)
        # ONE packed [5, cap_e] int32 H2D (chunk / slot / row / local / fp32
        # bits) — the five-array form paid five serialized transfer round
        # trips per streaming batch; padding rows
        # carry chunk == n_chunks (out of bounds -> dropped)
        cap_e = pow2_bucket(max(chunk.size, 1), 256)
        coo5 = np.empty((5, cap_e), np.int32)
        coo5[0, : chunk.size] = ch
        coo5[0, chunk.size :] = self._n_chunks
        coo5[1, : chunk.size] = slot
        coo5[2, : chunk.size] = np.asarray(rows_of)[order]
        coo5[3, : chunk.size] = local[order]
        coo5[4, : chunk.size] = (
            np.asarray(vals)[order].astype(np.float32).view(np.int32)
        )
        coo5[1:, chunk.size :] = 0
        coo5_dev = jnp.asarray(coo5)  # ONE H2D shared by both appends
        self._op_append(coo5_dev)
        self._sort_state_append(coo5_dev, rows_of, chunk.size, tail)
        if self._ent_host is not None and chunk.size:
            # identical scatter host-side (pad entries carry chunk ==
            # n_chunks and were excluded from ch/slot already)
            r, c, v = self._ent_host
            r[ch, slot] = coo5[2, : chunk.size]
            c[ch, slot] = coo5[3, : chunk.size]
            v[ch, slot] = coo5[4, : chunk.size].view(np.float32)
        self._counts = self._counts + add
        self._counts_dev = self._place_counts(self._counts)

    def _activate_dormant(self, ext_dims: np.ndarray) -> None:
        """Insert-time activation: archived df==1 entries whose dim just got
        a compact column move into the chunk buffers so new×old pairs through
        those dims score on device (dense analog: Engine._activate_dormant,
        which scatters into the dense matrix instead)."""
        if self._dormant_of_ext is None:
            return
        uniq = np.unique(np.asarray(ext_dims))
        idxs = self._dormant_of_ext[uniq]
        sel = idxs >= 0
        if not sel.any():
            return
        dims, idxs = uniq[sel], idxs[sel]
        cols = self._compact.cols_of(dims).astype(np.int64)
        # this batch's fresh singletons are archived but still unmapped —
        # only dims that just received a compact column activate
        ok = cols >= 0
        if not ok.any():
            return
        dims, idxs, cols = dims[ok], idxs[ok], cols[ok]
        self._append_ccoo(
            self._dorm_rows[idxs], cols, self._dorm_vals[idxs], tail=False
        )
        # clear the marks only after the device append went through (a
        # failure above leaves the entries archived — recoverable; see
        # Engine._activate_dormant)
        self._dormant_of_ext[dims] = -1
        self.stats["dormant_dims"] -= int(dims.size)

    def _bucket_queries(self, ccsr: CSRMatrix, q_rows_cap: int):
        """Chunk-bucket a compact query CSR into 2-D buffers."""
        import jax.numpy as jnp

        rows_of = np.repeat(
            np.arange(ccsr.n_rows, dtype=np.int64), np.diff(ccsr.indptr)
        )
        chunk, _ = chunked_ops.split_chunks(ccsr.indices, self._n_chunks)
        per = np.bincount(chunk, minlength=self._n_chunks)
        q_cap = pow2_bucket(max(int(per.max()) if per.size else 1, 1), 256)
        r2, c2, v2, cnts = chunked_ops.bucket_entries(
            rows_of, ccsr.indices.astype(np.int64), ccsr.data,
            self._n_chunks, q_cap, q_rows_cap,
        )
        return self._place_q((
            jnp.asarray(r2), jnp.asarray(c2), jnp.asarray(v2),
            jnp.asarray(cnts.astype(np.int32)),
        ))

    # ---------------------------------------------- host streaming match
    # Beyond the resident-slab budget the device rebuild path pays a FIXED
    # full-corpus re-scatter per micro-batch.  At that scale the
    # reference's own inverted-index shape wins: one sparse spGEMM of the
    # corpus CSR against the micro-batch (O(corpus nnz) streamed in C,
    # scipy SMMP) yields the candidate set the device epilogue would,
    # feeding the same fp64 rescore in ``_emit``.  Candidates are cut at
    # ``tau - 1e-9`` (both sides fp64; the margin covers summation-order
    # deltas), so the emitted pair set is unchanged — and it is naturally a
    # superset of the device path's (archived dormant entries live in the
    # shadow), never smaller.  The mesh subclass keeps its sharded device
    # path (``_match_slab_cache_ok = False`` gates this off there).
    _host_stream_match = True

    # Host-vs-device routing cost model.
    # The scipy SMMP's cost is NOT one corpus pass: it also pays per
    # intersection flop AND materializes every nonzero (i, q) dot before
    # the tau filter — on a 500k-row power-law corpus a 256-row batch hits
    # ~128M intersections (every pair shares a hot dim), while on
    # TF-IDF-like corpora intersections are sparse and the host walk wins.
    # Estimate flops as sum over batch entries of the corpus document
    # frequency of their dim (an upper bound on intersections incl.
    # multiplicity) and route to whichever side the model says is cheaper.
    # The host terms are CPU calibrations; the device term is OBSERVED: the
    # fastest device match per corpus nnz this engine has timed with no
    # compile in flight.  Until one has been timed, matches stay on the
    # device.
    _host_ns_per_nnz = 6.0     # corpus-stream term of the SMMP
    _host_ns_per_flop = 70.0   # per intersection flop + COO materialization
    _rebuild_ns_per_nnz: float | None = None  # device match, observed

    def _use_host_match(self, q_ext_indices: np.ndarray) -> bool:
        """Route this batch's match to the host spGEMM?  ``q_ext_indices``
        are the query entries' EXTERNAL dims (shadow space)."""
        if not (self._host_stream_match and self._match_slab_cache_ok):
            return False
        try:
            import scipy.sparse  # noqa: F401
        except Exception:  # pragma: no cover
            return False
        # resident slabs (within budget) beat the host walk — only route
        # host when the device side would pay the per-batch rebuild
        if self._match_slabs() is not None or self._ent is None:
            return False
        df = getattr(self, "_ext_df", None)
        if df is None or self._rebuild_ns_per_nnz is None:
            return False  # no df stats (old restore) or no device timing
        nnz = int(self._shadow.view().indptr[-1])
        est_flops = int(df[np.asarray(q_ext_indices)].sum())
        host_cost = nnz * self._host_ns_per_nnz + (
            est_flops * self._host_ns_per_flop
        )
        return host_cost < nnz * self._rebuild_ns_per_nnz

    def _host_match_cross(self, q_csr: CSRMatrix, tau: float):
        """Candidates (index_row, query_local) of the full shadow x queries
        at fp64, threshold ``tau - 1e-9``."""
        import scipy.sparse as sp

        shadow = self._shadow.view()
        x = sp.csr_matrix(
            (shadow.data, shadow.indices, shadow.indptr),
            shape=(shadow.n_rows, shadow.n_cols), copy=False,
        )
        q = sp.csr_matrix(
            (q_csr.data, q_csr.indices, q_csr.indptr),
            shape=(q_csr.n_rows, q_csr.n_cols), copy=False,
        )
        # X @ Q.T: SMMP streams the corpus nnz once; Q.T's csc->csr
        # conversion is O(batch nnz + n_cols)
        c = (x @ q.T).tocoo()
        keep = c.data >= tau - 1e-9
        return (
            c.row[keep].astype(np.int64),
            c.col[keep].astype(np.int64),
        )

    def _host_match_rows(self, n0: int, tau: float):
        """Host analog of ``_match_rows``: queries are shadow rows
        [n0, n_rows) (already appended — index-before-query), so intra-batch
        pairs surface in both orders and only the self-pair is excluded."""
        shadow = self._shadow.view()
        sub = CSRMatrix(
            shadow.n_rows - n0, shadow.n_cols,
            (shadow.indptr[n0:] - shadow.indptr[n0]).astype(np.int64),
            shadow.indices[shadow.indptr[n0]:],
            shadow.data[shadow.indptr[n0]:],
        )
        rows, qloc = self._host_match_cross(sub, tau)
        nonself = rows != (n0 + qloc)
        return rows[nonself], qloc[nonself]

    def _match_rows(self, n0: int, tau: float):
        """Cross-match index rows [n0, n_rows) (already appended) against the
        full index; returns (index_row, query_local) candidate arrays."""
        sh = self._shadow.view()
        if self._use_host_match(sh.indices[sh.indptr[n0]:]):
            return self._host_match_rows(n0, tau)
        nq = self.n_rows - n0
        shadow = self._shadow.view()
        sub = CSRMatrix(
            nq, shadow.n_cols,
            (shadow.indptr[n0:] - shadow.indptr[n0]).astype(np.int64),
            shadow.indices[shadow.indptr[n0]:],
            shadow.data[shadow.indptr[n0]:],
        )
        # unmapped query dims are always lossless to drop here: build-time
        # dormant dims (df==1) and streaming-archived fresh singletons are
        # each globally unique to ONE row, so they can only contribute to
        # the excluded self-pair; any dim shared with another batch row was
        # promoted by _stream_archive_singletons before this point
        sub = self._drop_unmapped(sub)
        ccsr = self._compact.map_csr(sub, extend=False)
        return self._timed_device_match(ccsr, n0, self._tau_eff(tau))

    def _timed_device_match(self, ccsr: CSRMatrix, q_base: int, tau_eff):
        """``_match_ccsr``, timed into the router's device term when the
        match runs without resident slabs (the case the router weighs)."""
        if self._match_slabs() is not None:
            return self._match_ccsr(ccsr, q_base, tau_eff)
        c0 = _compile_count()
        t0 = time.perf_counter()
        out = self._match_ccsr(ccsr, q_base, tau_eff)
        if _compile_count() == c0:
            nnz = max(int(self._shadow.view().indptr[-1]), 1)
            ns = (time.perf_counter() - t0) * 1e9 / nnz
            prev = self._rebuild_ns_per_nnz
            self._rebuild_ns_per_nnz = ns if prev is None else min(prev, ns)
        return out

    def _match_width_limit(self) -> int:
        """Largest pow2 query width whose ``[row_cap, width]`` fp32 match
        accumulator stays under its memory share (the ``_q_super`` budget
        policy applied to the match side).  At 1M rows this is 1024 — without it
        a 2048-row flush batch allocates an 8.6 GB accumulator next to the
        1M-row entry buffers and OOMs the chip.  Floor 256 so very large
        corpora can't fragment ordinary batches."""
        budget = memory.budget(memory.ACCUMULATOR) // (4 * self.row_cap)
        w = 256
        while w * 2 <= budget:
            w *= 2
        return w

    def _match_ccsr(self, ccsr: CSRMatrix, q_base: int, tau_eff):
        """Match a compact-space query CSR against the full index, splitting
        the query set into width-bounded sub-batches (the WHOLE batch is
        already indexed before any matching, so intra-batch pairs surface
        regardless of the split point).  Returns (index_row, query_local)."""
        nq = ccsr.n_rows
        paneled = self._paneled_ok()
        limit = (
            int(self._paneled_q_cap) if paneled
            else self._match_width_limit()
        )
        # beyond the resident-slab budget the per-batch cost is dominated by
        # the O(corpus) chunk densify, so padding small batches up to a 256
        # bucket is ~free — and it collapses the q_rows_cap compile surface
        # to the handful of geometries the prewarmer keeps warm (a cold
        # drain-tail bucket would otherwise stall on a compile after a
        # crossing)
        floor = 32 if self._match_slabs() is not None else 256

        def run_one(part: CSRMatrix, base: int):
            if paneled:
                return self._run_match_paneled(part, base, tau_eff)
            q_rows_cap = min(pow2_bucket(part.n_rows, floor), limit)
            q = self._bucket_queries(part, q_rows_cap)
            return self._run_match(q, base, q_rows_cap, tau_eff)

        if nq <= limit:
            return run_one(ccsr, q_base)
        rows_all: list = []
        loc_all: list = []
        for s in range(0, nq, limit):
            e = min(s + limit, nq)
            part = CSRMatrix(
                e - s, ccsr.n_cols,
                (ccsr.indptr[s:e + 1] - ccsr.indptr[s]).astype(np.int64),
                ccsr.indices[ccsr.indptr[s]:ccsr.indptr[e]],
                ccsr.data[ccsr.indptr[s]:ccsr.indptr[e]],
            )
            # q_base + s keeps the global self-pair exclusion aligned with
            # this sub-range's true index rows
            r, l = run_one(part, q_base + s)
            rows_all.append(np.asarray(r, np.int64))
            loc_all.append(np.asarray(l, np.int64) + s)
        return np.concatenate(rows_all), np.concatenate(loc_all)

    def _emit(self, pairs, qids: List[str], n0: int, tau: float):
        rows, qlocal = pairs
        shadow = self._shadow.view()
        if len(rows) == 0:
            return SimilarityOutput({}, time.time())
        self.stats["candidates_scored"] += len(rows)
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data,
            np.asarray(rows, np.int64), np.asarray(qlocal, np.int64) + n0,
            shadow.n_cols,
        )
        out: Dict[str, Dict[str, float]] = {}
        keep = sims >= tau
        for r, q, s in zip(
            np.asarray(rows)[keep], np.asarray(qlocal)[keep], sims[keep]
        ):
            out.setdefault(qids[int(q)], {})[self.ids[int(r)]] = float(s)
        self.stats["pairs_emitted"] += sum(len(v) for v in out.values())
        return SimilarityOutput(out, time.time())

    def _match_external(self, csr: CSRMatrix, qids, tau: float):
        """Frozen-index matching: queries scored but not indexed."""
        qn = csr.row_norms()
        saved = None
        if qn.size and float(qn.max()) > self._max_norm:
            saved, self._max_norm = self._max_norm, float(qn.max())
        if self._use_host_match(csr.indices):
            # full-shadow spGEMM: archived dormant contributions are
            # already in the shadow, so no _dormant_hits patch needed
            rows, qlocal = self._host_match_cross(csr, tau)
        else:
            sub = self._drop_unmapped(csr)
            ccsr = self._compact.map_csr(sub, extend=False)
            # q_base beyond all rows: no self-pair exclusion can trigger
            rows, qlocal = self._timed_device_match(
                ccsr, self.n_rows, self._tau_eff(tau)
            )
            # queries sharing a dormant dim with an archived row: the
            # device score missed that contribution — explicit candidates
            extra_q, extra_r = self._dormant_hits(csr)
            if extra_q.size:
                rows = np.concatenate([np.asarray(rows), extra_r])
                qlocal = np.concatenate([np.asarray(qlocal), extra_q])
        shadow = self._shadow.view()
        out: Dict[str, Dict[str, float]] = {}
        if len(rows):
            sims = rescore_ops.cross_pair_dots(
                shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                csr.indptr, csr.indices, csr.data,
                np.asarray(qlocal, np.int64), np.asarray(rows, np.int64),
            )
            keep = sims >= tau
            for r, ql, s in zip(
                np.asarray(rows)[keep], np.asarray(qlocal)[keep], sims[keep]
            ):
                out.setdefault(qids[int(ql)], {})[self.ids[int(r)]] = float(s)
        if saved is not None:
            self._max_norm = saved
        return SimilarityOutput(out, time.time())

    # ----------------------------------------------------------------- freeze
    def freeze(self) -> None:
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------------- checkpoint
    # Same on-disk format as the dense engine (one atomic npz snapshot of the
    # host shadow + ids), so checkpoints are interchangeable across engine
    # flavors: a dense-engine checkpoint restores into a chunked engine when
    # a corpus outgrows HBM, and vice versa.
    save = Engine.save

    def _extra_npz(self) -> dict:
        """Chunked-flavor checkpoint extras: the host mirror of the
        per-chunk device buffers + every derived host structure the build
        pass computes, so :meth:`restore` is a device placement instead of
        a rebuild (no unique/df-sort, no dim remap, no bucketing scans).
        All keys are ``chunk_``-prefixed; other flavors ignore them."""
        if self._ent_host is None:
            return {}
        rows2d, cols2d, vals2d = self._ent_host
        dorm_map = self._dormant_of_ext
        has_map = dorm_map is not None
        return {
            "chunk_rows2d": rows2d,
            "chunk_cols2d": cols2d,
            "chunk_vals2d": vals2d,
            "chunk_counts": self._counts,
            "chunk_geom": np.array(
                [self._n_chunks, self._chunk_cap, self.chunk_dim,
                 int(self.cfg.dormant_dims)], np.int64,
            ),
            "chunk_ext_of_col": self._compact.ext_of_col,
            "chunk_base": np.array(
                [self._compact._base, self._compact.dim_bucket], np.int64
            ),
            "chunk_ext_df": getattr(
                self, "_ext_df", np.empty(0, np.int64)
            ),
            "chunk_max_norm": np.array([self._max_norm], np.float64),
            "chunk_dorm_rows": self._dorm_rows,
            "chunk_dorm_dims": self._dorm_dims,
            "chunk_dorm_vals": self._dorm_vals,
            # _dormant_of_ext stored sparse (dims with a live archive slot);
            # an int32 over vector_dim would be 4 MB of mostly -1
            "chunk_dorm_map_dims": (
                np.nonzero(dorm_map >= 0)[0] if has_map
                else np.empty(0, np.int64)
            ),
            "chunk_dorm_map_idx": (
                dorm_map[dorm_map >= 0] if has_map
                else np.empty(0, np.int32)
            ),
            "chunk_dorm_has_map": np.array([int(has_map)], np.int64),
        }

    def restore(self, path: str) -> None:
        """Restore this (empty) engine from a checkpoint (any flavor).

        A chunked-flavor checkpoint carries the device-buffer layout
        (``chunk_*`` extras, :meth:`_extra_npz`), so restore places the
        saved buffers directly — O(read + H2D), no rebuild pass (VERDICT
        r3 #7).  Cross-flavor checkpoints (dense engine), pre-extras
        snapshots, or geometry-incompatible configs (different
        ``chunk_dim`` / dormancy / mesh chunk rounding) fall back to the
        full build from the CSR shadow — always correct, just slower."""
        if self.n_rows:
            raise RuntimeError("restore() on a non-empty engine")
        csr, ids, max_weights, ckpt_cfg = Engine.read_checkpoint(path)
        if int(ckpt_cfg["vector_dim"]) != self.cfg.vector_dim:
            raise ValueError(
                f"checkpoint vector_dim {ckpt_cfg['vector_dim']} != engine "
                f"config vector_dim {self.cfg.vector_dim} ({path})"
            )
        if csr.n_rows:
            import os

            z = np.load(os.path.join(path, "index.npz"))
            if self._fast_restorable(z):
                self._fast_restore(csr, ids, z)
            else:
                self.build(csr, ids)
        # merge the stored maxima (may record admission-dropped vectors) with
        # the build-recomputed corpus maxima — same policy as Engine.restore
        self.max_weights = np.maximum(self.max_weights, max_weights)
        Engine._restore_static_map(self, path)

    def _fast_restorable(self, z) -> bool:
        if "chunk_geom" not in z:
            return False  # cross-flavor or pre-extras checkpoint
        n_chunks, chunk_cap, chunk_dim, dormant = (
            int(v) for v in z["chunk_geom"]
        )
        return (
            chunk_dim == self.chunk_dim
            and dormant == int(self.cfg.dormant_dims)
            # a mesh subclass needs n_chunks divisible by its device count
            and self._round_chunks(n_chunks) == n_chunks
        )

    def _fast_restore(self, csr: CSRMatrix, ids, z) -> None:
        """Place the checkpointed device layout; skip every build pass."""
        n_chunks, chunk_cap, _, _ = (int(v) for v in z["chunk_geom"])
        self.ids = list(ids)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._row_cap_state = None  # restored corpus: exact cap
        self._sort_state = None
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
        self.n_rows = csr.n_rows
        self._n_chunks = n_chunks
        self._chunk_cap = chunk_cap
        self._ext_df = z["chunk_ext_df"]
        if self._ext_df.size == 0:
            self._ext_df = None
        base, dim_bucket = (int(v) for v in z["chunk_base"])
        cs = CompactSpace(self.cfg.vector_dim, dim_bucket)
        cs.ext_of_col = z["chunk_ext_of_col"].astype(np.int64)
        cs._col_of_ext[cs.ext_of_col] = np.arange(
            cs.n_active, dtype=np.int32
        )
        cs._base = base
        self._compact = cs
        self._dorm_rows = z["chunk_dorm_rows"]
        self._dorm_dims = z["chunk_dorm_dims"]
        self._dorm_vals = z["chunk_dorm_vals"]
        self._dorm_buf = None
        if int(z["chunk_dorm_has_map"][0]):
            m = np.full(self.cfg.vector_dim, -1, np.int32)
            m[z["chunk_dorm_map_dims"]] = z["chunk_dorm_map_idx"]
            self._dormant_of_ext = m
            self.stats["dormant_dims"] = int(
                z["chunk_dorm_map_dims"].size
            )
        else:
            self._dormant_of_ext = None
        rows2d = z["chunk_rows2d"]
        cols2d = z["chunk_cols2d"]
        vals2d = z["chunk_vals2d"]
        self._ent_host = (rows2d, cols2d, vals2d)
        self._ent = self._place_ent(rows2d, cols2d, vals2d)
        self._mslab = None
        self._counts = z["chunk_counts"]
        self._counts_dev = self._place_counts(self._counts)
        self._stripe_caps = None
        self._panel_caps = None
        self._match_caps = None
        self._compact_rescore_cache = None
        self._max_norm = float(z["chunk_max_norm"][0])
        self._q_super()
        self.stats["vectors_indexed"] += csr.n_rows

    @classmethod
    def load(
        cls, path: str, config: AllPairsConfig | None = None, **kw
    ) -> "ChunkedAllPairs":
        _, _, _, ckpt_cfg = Engine.read_checkpoint(path)
        cfg = config or AllPairsConfig().replace(
            vector_dim=int(ckpt_cfg["vector_dim"]),
            similarity_threshold=float(ckpt_cfg["similarity_threshold"]),
            dtype=str(ckpt_cfg["dtype"]),
        )
        eng = cls(cfg, **kw)
        eng.restore(path)
        return eng

    # ------------------------------------------------------- panel join
    # Row panels densified once from a row-sorted int8 COO, every panel
    # pair scored by the int8 panel scorer (ops/panel.py: int8 dot, bound
    # epilogue, bit-packed compaction).  Stripes remain the fallback
    # (int8 safety-gate trips, unsupported geometry).

    _use_panels = True  # class-level opt-out
    # panel height of the join: a panel pair's int32 score rectangle is
    # rb² · 4 bytes (268 MB at 8192)
    _panel_rows_max = 8192

    def _panel_ok(self) -> bool:
        if not (self._use_panels and self.cfg.pallas_int8):
            return False
        return self._panel_geom() is not None

    def _panel_d_local(self, d_cap: int) -> int:
        """Per-device slab width (the mesh subclass column-shards slabs)."""
        return d_cap

    def _panel_geom(self):
        """(rb, n_panels, d_cap) or None when no panel geometry fits:
        ``rb`` is ``panel_rows`` when given, else the corpus height rounded
        to 64 rows and capped at ``_panel_rows_max``, halved while one
        slab exceeds its device-memory share."""
        d_cap = self._n_chunks * self._chunk_width
        if self.panel_rows is not None:
            rb = self.panel_rows
        else:
            rb = min(self._panel_rows_max, round_up(max(self.n_rows, 1), 64))
            slab_budget = memory.budget(memory.PANEL_SLAB)
            while rb > 64 and rb * self._panel_d_local(d_cap) > slab_budget:
                rb = round_up(rb // 2, 64)
        if rb % 64:
            return None
        padded = round_up(max(self.n_rows, 1), rb)
        return (rb, padded // rb, d_cap)

    def _panel_state(self):
        """Cached per-join device state: row-sorted int8 COO + per-panel
        starts + padded aux.  Keyed by the immutable values array (any
        append invalidates) AND the geometry (n_rows growth re-sorts).
        None when the int32-accumulator safety gate trips."""
        geom = self._panel_geom()
        if geom is None:
            return None
        rb, n_panels, d_cap = geom
        key = (self._ent[2], geom)
        cached = getattr(self, "_panel_state_cache", None)
        # identity compare: the values array may be a DELETED donated buffer
        # after an insert — any value comparison on it would throw
        if (
            cached is not None
            and cached[0][0] is key[0]
            and cached[0][1] == key[1]
        ):
            return cached[1]
        import jax
        import jax.numpy as jnp

        from ..ops import panel as panel_ops

        q2d, aux, max_nnz = chunked_ops.quantize_chunk_entries(
            self._ent[0], self._ent[2], self.row_cap
        )
        if int(max_nnz) >= (1 << 30) // (127 * 127):
            state = None
        else:
            r_s, gc_s, q_s, pcounts = panel_ops.sort_entries_by_row(
                self._ent[0], self._ent[1], q2d, self._counts_dev,
                rb, n_panels,
            )
            pc = np.asarray(pcounts)[:n_panels].astype(np.int64)
            starts = np.zeros(n_panels + 1, np.int64)
            np.cumsum(pc, out=starts[1:])
            # clamp to the flat entry-array length: a non-pow2 n_chunks can
            # make the pow2 bucket exceed it, and dynamic_slice sizes must
            # not outgrow the operand (max panel count <= flat always)
            flat = int(np.prod(self._ent[0].shape))
            p_cap = min(
                pow2_bucket(max(int(pc.max()) if pc.size else 1, 1), 1024),
                flat,
            )
            state = {
                "geom": geom,
                "r_s": r_s, "gc_s": gc_s, "q_s": q_s,
                "starts": starts, "p_cap": p_cap,
                "aux_of": _panel_aux(aux, rb, n_panels),
            }
        self._panel_state_cache = (key, state)
        return state

    def _slab_bytes(self, rb: int, d_cap: int) -> int:
        """Per-DEVICE bytes of one int8 panel slab — what the sweep's
        resident/rolling budgets are compared against."""
        return rb * self._panel_d_local(d_cap)

    def _build_slab(self, state, p: int):
        from ..ops import panel as panel_ops

        rb, n_panels, d_cap = state["geom"]
        return panel_ops.build_panel_slab(
            state["r_s"], state["gc_s"], state["q_s"],
            np.int32(state["starts"][p]), np.int32(p * rb),
            rb, d_cap, state["p_cap"],
        )

    # panel-sweep budgets (bytes; None = the device-memory policy).
    # resident: if ALL slabs fit, keep them for the whole sweep (one
    # window).  sweep: bound on in-flight slabs in rolling mode.  Tests
    # shrink them to force rolling mode on tiny corpora.
    _panel_resident_bytes: int | None = None
    _panel_sweep_bytes: int | None = None
    # rolling-sweep shape caps: B = resident I-panels per J-scan,
    # jsync = J-builds between head-fetch sync points
    _panel_B_cap = 6
    _panel_jsync_cap = 6

    def _panel_budgets(self) -> tuple[int, int]:
        res, sweep = self._panel_resident_bytes, self._panel_sweep_bytes
        if res is None:
            res = memory.budget(memory.PANEL_RESIDENT)
        if sweep is None:
            sweep = memory.budget(memory.PANEL_SWEEP)
        return res, sweep

    def _op_panel_pair(self, state, xi, xj, pi, pj, tau_eff, caps, pack):
        """One panel pair through the single-device scorer (the mesh
        subclass reroutes this through shard_map: sharded slabs, per-device
        partial dot, int32 psum, replicated epilogue)."""
        import jax.numpy as jnp

        from ..ops import panel as panel_ops

        rb = state["geom"][0]
        return panel_ops.panel_pair_extract_int8(
            xi, xj, state["aux_of"][pi], state["aux_of"][pj],
            jnp.int32(pi * rb), jnp.int32(pj * rb), tau_eff,
            caps[0], caps[1], caps[2], pack,
        )

    def _all_pairs_panel(self, tau_eff):
        """Panel-pair sweep; returns (rows, cols) candidate arrays or None
        (caller falls back to the stripe path)."""
        import jax.numpy as jnp

        from ..ops import bits

        state = self._panel_state()
        if state is None:
            return None
        rb, n_panels, d_cap = state["geom"]
        pack = n_panels * rb <= 65536
        caps = getattr(self, "_panel_caps", None)
        if caps is None:
            c = pow2_bucket(int(self.cfg.extract_cap), 1024)
            cb = max(c // bits.GROUP, 1024)
            caps = (c, cb, cb)  # generous cap0 default: see bits

        slab_bytes = self._slab_bytes(rb, d_cap)
        resident_bytes, sweep_bytes = self._panel_budgets()
        keep_all = n_panels * slab_bytes <= resident_bytes

        def run_pair(xi, xj, pi, pj, cps):
            return self._op_panel_pair(
                state, xi, xj, pi, pj, tau_eff, cps, pack
            )

        slabs: dict = {}  # keep_all mode: panel -> resident slab

        def slab(p):
            if p not in slabs:
                slabs[p] = self._build_slab(state, p)
            return slabs[p]

        # Windowed dispatch: heads are fetched in ONE stacked D2H transfer
        # per window, not one blocking round trip per pair.  Window entries
        # hold NO slab references: a cap-overflow retry (rare — once per
        # cap growth, then the tightened caps stick) rebuilds its two slabs
        # instead, so slab lifetime is governed purely by the dispatch
        # pipeline (see the rolling sweep below).
        pending = []  # settled (rows, cols) HOST arrays per pair
        seen = (0, 0, 0)
        win: list = []  # (pi, pj, bufs, packed, run-time caps)

        def flush_window():
            nonlocal caps, seen
            if not win:
                return
            if len(win) > 1:
                heads = np.asarray(jnp.stack([w[3] for w in win]))
            else:
                heads = [np.asarray(win[0][3])]
            for (pi, pj, bufs, _, ecaps), head in zip(win, heads):
                rows_h, cols_h, total, groups, supers = (
                    bits.unpack_head(head)
                )
                # overflow is judged against THIS entry's run-time caps
                # (ecaps), not the shared ``caps`` an earlier entry's retry
                # may have grown: an entry that overflowed the caps it
                # actually ran with has clamp-truncated buffers even when
                # its counts fit the grown caps.
                while (
                    total > ecaps[0]
                    or groups > ecaps[1]
                    or supers > ecaps[2]
                ):
                    caps = score_ops.grow_caps(
                        caps, (total, groups, supers)
                    )
                    ecaps = caps
                    xi_r = (
                        slab(pi) if keep_all
                        else self._build_slab(state, pi)
                    )
                    xj_r = (
                        xi_r if pj == pi
                        else slab(pj) if keep_all
                        else self._build_slab(state, pj)
                    )
                    bufs, packed = run_pair(xi_r, xj_r, pi, pj, caps)
                    head = np.asarray(packed)
                    rows_h, cols_h, total, groups, supers = (
                        bits.unpack_head(head)
                    )
                seen = tuple(
                    max(a, b)
                    for a, b in zip(seen, (total, groups, supers))
                )
                # settle to HOST arrays now: keeping every pair's cap-sized
                # device buffers alive until the sweep ends would hold
                # O(n_pairs x cap) HBM at the join's peak moment
                if total <= rows_h.size:
                    pending.append((rows_h[:total], cols_h[:total]))
                else:
                    pending.append(score_ops.decode_pairs(bufs, total))
            win.clear()

        if keep_all:
            # all slabs resident: one window, one stacked head fetch
            for pi in range(n_panels):
                xi = slab(pi)
                for pj in range(pi, n_panels):
                    xj = xi if pj == pi else slab(pj)
                    bufs, packed = run_pair(xi, xj, pi, pj, caps)
                    win.append((pi, pj, bufs, packed, caps))
            flush_window()
        else:
            # Blocked-I rolling sweep: B row panels stay resident for one
            # J-scan, so each J-slab build serves B panel pairs (slab builds
            # fall from ~n_pairs to ~n_pairs/B — at 1M rows that is ~2000
            # rebuilds down to ~450).  The stacked-head fetch in
            # flush_window is the pipeline sync point: it blocks until every
            # enqueued kernel ran, retiring all J-slabs built before it
            # (their only refs are the pending computations), so flushing
            # every ``jsync`` J-builds bounds in-flight slab HBM to
            # (B + jsync + 1) slabs = S · slab_bytes ≤ the sweep budget.
            S = max(3, int(sweep_bytes // max(slab_bytes, 1)))
            B = min(max(1, S // 2), self._panel_B_cap, n_panels)
            jsync = min(max(1, S - B - 1), self._panel_jsync_cap)
            for i0 in range(0, n_panels, B):
                iblk = list(range(i0, min(i0 + B, n_panels)))
                xis = {p: self._build_slab(state, p) for p in iblk}
                jbuilt = 0
                for pj in range(i0, n_panels):
                    xj = xis.get(pj)
                    if xj is None:
                        xj = self._build_slab(state, pj)
                        jbuilt += 1
                    for pi in iblk:
                        if pi > pj:
                            continue
                        bufs, packed = run_pair(xis[pi], xj, pi, pj, caps)
                        win.append((pi, pj, bufs, packed, caps))
                    del xj
                    if jbuilt >= jsync:
                        flush_window()
                        jbuilt = 0
                xis.clear()
                flush_window()  # block's I-slabs retire here
        del slabs

        all_i = [p[0] for p in pending]
        all_j = [p[1] for p in pending]
        self._panel_caps = score_ops.tighten_caps(seen, caps)
        if not all_i:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return np.concatenate(all_i), np.concatenate(all_j)

    # -------------------------------------------------------------- all_pairs
    def all_pairs(self, tau: float | None = None) -> PairResult:
        with self._maybe_trace(), self.timer.section("all_pairs"):
            return self._all_pairs_impl(tau)

    def _all_pairs_impl(self, tau: float | None = None) -> PairResult:
        # release the streaming slab cache first: the join's own slabs /
        # accumulators need the HBM, and the cache rebuilds lazily (one
        # densify sweep) on the next insert
        self._mslab = None
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        if self.n_rows == 0:
            return PairResult(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), [],
            )
        tau_eff = self._tau_eff(tau)
        if self._panel_ok():
            pairs = self._all_pairs_panel(tau_eff)
            if pairs is not None:
                self.join_route = "panels"
                return self._rescore_pairs(pairs[0], pairs[1], tau)
        self.join_route = "stripes"
        super_tile = self._q_super()
        all_i: list = []
        all_j: list = []
        from ..ops import bits

        # per-level extraction caps, cached across stripes AND calls (the
        # three-level bit-packed epilogue's deeper scans are sized by these)
        caps = getattr(self, "_stripe_caps", None)
        if caps is None:
            c = pow2_bucket(int(self.cfg.extract_cap), 1024)
            cb = max(c // bits.GROUP, 1024)
            caps = (c, cb, cb)  # generous cap0 default: see pallas_score
        # host loop over query stripes; a stripe wide enough to amortize the
        # per-chunk slab densify over many query columns
        seen = (0, 0, 0)  # per-call maxima for post-loop cap tightening
        for q0 in range(0, self.n_rows, super_tile):
            while True:
                bufs, packed = self._op_stripe(q0, tau_eff, super_tile, caps)
                rows_h, cols_h, total, groups, supers = (
                    bits.unpack_head(np.asarray(packed))
                )
                if (
                    total > caps[0] or groups > caps[1] or supers > caps[2]
                ):
                    caps = score_ops.grow_caps(
                        caps, (total, groups, supers)
                    )
                    continue
                break
            seen = tuple(
                max(a, b) for a, b in zip(seen, (total, groups, supers))
            )
            if total <= rows_h.size:
                pairs = (rows_h, cols_h)
            else:
                pairs = score_ops.decode_pairs(bufs, total)
            all_i.append(pairs[0])
            all_j.append(pairs[1])
        # tighten toward the observed per-stripe maxima with the same 8x
        # hysteresis as the dense Pallas path: one low-tau spike must not
        # permanently inflate every later stripe's scan domains
        self._stripe_caps = score_ops.tighten_caps(seen, caps)
        return self._rescore_pairs(
            np.concatenate(all_i), np.concatenate(all_j), tau
        )

    def _rescore_pairs(self, i, j, tau: float) -> PairResult:
        """Host fp64 rescore of device candidates — the step that makes the
        emitted pair set exact regardless of which device path found them."""
        i = np.asarray(i, np.int64)
        j = np.asarray(j, np.int64)
        self.stats["candidates_scored"] += int(i.size)
        shadow = self._shadow.view()
        # cached compact-dim translation -> grouped native rescore (~2.7x
        # the merge; bit-identical).  Keyed by shadow state so streaming
        # inserts invalidate it; joins after a build amortize the O(nnz)
        # translation across calls.
        compact = None
        if rescore_ops.grouped_available():
            key = (shadow.n_rows, int(shadow.indptr[-1]))
            cached = getattr(self, "_compact_rescore_cache", None)
            if cached is None or cached[0] != key:
                cached = (
                    key,
                    rescore_ops.build_compact(shadow.indices, shadow.n_cols),
                )
                self._compact_rescore_cache = cached
            compact = cached[1]
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data,
            i, j, shadow.n_cols, compact=compact,
        )
        keep = sims >= tau
        self.stats["pairs_emitted"] += int(keep.sum())
        return PairResult(i[keep], j[keep], sims[keep], list(self.ids))

    # ------------------------------------------------------------------- topk
    def topk(self, queries, k: int):
        """k-NN over the chunked index: queries are chunk-bucketed COO too,
        so neither side densifies its full width.  Same provably-exact fetch
        + fp64 re-rank contract as the dense engine (see Engine.topk).

        Query batches are width-split like the streaming match
        (``_match_width_limit``): the score accumulator is
        ``[q_rows_cap, row_cap]`` fp32, so an unbounded bulk k-NN call at
        the ~1M-row design point (2048 queries → 8.6 GB) would OOM the chip
        next to the entry buffers.  Sub-batches are independent and exact,
        so the merged result is unchanged."""
        queries = list(queries)
        limit = self._match_width_limit()
        if len(queries) > limit:
            out: Dict[str, list] = {}
            for s in range(0, len(queries), limit):
                out.update(self._topk_impl(queries[s : s + limit], k))
            return out
        return self._topk_impl(queries, k)

    def _topk_impl(self, queries, k: int):
        if self.n_rows == 0:
            return {qid: [] for qid, _ in queries}
        qcsr, qids = _as_csr(list(queries), None, self.cfg.vector_dim)
        sub = self._drop_unmapped(qcsr)
        ccsr = self._compact.map_csr(sub, extend=False)
        q_rows_cap = pow2_bucket(qcsr.n_rows, 32)
        q = self._bucket_queries(ccsr, q_rows_cap)
        k_eff = min(k, self.n_rows)
        nq = len(qids)

        def fetch(kf: int):
            s, r = self._op_topk(q, q_rows_cap, kf)
            return np.asarray(s)[:nq], np.asarray(r)[:nq]

        from .engine import fetch_exact_topk

        q_norms = qcsr.row_norms()
        qmax = float(q_norms.max()) if q_norms.size else 0.0
        # device-error bound for the exact-fetch proof: the rebuild path
        # scores fp32 slabs at "highest" precision (rescore_margin covers
        # it); the resident-slab fast path scores at the slab dtype — widen
        # to the engine's bf16 slack (same 2e-2 policy as _tau_eff) so the
        # fetch stays provably sufficient.  Deciding here also builds the
        # cache once, before the doubling fetch loop.
        mslab = self._match_slabs()
        fp32_path = mslab is None or str(mslab.dtype) == "float32"
        rel = self._margin_rel("highest" if fp32_path else "default")
        m = rel * max(self._max_norm * qmax, 1.0)
        rows, k_fetch = fetch_exact_topk(fetch, self.n_rows, k_eff, 2 * m)
        shadow = self._shadow.view()
        qi_idx = np.repeat(np.arange(nq), k_fetch)
        cand_idx = rows.reshape(-1).astype(np.int64)
        # rows reachable only through a dormant dim join explicitly (the
        # device score missed that contribution; same policy as Engine.topk)
        extra_q, extra_r = self._dormant_hits(qcsr)
        if extra_q.size:
            qi_idx = np.concatenate([qi_idx, extra_q])
            cand_idx = np.concatenate([cand_idx, extra_r])
        sims = rescore_ops.cross_pair_dots(
            shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
            qcsr.indptr, qcsr.indices, qcsr.data, qi_idx, cand_idx,
        )
        from .engine import assemble_topk

        return assemble_topk(qids, qi_idx, cand_idx, sims, k_eff, self.ids)
