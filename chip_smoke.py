"""Smoke run of apsim's main path on the GPU, checked against fp64 references.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the mesh engines only

One card runs, in one process, after the GPU-marked tests (``pytest -m
gpu``, in a child process that exits before this process opens the card):

  1. dense ``Engine`` at Enron's 8,586 rows: build, ``all_pairs(0.8)`` with
     full-corpus fp64 parity, a 256-row streaming insert with exact
     duplicates, and ``topk(k=10)`` for 64 queries;
  2. dense ``Engine`` at 65,536 rows: ``all_pairs(0.8)`` with sampled-row
     fp64 parity;
  3. out-of-core ``ChunkedAllPairs`` at 500,000 rows: build and
     ``all_pairs(0.8)`` through the panel route (sampled parity), then 2,048
     streamed rows as bs=256 inserts with exact parity on every streamed row;
  4. ``SimilarityServer`` + ``RpcServer`` over the phase-3 index, driven by a
     ``ClientConnection`` on a thread: 512 inserts with duplicates,
     subscribed outputs, ``topk``, ``all_pairs`` and ``stats``.

Four cards compare ``MeshEngine`` (dims- and rows-sharded) and
``MeshChunkedAllPairs`` with the single-card engines on the phase-2 and
phase-3 corpora.

Every phase prints one JSON line with its wall time, its compile time
(set-up) and the device's ``peak_bytes_in_use`` — smoke timings, not
benchmark numbers.  Any failed check exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
before any phase runs.  Corpora are generated from seeds
(``apsim.bench.scale``), and every check compares with exact fp64
similarities computed outside the engines (``Reference``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TAU = 0.8
LABEL = "smoke timing, not a benchmark number"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ------------------------------------------------------------ references
class Reference:
    """fp64 similarities over a host CSR corpus, independent of the engines.

    ``partners`` finds every pair at or above ``tau`` that involves a given
    set of rows: a float32 ``"highest"``-precision device product over
    dense blocks keeps every pair within 1e-3 of ``tau`` (f32 error on
    unit-norm rows is below 1e-4), then each kept pair is decided by an
    exact fp64 sparse dot on the host."""

    PREFILTER = 1e-3

    def __init__(self, csr):
        import scipy.sparse as sp

        self.csr = csr
        self.a = sp.csr_matrix(
            (csr.data, csr.indices, csr.indptr), shape=(csr.n_rows, csr.n_cols)
        )
        active = np.unique(csr.indices)
        self.remap = np.full(csr.n_cols, -1, np.int64)
        self.remap[active] = np.arange(active.size)
        self.width = -(-max(active.size, 1) // 128) * 128

    def sims(self, rows_a, rows_b) -> np.ndarray:
        """Exact fp64 dot of row pairs ``(rows_a[p], rows_b[p])``."""
        prod = self.a[rows_a].multiply(self.a[rows_b])
        return np.asarray(prod.sum(axis=1)).ravel()

    def sims_row(self, row_vec) -> np.ndarray:
        """Exact fp64 sims of one scipy row vector against every row."""
        return np.asarray((self.a @ row_vec.T).todense()).ravel()

    def _dense(self, r0: int, r1: int):
        import jax.numpy as jnp

        s, e = int(self.csr.indptr[r0]), int(self.csr.indptr[r1])
        rows = np.repeat(
            np.arange(r1 - r0, dtype=np.int32),
            np.diff(self.csr.indptr[r0 : r1 + 1]),
        )
        cap = 1 << max(int(e - s - 1).bit_length(), 10)
        r = np.full(cap, r1 - r0, np.int32)
        c = np.zeros(cap, np.int32)
        v = np.zeros(cap, np.float32)
        r[: e - s] = rows
        c[: e - s] = self.remap[self.csr.indices[s:e]]
        v[: e - s] = self.csr.data[s:e]
        return _scatter_dense()(jnp.asarray(r), jnp.asarray(c),
                                jnp.asarray(v), r1 - r0, self.width)

    def partners(self, sample, tau: float, block: int = 8192) -> set:
        """All ``(i, j)``, ``i < j``, with fp64 sim ≥ ``tau`` and ``i`` or
        ``j`` in ``sample``."""
        import jax.numpy as jnp

        sample = np.asarray(sample, np.int64)
        q = self.a[sample]
        qd = np.zeros((sample.size, self.width), np.float32)
        qr = np.repeat(np.arange(sample.size), np.diff(q.indptr))
        qd[qr, self.remap[q.indices]] = q.data
        qd = jnp.asarray(qd)
        cand_r, cand_q = [], []
        for r0 in range(0, self.csr.n_rows, block):
            r1 = min(r0 + block, self.csr.n_rows)
            count, rr, qq = _block_candidates()(
                self._dense(r0, r1), qd, np.float32(tau - self.PREFILTER)
            )
            count = int(count)
            check(count <= rr.shape[0], f"reference block {r0}: {count} "
                  "candidates overflow the static capacity")
            cand_r.append(np.asarray(rr)[:count] + r0)
            cand_q.append(np.asarray(qq)[:count])
        rows = np.concatenate(cand_r)
        qs = sample[np.concatenate(cand_q)]
        keep = rows != qs
        rows, qs = rows[keep], qs[keep]
        exact = self.sims(rows, qs) >= tau
        return {
            (int(min(a, b)), int(max(a, b)))
            for a, b in zip(rows[exact], qs[exact])
        }


@functools.lru_cache(maxsize=None)
def _block_candidates(cap: int = 1 << 18):
    """Jitted ``(count, rows, queries)`` of the cells of ``x · qᵀ`` (float32,
    "highest" precision) at or above ``thr``, in a static-size buffer."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cands(x, q, thr):
        s = jnp.dot(x, q.T, precision=jax.lax.Precision.HIGHEST)
        hit = s >= thr
        rr, qq = jnp.nonzero(hit, size=cap, fill_value=0)
        return jnp.sum(hit, dtype=jnp.int32), rr, qq

    return cands


@functools.lru_cache(maxsize=None)
def _scatter_dense():
    """Jitted COO → dense float32 block (padding entries carry an
    out-of-range row and are dropped)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("rows", "width"))
    def scatter(r, c, v, rows: int, width: int):
        return jnp.zeros((rows, width), jnp.float32).at[r, c].set(
            v, mode="drop"
        )

    return scatter


def stack(*csrs):
    from apsim.vector.batch import CSRMatrix

    indptr = [np.zeros(1, np.int64)]
    base = 0
    for c in csrs:
        indptr.append(c.indptr[1:] + base)
        base += int(c.indptr[-1])
    return CSRMatrix(
        sum(c.n_rows for c in csrs), csrs[0].n_cols, np.concatenate(indptr),
        np.concatenate([c.indices for c in csrs]),
        np.concatenate([c.data for c in csrs]),
    )


def with_duplicates(fresh, source, n_dup: int, seed: int):
    """``fresh`` with its first ``n_dup`` rows replaced by exact copies of
    random ``source`` rows; returns (csr, {fresh_row: source_row})."""
    rng = np.random.default_rng(seed)
    src = rng.choice(source.n_rows, n_dup, replace=False)
    rows = [source.row(int(s)) for s in src] + [
        fresh.row(i) for i in range(n_dup, fresh.n_rows)
    ]
    from apsim.vector.batch import CSRMatrix

    return (CSRMatrix.from_vectors(rows, fresh.n_cols),
            {i: int(s) for i, s in enumerate(src)})


def pairs_touching(res_i, res_j, sample) -> set:
    mark = np.zeros(int(max(res_i.max(initial=0), res_j.max(initial=0),
                            max(sample)) + 1), bool)
    mark[np.asarray(sample)] = True
    keep = mark[res_i] | mark[res_j]
    return {(int(a), int(b)) for a, b in zip(res_i[keep], res_j[keep])}


def check_topk(ref: Reference, got: dict, queries, k: int,
               id_of_row) -> None:
    """Top-k equals the fp64 top-k, up to ties within 1e-9."""
    for qid, vec in queries:
        sims = ref.sims_row(_scipy_row(vec, ref.csr.n_cols))
        order = np.argsort(-sims, kind="stable")[:k]
        want = sims[order]
        res = got[qid]
        check(len(res) == len(want), f"topk {qid}: {len(res)} results")
        got_sims = np.array([s for _, s in res])
        check(np.allclose(got_sims, want, rtol=0, atol=1e-9),
              f"topk {qid}: sims {got_sims[:3]} vs {want[:3]}")
        rows = np.array([id_of_row[c] for c, _ in res])
        check(np.allclose(sims[rows], got_sims, rtol=0, atol=1e-9),
              f"topk {qid}: reported sims are not the rows' fp64 sims")
        above = {int(r) for r in np.nonzero(sims > want[-1] + 1e-9)[0]}
        check(above <= set(rows.tolist()), f"topk {qid}: missed a row")


def _scipy_row(vec, n_cols):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (vec.values, vec.indices, [0, vec.indices.size]), shape=(1, n_cols)
    )


def stream_reference(ref: Reference, first: int, ends) -> set:
    """Exact matches a stream of inserts must emit: row q (inserted in the
    batch ending at ``ends[q - first]``) pairs with every earlier-or-same-
    batch row at or above TAU, both directions inside a batch."""
    n_new = len(ends)
    want = set()
    for i, j in ref.partners(np.arange(first, first + n_new), TAU):
        for q, c in ((i, j), (j, i)):
            if q >= first and c < ends[q - first]:
                want.add((q, c))
    return want


# ---------------------------------------------------------------- timing
class Phase:
    """Wall time, compile time and peak device memory of one phase."""

    _compile_s = 0.0
    _compiles = 0
    _listening = False

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}
        self.steps: dict = {}

    def step(self, name: str) -> None:
        """Close one timed step of the phase (seconds since the last)."""
        now = time.perf_counter()
        self.steps[name] = now - self._last
        self._last = now

    @classmethod
    def _listen(cls):
        if cls._listening:
            return
        import jax

        def on_event(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                cls._compile_s += duration
                cls._compiles += 1

        jax.monitoring.register_event_duration_secs_listener(on_event)
        cls._listening = True

    def __enter__(self):
        self._listen()
        self.t0 = self._last = time.perf_counter()
        self.c0, self.n0 = Phase._compile_s, Phase._compiles
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        line = {
            "smoke_phase": self.name,
            "label": LABEL,
            "wall_s": time.perf_counter() - self.t0,
            "setup_compile_s": Phase._compile_s - self.c0,
            "compiles": Phase._compiles - self.n0,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "steps_s": self.steps,
            **self.info,
        }
        print(json.dumps(line), flush=True)
        return False


# ---------------------------------------------------------------- phases
def phase_dense_full(n: int = 8586, nnz_mean: int = 174, n_insert: int = 256,
                     n_dup: int = 32, n_topk: int = 64, k: int = 10):
    """Phase 1: dense engine, full fp64 parity, streaming insert, top-k."""
    from apsim import AllPairsConfig, Engine
    from apsim.bench.scale import synthetic_corpus
    from apsim.bench.suite import _oracle_pairs

    with Phase(f"dense_{n}") as ph:
        csr = synthetic_corpus(n, nnz_mean=nnz_mean, seed=0)
        eng = Engine(AllPairsConfig(similarity_threshold=TAU))
        eng.build(csr)
        ph.step("generate_build")
        res = eng.all_pairs(TAU)
        ph.step("all_pairs")
        want, _ = _oracle_pairs(csr, TAU)
        ph.step("fp64_oracle")
        got = {(int(a), int(b)) for a, b in zip(res.i, res.j)}
        check(got == want, f"all_pairs: {len(got)} pairs vs fp64 {len(want)}")
        ph.info.update(pairs=len(got), full_fp64_parity=True,
                       int8=eng._used_int8)

        fresh = synthetic_corpus(n_insert, nnz_mean=nnz_mean, seed=1)
        held, dup_of = with_duplicates(fresh, csr, n_dup, seed=2)
        ids = [f"h{i}" for i in range(n_insert)]
        out = eng.insert([(ids[i], held.row(i)) for i in range(n_insert)],
                         tau=TAU)
        ph.step("insert")
        every = stack(csr, held)
        ref = Reference(every)
        row_of = {str(i): i for i in range(n)}
        row_of.update({h: n + i for i, h in enumerate(ids)})
        emitted = {
            (row_of[q], row_of[c]) for q, m in out.output.items() for c in m
        }
        want = stream_reference(ref, n, [n + n_insert] * n_insert)
        check(emitted == want,
              f"insert: {len(emitted)} matches vs fp64 {len(want)}")
        for i, s in dup_of.items():
            sim = out.output.get(ids[i], {}).get(str(s))
            check(sim is not None and abs(sim - 1.0) < 1e-9,
                  f"duplicate h{i} of row {s}: {sim}")
        ph.info.update(insert_matches=len(emitted), duplicates=len(dup_of))
        ph.step("insert_reference")

        rng = np.random.default_rng(3)
        qrows = rng.choice(every.n_rows, n_topk, replace=False)
        queries = [(f"q{r}", every.row(int(r))) for r in qrows]
        got_k = eng.topk(queries, k)
        ph.step("topk")
        check_topk(ref, got_k, queries, k, row_of)
        ph.step("topk_reference")
        ph.info.update(topk_queries=n_topk, k=k)
    return eng


def phase_dense_sampled(n: int = 65536, n_sample: int = 2000):
    """Phase 2: dense engine at the top of the size curve, sampled parity."""
    from apsim import AllPairsConfig, Engine
    from apsim.bench.scale import synthetic_corpus

    with Phase(f"dense_{n}") as ph:
        csr = synthetic_corpus(n)
        eng = Engine(AllPairsConfig(similarity_threshold=TAU))
        eng.build(csr)
        ph.step("generate_build")
        res = eng.all_pairs(TAU)
        ph.step("all_pairs")
        sample = np.random.default_rng(4).choice(n, n_sample, replace=False)
        want = Reference(csr).partners(sample, TAU)
        ph.step("fp64_reference")
        got = pairs_touching(res.i, res.j, sample)
        check(got == want,
              f"sampled parity: {len(got)} pairs vs fp64 {len(want)}")
        ph.info.update(pairs=res.n_pairs, sampled_rows=n_sample,
                       sampled_pairs=len(want), int8=eng._used_int8,
                       index_bytes=eng.row_cap * eng.dim_cap * 4)
    return csr, res


def phase_chunked(n: int = 500_000, n_sample: int = 2000,
                  n_stream: int = 2048, bs: int = 256, panel_rows=None):
    """Phase 3: out-of-core engine, panel join + streamed inserts."""
    from apsim import AllPairsConfig
    from apsim.bench.scale import synthetic_corpus
    from apsim.engine import ChunkedAllPairs

    with Phase(f"chunked_{n}") as ph:
        csr = synthetic_corpus(n)
        ph.step("generate")
        eng = ChunkedAllPairs(AllPairsConfig(similarity_threshold=TAU),
                              panel_rows=panel_rows)
        eng.build(csr)
        ph.step("build")
        res = eng.all_pairs(TAU)
        ph.step("all_pairs")
        check(eng.join_route == "panels",
              f"join took the {eng.join_route} route, not the panel route")
        sample = np.random.default_rng(5).choice(n, n_sample, replace=False)
        want = Reference(csr).partners(sample, TAU)
        ph.step("fp64_reference")
        got = pairs_touching(res.i, res.j, sample)
        check(got == want,
              f"sampled parity: {len(got)} pairs vs fp64 {len(want)}")
        ph.info.update(route=eng.join_route, panel_geom=eng._panel_geom(),
                       pairs=res.n_pairs, sampled_pairs=len(want))

    with Phase(f"chunked_{n}_stream") as ph:
        fresh = synthetic_corpus(n_stream, seed=6)
        streamed, dup_of = with_duplicates(fresh, csr, n_stream // 8, seed=7)
        ids = [f"t{i}" for i in range(n_stream)]
        emitted = set()
        row_of = {str(i): i for i in range(n)}
        row_of.update({t: n + i for i, t in enumerate(ids)})
        for b0 in range(0, n_stream, bs):
            out = eng.insert(
                [(ids[i], streamed.row(i))
                 for i in range(b0, min(b0 + bs, n_stream))],
                tau=TAU,
            )
            emitted |= {
                (row_of[q], row_of[c]) for q, m in out.output.items()
                for c in m
            }
        ph.step("inserts")
        every = stack(csr, streamed)
        ends = [n + min(b0 + bs, n_stream)
                for b0 in range(0, n_stream, bs) for _ in range(bs)]
        want = stream_reference(Reference(every), n, ends[:n_stream])
        ph.step("fp64_reference")
        check(emitted == want,
              f"stream: {len(emitted)} matches vs fp64 {len(want)}")
        for i, s in dup_of.items():
            check((n + i, s) in emitted, f"streamed duplicate t{i} missed")
        ph.info.update(batches=-(-n_stream // bs), batch_size=bs,
                       matches=len(emitted))
    return eng, every, [str(i) for i in range(n)] + ids


def phase_served(eng, every, every_ids, n_insert: int = 512, n_dup: int = 64,
                 timeout_s: float = 300.0):
    """Phase 4: the TCP service over the phase-3 engine."""
    from apsim.bench.scale import synthetic_corpus
    from apsim.serve import RpcServer, SimilarityServer
    from apsim.serve.client import ClientConnection

    with Phase("served") as ph:
        n0 = eng.n_rows
        fresh = synthetic_corpus(n_insert, seed=8)
        sent, dup_of = with_duplicates(fresh, every, n_dup, seed=9)
        ids = [f"s{i}" for i in range(n_insert)]
        outputs: dict = {}
        got_all = threading.Event()
        lock = threading.Lock()
        result: dict = {}

        def on_output(output, _moment):
            with lock:
                for q, m in output.items():
                    outputs.setdefault(q, {}).update(m)
                if all(ids[i] in outputs for i in dup_of):
                    got_all.set()

        def client(address):
            try:
                cc = ClientConnection([address])
                cc.subscribe_outputs(on_output)
                for b0 in range(0, n_insert, 64):
                    cc.insert_new_vector(
                        [(ids[i], sent.row(i))
                         for i in range(b0, min(b0 + 64, n_insert))]
                    )
                cc.flush()
                result["outputs_complete"] = got_all.wait(timeout_s)
                q = every.row(int(dup_of[0]))
                result["topk"] = cc.topk([("q", q)], 10)
                result["all_pairs"] = cc.all_pairs(TAU)
                result["stats"] = cc.stats()
                cc.close()
            except Exception as e:  # reported by the main thread
                result["error"] = repr(e)

        sim = SimilarityServer(eng, eng.cfg).start()
        with RpcServer(sim, port=0) as rpc:
            th = threading.Thread(
                target=client, args=(f"{rpc.host}:{rpc.port}",)
            )
            th.start()
            th.join(2 * timeout_s)
        sim.close()
        check(not th.is_alive(), "client thread did not finish")
        check("error" not in result, f"client failed: {result.get('error')}")
        check(result["outputs_complete"], "subscribed outputs incomplete")
        for i, s in dup_of.items():
            sim_v = outputs[ids[i]].get(every_ids[s])
            check(sim_v is not None and abs(sim_v - 1.0) < 1e-9,
                  f"served duplicate {ids[i]} of row {s}: {sim_v}")
        total = stack(every, sent)
        row_of = {v: r for r, v in enumerate(every_ids + ids)}
        check_topk(Reference(total), result["topk"],
                   [("q", every.row(int(dup_of[0])))], 10, row_of)
        served_pairs = {(a, b) for a, b, _ in result["all_pairs"]}
        for i, s in dup_of.items():
            check((every_ids[s], ids[i]) in served_pairs
                  or (ids[i], every_ids[s]) in served_pairs,
                  f"all_pairs lacks the duplicate pair of {ids[i]}")
        check(result["stats"]["n_rows"] == n0 + n_insert,
              f"stats n_rows {result['stats']['n_rows']}")
        ph.info.update(inserts=n_insert, duplicates=n_dup,
                       all_pairs=len(served_pairs),
                       n_rows=result["stats"]["n_rows"])


def phase_four(n_dense: int = 65536, n_chunked: int = 500_000,
               n_sample: int = 2000, devices=None):
    """Four cards: mesh engines against the single-card engines."""
    import jax

    from apsim import AllPairsConfig, Engine
    from apsim.bench.scale import synthetic_corpus
    from apsim.engine import ChunkedAllPairs
    from apsim.parallel import MeshChunkedAllPairs, MeshEngine, make_mesh

    devices = devices or jax.devices()[:4]
    mesh = make_mesh(len(devices), devices=devices)
    cfg = AllPairsConfig(similarity_threshold=TAU)

    def spans_all(arr):
        held = {s.device for s in arr.addressable_shards}
        check(len(arr.sharding.device_set) == len(devices)
              and held == set(devices),
              f"array spans {len(held)} devices, not {len(devices)}")

    csr = synthetic_corpus(n_dense)
    sample = np.random.default_rng(4).choice(n_dense, n_sample, replace=False)
    want = Reference(csr).partners(sample, TAU)
    with Phase(f"single_dense_{n_dense}") as ph:
        eng = Engine(cfg)
        eng.build(csr)
        ph.step("build")
        single = eng.all_pairs(TAU).pair_set()
        ph.step("all_pairs")
        del eng
        ph.info.update(pairs=len(single))
    for axis in ("dims", "rows"):
        with Phase(f"mesh_{axis}_{n_dense}") as ph:
            eng = MeshEngine(cfg.replace(shard_axis=axis), mesh=mesh)
            eng.build(csr)
            spans_all(eng.x)
            ph.step("build")
            res = eng.all_pairs(TAU)
            ph.step("all_pairs")
            check(res.pair_set() == single,
                  f"mesh {axis}: pair set differs from the single card")
            check(pairs_touching(res.i, res.j, sample) == want,
                  f"mesh {axis}: sampled fp64 parity")
            ph.info.update(pairs=res.n_pairs, int8=eng._used_int8)
            del eng

    csr = synthetic_corpus(n_chunked)
    sample = np.random.default_rng(5).choice(n_chunked, n_sample,
                                             replace=False)
    want = Reference(csr).partners(sample, TAU)
    with Phase(f"single_chunked_{n_chunked}") as ph:
        eng = ChunkedAllPairs(cfg)
        eng.build(csr)
        ph.step("build")
        single = eng.all_pairs(TAU).pair_set()
        ph.step("all_pairs")
        ph.info.update(route=eng.join_route, pairs=len(single))
        del eng
    with Phase(f"mesh_chunked_{n_chunked}") as ph:
        eng = MeshChunkedAllPairs(cfg, mesh=mesh)
        eng.build(csr)
        for a in eng._ent:
            spans_all(a)
        ph.step("build")
        res = eng.all_pairs(TAU)
        ph.step("all_pairs")
        check(eng.join_route == "panels", f"mesh route {eng.join_route}")
        check(res.pair_set() == single,
              "mesh chunked: pair set differs from the single card")
        check(pairs_touching(res.i, res.j, sample) == want,
              "mesh chunked: sampled fp64 parity")
        ph.info.update(route=eng.join_route, pairs=res.n_pairs)


# ------------------------------------------------------------------ main
def gpu_tests() -> None:
    """The GPU-marked tests, in a child that exits before this process
    opens the card."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests", "-q", "-rs",
         "-p", "no:cacheprovider"],
        cwd=HERE, capture_output=True, text=True, timeout=900,
    )
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(r.stdout[-4000:] + r.stderr[-2000:])
    check(r.returncode == 0 and "passed" in tail and "skipped" not in tail,
          f"GPU-marked tests: rc={r.returncode} {tail!r}")
    print(json.dumps({"smoke_phase": "gpu_tests", "label": LABEL,
                      "result": tail}), flush=True)


def platform_of_first_device() -> str:
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300,
    )
    return r.stdout.strip().splitlines()[-1] if r.returncode == 0 else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh phases only")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "apsim")):
        log("chip_smoke.py must run from an apsim checkout")
        return 2
    platform = platform_of_first_device()
    if platform != "gpu":
        log(f"chip_smoke.py needs a GPU; JAX found {platform or 'nothing'}")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"nproc": os.cpu_count()}), flush=True)
    sys.path.insert(0, HERE)
    from apsim.utils.jaxsetup import cache_dir

    print(json.dumps({"compile_cache_dir": cache_dir()}), flush=True)
    if not args.four:
        gpu_tests()

    import jax

    from apsim import native

    print(json.dumps({"native_rescore_loaded": native.native_available()}),
          flush=True)
    n_dev = 4 if args.four else 1
    devices = jax.devices()
    check(len(devices) >= n_dev, f"need {n_dev} GPUs, found {len(devices)}")
    if args.four:
        phase_four(devices=devices[:4])
    else:
        phase_dense_full()
        phase_dense_sampled()
        phase_served(*phase_chunked())
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"SMOKE FAILED: {e}")
        sys.exit(1)
