"""The GPU entry points off the GPU: refusal without a card, the device
peaks table, the compile-cache and memory policies, and the smoke phases
at tiny sizes on the CPU backend."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_a_gpu(script):
    r = _run(os.path.join(REPO, script), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_peaks_table_is_keyed_by_device_kind():
    from apsim.bench import mfu

    h100 = mfu.peaks("NVIDIA H100 80GB HBM3")
    assert h100["int8"] == 1979e12 and h100["bf16"] == 989e12
    assert h100["tf32"] == 495e12 and h100["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        mfu.peaks("cpu")
    with pytest.raises(ValueError):
        mfu.mfu_pct(1e12, 1.0, "Unlisted Accelerator 1")
    assert mfu.mfu_pct(1979e12, 1.0, "NVIDIA H100 80GB HBM3") == 100.0


def test_compile_cache_dir(monkeypatch):
    from apsim.utils import jaxsetup

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert jaxsetup.cache_dir() == "/elsewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jaxsetup.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_memory_policy_cpu_fallback():
    """The CPU backend reports no allocator limit: the policy falls back to
    a 16 GiB device, where the shares give the engines' first budgets."""
    from apsim.utils import memory

    assert memory.bytes_limit() == memory.FALLBACK_BYTES == 16 << 30
    assert memory.budget(memory.ACCUMULATOR) == 6 << 30
    assert memory.budget(memory.MATCH_SLABS) == 7168 << 20
    assert memory.budget(memory.PANEL_SLAB) == 1536 << 20


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_smoke_dense_phases_tiny(smoke, capsys):
    smoke.phase_dense_full(n=300, nnz_mean=40, n_insert=40, n_dup=5,
                           n_topk=8, k=5)
    smoke.phase_dense_sampled(n=400, n_sample=60)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if '"smoke_phase"' in ln]
    assert len(lines) == 2 and all(smoke.LABEL in ln for ln in lines)


def test_smoke_chunked_and_served_phases_tiny(smoke):
    eng, every, ids = smoke.phase_chunked(n=700, n_sample=80, n_stream=96,
                                          bs=32, panel_rows=256)
    assert eng.join_route == "panels" and eng._panel_geom()[1] >= 3
    smoke.phase_served(eng, every, ids, n_insert=48, n_dup=6,
                       timeout_s=60.0)
    assert eng.n_rows == 700 + 96 + 48


def test_smoke_reference_finds_exact_partners(smoke):
    """The smoke's fp64 reference against a dense fp64 brute force."""
    import numpy as np

    from apsim.bench.scale import synthetic_corpus

    csr = synthetic_corpus(300, active_dims=2048, nnz_mean=30, seed=3)
    dense = csr.to_dense()
    s = dense @ dense.T
    sample = np.arange(0, 300, 7)
    want = {
        (int(min(i, j)), int(max(i, j)))
        for i, j in zip(*np.nonzero(s >= 0.5))
        if i != j and (i in set(sample) or j in set(sample))
    }
    got = smoke.Reference(csr).partners(sample, 0.5, block=64)
    assert got == want and len(want) > 0
