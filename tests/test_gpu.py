"""Tests that need the GPU: the int8 panel scorer as compiled for the card
against the plain reference on the CPU backend, and the GPU joins against
the fp64 oracle.  Marked ``gpu``; they skip elsewhere and run on the card
through ``python chip_smoke.py`` (or ``pytest -m gpu``)."""

import numpy as np
import pytest

from apsim.bench.scale import synthetic_corpus

pytestmark = pytest.mark.gpu

TAU = 0.8


def _dense_rows(n, seed):
    """``n`` rows of the phase-2 corpus shape at its full 32,768-dim width."""
    csr = synthetic_corpus(n, seed=seed)
    x = np.zeros((n, 32768), np.float32)
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    x[rows, csr.indices] = csr.data
    return x


def _epilogue_f64(d, auxi, auxj):
    """The bound epilogue's admit value, in float64, from the exact int32
    scores (where the two compilations may round differently)."""
    a = np.asarray(auxi, np.float64)
    b = np.asarray(auxj, np.float64)
    s_hat = d * (a[0][:, None] * b[0][None, :])
    bound = 0.5 * (b[0][None, :] * a[1][:, None] + a[0][:, None] * b[1][None, :])
    bound += 0.25 * (a[0][:, None] * b[0][None, :]) * np.minimum(
        a[2][:, None], b[2][None, :]
    )
    return s_hat + bound


@pytest.mark.parametrize("col0", [0, 1024], ids=["diagonal", "off_diagonal"])
def test_int8_scorer_matches_cpu_reference(gpu, col0):
    """The int8 dot is exact, so hit counts and bit-packed masks must be
    EQUAL between the card and the CPU reference.  The only allowed
    difference is a cell whose f32 epilogue value sits within 1 ulp of
    tau_eff (FMA contraction may differ); the fp64 rescore absorbs it."""
    import jax
    import jax.numpy as jnp

    from apsim.ops import panel

    cpu = jax.devices("cpu")[0]
    x = _dense_rows(2048, seed=11)
    q, aux = panel.quantize_rows(jax.device_put(x, gpu))
    tau = np.float32(TAU - 0.02)
    m = 1024
    xi, xj = q[:m], q[col0 : col0 + m]
    ai, aj = aux[:, :m], aux[:, col0 : col0 + m]
    got = jax.jit(
        lambda a, b, c, d: panel.pair_bits(panel.int8_dot(a, b), c, d, 0,
                                           col0, tau)
    )(xi, xj, ai, aj)
    assert all(g.devices() == {gpu} for g in got)
    on_cpu = [jax.device_put(a, cpu) for a in (xi, xj, ai, aj)]
    want = panel.panel_score_bits_int8_ref(
        *on_cpu, jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
        jnp.asarray([0, col0], jnp.int32), tau, m, m,
    )
    gb, gb_ref = np.asarray(got[0][0]), np.asarray(want[0][0])
    diff = np.nonzero(np.unpackbits(
        (gb ^ gb_ref)[:, None, :], axis=1, bitorder="little"
    ).reshape(m, m))
    if diff[0].size:
        d = np.asarray(jax.device_put(panel.int8_dot(*on_cpu[:2]), cpu))
        v = _epilogue_f64(d, on_cpu[2], on_cpu[3])[diff]
        assert np.all(np.abs(v - tau) <= np.spacing(tau)), v
    else:
        np.testing.assert_array_equal(np.asarray(got[2]),
                                      np.asarray(want[2]))
    assert int(np.asarray(want[2])[0, 0]) > 0  # the block has hits


def test_gpu_joins_match_fp64_oracle(gpu):
    """Dense int8, dense float (TF32 at "default" precision, covered by the
    2e-2 margin) and out-of-core panel joins on the card: exact pair sets."""
    from apsim import AllPairsConfig, Engine
    from apsim.bench.suite import _oracle_pairs
    from apsim.engine import ChunkedAllPairs

    csr = synthetic_corpus(4096, seed=12)
    want, _ = _oracle_pairs(csr, TAU)
    assert len(want) > 0
    for int8 in (True, False):
        eng = Engine(AllPairsConfig(pallas_int8=int8))
        eng.build(csr)
        res = eng.all_pairs(TAU)
        assert eng._used_int8 == int8
        assert {(int(a), int(b)) for a, b in zip(res.i, res.j)} == want
        assert eng.x.devices() == {gpu}
    eng = ChunkedAllPairs(AllPairsConfig(), panel_rows=1024)
    eng.build(csr)
    res = eng.all_pairs(TAU)
    assert eng.join_route == "panels"
    assert {(int(a), int(b)) for a, b in zip(res.i, res.j)} == want

