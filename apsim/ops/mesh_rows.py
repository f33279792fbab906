"""Rows-sharded mesh join: the int8 panel-pair scorer under ``shard_map``.

With ``shard_axis="rows"`` each device owns a contiguous row block of the
index.  Per-row int8 quantization is row-local, so every device quantizes
its own block and one int8 ``all_gather`` (half the bytes of bf16) gives
each device the whole quantized index.  The upper-triangle PANEL PAIRS are
striped round-robin across devices (device d takes pairs d, d+n, d+2n, …),
and every device scores its pairs from the gathered copy — per-device work
is balanced to ±1 pair and no psum is needed (rows sharding contracts
nothing across devices).  Schedules are padded to a common length with
``valid = 0`` pairs, which score nothing.

Exactness: identical contract to the single-device join — int8 scores plus
the per-pair quantization bound form a proven candidate superset at
``tau_eff``; the host fp64 rescore decides the final set.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .bits import _compact_bits
from .panel import panel_pairs_bits, quantize_rows, upper_panel_pairs

__all__ = ["rows_schedule", "mesh_rows_extract_int8"]


def rows_schedule(row_cap: int, n_dev: int, rb: int):
    """Per-device panel-pair schedules ``(pi, pj, valid) [n_dev, max]``:
    the upper-triangle panel pairs of height ``rb`` striped round-robin
    across devices, padded with ``valid = 0``."""
    pi, pj = upper_panel_pairs(row_cap // rb)
    mx = -(-pi.size // n_dev)
    pi_a = np.zeros((n_dev, mx), np.int32)
    pj_a = np.zeros((n_dev, mx), np.int32)
    va_a = np.zeros((n_dev, mx), np.int32)
    for d in range(n_dev):
        sl_i, sl_j = pi[d::n_dev], pj[d::n_dev]
        pi_a[d, : sl_i.size] = sl_i
        pj_a[d, : sl_j.size] = sl_j
        va_a[d, : sl_i.size] = 1
    return pi_a, pj_a, va_a


@functools.lru_cache(maxsize=None)
def mesh_rows_extract_int8(
    mesh: Mesh, axis: str, rb: int, cap: int, capb: int, cap0: int,
    pack: bool,
):
    """Compiled fn: (x, pi, pj, valid, tau_eff) -> (rows, cols, heads), all
    stacked ``[n_dev, ...]`` — the full upper-triangle join, each device
    over its own panel-pair schedule."""
    def local(x_local, pi_d, pj_d, valid_d, tau_eff):
        # per-row int8 quantization is row-local under rows sharding — ONE
        # definition (panel.quantize_rows), incl. the padded-row rule
        q, aux = quantize_rows(x_local)  # aux [3, b_rows]
        qg = jax.lax.all_gather(q, axis, axis=0, tiled=True)  # [row_cap, D]
        auxg = jax.lax.all_gather(aux, axis, axis=1, tiled=True)
        pi, pj = pi_d.reshape(-1), pj_d.reshape(-1)
        gb, g64, cnt = panel_pairs_bits(
            qg, auxg, pi, pj, valid_d.reshape(-1), tau_eff, rb
        )
        (row, col), head = _compact_bits(
            gb, g64, cnt, pi, pj, cap, capb, cap0, rb, rb, pack
        )
        return row[None], col[None], head[None]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        check_vma=False,  # per-device schedules ARE device-varying
    )
    return jax.jit(fn)
