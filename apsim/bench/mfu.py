"""Utilization accounting for the int8 join: op counts and device peaks.

Every throughput artifact carries ``int8_ops``, ``seconds`` and ``mfu_pct``
so efficiency is auditable, not inferred.

Convention: the join semantically decides every padded pair once.  The
upper-triangle join does padded_rows^2/2 pair-dot products of length
``dim_cap`` at 2 ops (multiply+add) per int8 MAC, so

    int8_ops = padded_rows^2 * dim_cap          (the 1/2 and the 2 cancel)

``mfu_pct`` is that work over wall time over the device's published peak —
wall time includes extraction, D2H and the fp64 rescore, so this is
END-TO-END utilization, not an isolated-kernel roofline share.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks", "int8_join_ops", "mfu_pct"]

# Published dense peaks (no sparsity), keyed by ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM form factor, at the
# full 700 W power limit: int8 1,979 TOP/s, bf16 989 TFLOP/s, TF32 495
# TFLOP/s, HBM3 3.35 TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8": 1979e12,
        "bf16": 989e12,
        "tf32": 495e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table of one device kind; an unknown device is an error,
    not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet figures to apsim.bench.mfu.PEAKS"
        ) from None


def int8_join_ops(padded_rows: int, dim_cap: int) -> float:
    """int8 op count of one upper-triangle all-pairs join at padded size."""
    return float(padded_rows) * float(padded_rows) * float(dim_cap)


def mfu_pct(ops: float, seconds: float, device_kind: str,
            precision: str = "int8") -> float:
    """End-to-end utilization of the device's ``precision`` peak, in %."""
    peak = peaks(device_kind)[precision]
    if seconds <= 0:
        return 0.0
    return 100.0 * ops / seconds / peak
