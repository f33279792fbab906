"""Device-memory policy: every HBM budget the engines use, in one place.

Each budget is a share of the device allocator's ``bytes_limit``
(``device.memory_stats()``), so one policy sizes the engines for whatever
card they land on.  Backends that report no limit (the CPU backend the
tests run on) fall back to a 16 GiB device, where the shares reproduce the
fixed budgets the engines were first sized with.
"""

from __future__ import annotations

import functools

__all__ = ["bytes_limit", "budget"]

FALLBACK_BYTES = 16 << 30

# shares of bytes_limit
ACCUMULATOR = 0.375     # fp32 score accumulators: stripe / match width
MATCH_SLABS = 0.4375    # resident chunk match slabs (streaming fast path)
PANEL_RESIDENT = 0.375  # all panel slabs resident for one join sweep
PANEL_SWEEP = 0.625     # in-flight panel slabs of a rolling sweep
PANEL_SLAB = 0.09375    # one panel slab
HIT_BITS = 0.125        # the dense join's bit-packed hit structure


@functools.lru_cache(maxsize=None)
def bytes_limit() -> int:
    """Allocator limit of this process's first device, in bytes."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 0)) or FALLBACK_BYTES


def budget(share: float) -> int:
    """``share`` of the device's allocator limit, in bytes."""
    return int(bytes_limit() * share)
