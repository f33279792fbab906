"""Structured logging + profiling hooks.

The reference's observability is ActorLogging ``log.info`` plus bare
``println``s with no metrics registry (SURVEY.md §5).  The rebuild gives:
  - a namespaced stdlib logger (``apsim``) with one-line structured records,
  - ``profile_trace``: a ``jax.profiler`` trace context for device
    timeline capture,
  - ``Timer``: wall-clock section timing that feeds engine/server stats.
"""

from __future__ import annotations

import contextlib
import logging
import time

__all__ = ["get_logger", "profile_trace", "Timer"]

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def get_logger(name: str = "apsim") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a JAX profiler trace for everything inside the context
    (view with TensorBoard or xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating section timer: ``with timer.section("score"): ...``;
    ``timer.totals`` maps section -> seconds."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
