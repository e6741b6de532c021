"""Structured profiling hooks — the subsystem the reference lacks
(SURVEY.md §5: wall-clock only)."""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a device profile (XLA trace) viewable in TensorBoard /
    Perfetto.  Wrap the region of interest:

        with profile_trace("/tmp/spira-trace"):
            render(...)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-region inside a profile trace (host-side annotation)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> dict:
    """Per-device memory stats where the backend exposes them."""
    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats()
        except Exception:
            out[str(d)] = None
    return out
