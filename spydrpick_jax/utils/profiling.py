"""Profiling / tracing support.

The reference's observability is stopwatch prints (apegrunt
misc/Stopwatch.hpp; SURVEY §5 "tracing/profiling: poor-man's only").
This engine's equivalent: ``jax.profiler`` traces viewable in
TensorBoard/Perfetto, plus the per-stage host timers already emitted
by the pipeline's verbose mode.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Wrap a region in a jax.profiler trace when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside a trace (shows up in the timeline)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
