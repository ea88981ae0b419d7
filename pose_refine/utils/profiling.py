"""Profiling hooks: jax.profiler traces (the reference ships nv_prof.sh for
nvprof/nvvp; this is the JAX equivalent - view traces in TensorBoard or
Perfetto)."""

from __future__ import annotations

import contextlib
import os
import time

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/pose_refine_trace", annotate: str = ""):
    """Capture a device trace around a block:

        with trace("/tmp/tr"):
            refiner.refine(poses)

    Open with `tensorboard --logdir /tmp/tr` (profile plugin) or upload the
    .trace.json.gz to ui.perfetto.dev.
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        if annotate:
            with jax.profiler.TraceAnnotation(annotate):
                yield logdir
        else:
            yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active trace."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_stats(device=None) -> dict | None:
    """Allocator statistics for one device (the reference prints free/total
    HBM via cudaMemGetInfo in print_cuda_memory_usage, renderer.cu:52-69).

    Returns the backend's stats dict (keys like ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``) or None when the backend does
    not report them (e.g. the CPU platform and some plugin backends).
    """
    dev = device if device is not None else jax.devices()[0]
    getter = getattr(dev, "memory_stats", None)
    if getter is None:
        return None
    try:
        return getter()
    except Exception:
        return None


def log_memory_usage(prefix: str = "device memory", device=None) -> str:
    """One-line human-readable memory summary (or an honest 'unavailable')."""
    stats = device_memory_stats(device)
    parts = []
    if stats:
        for key, label in (("bytes_in_use", "in_use"),
                           ("peak_bytes_in_use", "peak"),
                           ("bytes_limit", "limit")):
            val = stats.get(key)
            if val is not None:
                parts.append(f"{label} {val / 2**20:.1f} MiB")
    if parts:
        msg = f"{prefix}: " + ", ".join(parts)
    else:
        msg = f"{prefix}: allocator stats unavailable on this backend"
    print(msg)
    return msg


class StepTimer:
    """Rolling wall-clock stats for production loops (observability beyond
    the reference's std::cout timers, helper.h:138-155)."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.worst = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        self.total += dt
        self.worst = max(self.worst, dt)
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
