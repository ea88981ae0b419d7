"""Wall-clock timing utilities (helper::Timer analog, helper.h:138-155).

Device work is asynchronous: every timing fences with
jax.block_until_ready, or it would measure the enqueue.
"""

from __future__ import annotations

import time

from jax import block_until_ready as sync


class Timer:
    def __init__(self):
        self.beg = time.perf_counter()

    def reset(self):
        self.beg = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.beg

    def out(self, message: str = "") -> float:
        t = self.elapsed()
        print(f"{message}\nelapsed time: {t:.6f}s\n")
        self.reset()
        return t


def time_jitted(fn, *args, warmup: int = 2, iters: int = 10, **kwargs):
    """Median wall-clock seconds of fn(*args), reliably fenced."""
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
