"""The one place that decides what each JAX platform runs.

Every platform-dependent choice of the library is answered here and only
here, so a new platform is one table entry and an unknown one fails loudly
instead of falling through to a path nobody measured on it:

  * ``raster_kernel``   - the hand-written Triton rasterizer
                          (ops/rasterize_pallas.py) on the GPU; XLA's scatter
                          rasterizer (ops/rasterize.rasterize_scatter) on the
                          CPU, where Pallas only has an interpreter.
  * ``nn_backend``      - the exact nearest-neighbour search ``scene='nn'``
                          runs (scene/nn.py: ``_nn_kdtree`` or
                          ``_nn_bruteforce``).
  * ``icp_chunk_iters`` - ICP iterations per device program: one fused loop
                          on the GPU (no host round trip per chunk), chunks
                          of 8 on the CPU so converged batches exit early.
  * ``is_accelerator``  - whether device arrays live apart from the host
                          (a readback is then a transfer and a fence).

Interpret mode is never chosen here: only a test's explicit argument runs
a kernel in the Pallas interpreter.

The module also places JAX's persistent compilation cache
(:func:`enable_compile_cache`) and names the card (:func:`gpu_card`).
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import jax

# platform -> (raster kernel?, scene='nn' backend, fused ICP loop?)
_CHOICES = {
    "cpu": (False, "kdtree", False),
    # _nn_kdtree vs _nn_bruteforce on one H100 at batch 256 (chip_smoke.py
    # phase 5): the fused brute-force scan beats the vmapped traversal,
    # whose while_loop pays one host-checked iteration per tree step
    "gpu": (True, "bruteforce", True),
}

# ICP iterations per program where the loop is not fused
CPU_CHUNK_ITERS = 8

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def current(platform: Optional[str] = None) -> str:
    """The platform name the choices are made for (JAX's default backend
    unless given); raises for one this table does not know."""
    p = jax.default_backend() if platform is None else platform
    if p not in _CHOICES:
        raise RuntimeError(
            f"no platform choices for JAX platform {p!r}; known: "
            f"{sorted(_CHOICES)} (pose_refine/platform.py)"
        )
    return p


def raster_kernel(platform: Optional[str] = None) -> bool:
    """True where the pipeline renders with the hand-written kernel."""
    return _CHOICES[current(platform)][0]


def nn_backend(platform: Optional[str] = None) -> str:
    """'kdtree' or 'bruteforce': the exact NN search of ``scene='nn'``."""
    return _CHOICES[current(platform)][1]


def icp_chunk_iters(max_iteration: int, platform: Optional[str] = None) -> int:
    """ICP iterations per program for ``chunk_iters='auto'``.
    ``max_iteration + 1`` covers the reference's extra fitness-only
    iteration (icp.cpp:137), so the fused loop is one program."""
    if _CHOICES[current(platform)][2]:
        return int(max_iteration) + 1
    return CPU_CHUNK_ITERS


def is_accelerator(platform: Optional[str] = None) -> bool:
    """True where device arrays live apart from the host."""
    return current(platform) != "cpu"


def enable_compile_cache(subdir: str = ".jax_cache") -> str:
    """Place JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing else is set. Otherwise the cache lives in ``<checkout>/<subdir>``,
    derived from this file's location, so one checkout always finds its
    own cache again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (one
    entry per card) - printed beside every device time, since a card set
    below its maximum power runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(line.strip() for line in out.splitlines()) or "unknown"
