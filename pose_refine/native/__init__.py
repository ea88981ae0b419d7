"""Native (C++) host-runtime components, bound via ctypes.

The reference keeps its scene-construction hot path native (kd-tree build,
pcd_scene.cpp:45-184); ours lives in kdtree_builder.cpp, compiled on demand
with g++ into a cached shared library. Everything degrades gracefully to the
numpy implementations when no compiler is available.

The library is built with ``-march=native``, so it belongs to the host that
built it: it lives in ``<checkout>/build/native/<key>/``, keyed by the host's
CPU (model and feature flags), the compiler, the flags and the sources. A
checkout copied to another machine builds its own library instead of loading
one compiled for another CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def _lib():
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        srcs = [
            os.path.join(_HERE, "kdtree_builder.cpp"),
            os.path.join(_HERE, "cpu_baseline.cpp"),
        ]
        try:
            out_dir = os.path.join(_BUILD, _build_key(srcs))
            so = os.path.join(out_dir, "_prt_native.so")
            if not os.path.exists(so):
                os.makedirs(out_dir, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
                os.close(fd)
                try:
                    subprocess.run(["g++", *_FLAGS, "-o", tmp, *srcs],
                                   check=True, capture_output=True)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(so)
            lib.prt_build_kdtree.restype = ctypes.c_int
            lib.prt_build_kdtree.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        except Exception:
            _LIB_FAILED = True
            _LIB = None
    return _LIB


def _build_key(srcs) -> str:
    """Hash of everything the compiled library depends on: the host CPU
    (``-march=native``), the compiler version, the flags, the sources."""
    h = hashlib.sha256()
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    h.update(line.encode())
                    if line.startswith("flags"):
                        break
    except OSError:
        h.update(platform.processor().encode())
    h.update(subprocess.run(["g++", "--version"], capture_output=True,
                            check=True).stdout)
    h.update(" ".join(_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def native_available() -> bool:
    return _lib() is not None


def build_kdtree_native(points: np.ndarray, leaf_size: int = 10):
    """C++ kd-tree build; same outputs/semantics as the numpy builder.

    Returns (order, parent, child, split_dim, split_v, bbox, bounds, n_nodes)
    or None when the native library is unavailable.
    """
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    cap = max(2 * n, 16)
    parent = np.full(cap, -1, np.int32)
    child = np.full((cap, 2), -1, np.int32)
    split_dim = np.zeros(cap, np.int32)
    split_v = np.zeros(cap, np.float32)
    bbox = np.zeros((cap, 6), np.float32)
    bounds = np.zeros((cap, 2), np.int32)
    order = np.zeros(n, np.int64)

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n_nodes = lib.prt_build_kdtree(
        pts.ctypes.data_as(f32p), n, int(leaf_size),
        parent.ctypes.data_as(i32p), child.ctypes.data_as(i32p),
        split_dim.ctypes.data_as(i32p), split_v.ctypes.data_as(f32p),
        bbox.ctypes.data_as(f32p), bounds.ctypes.data_as(i32p),
        order.ctypes.data_as(i64p),
    )
    m = int(n_nodes)
    return (
        order,
        parent[:m].copy(), child[:m].copy(), split_dim[:m].copy(),
        split_v[:m].copy(), bbox[:m].copy(), bounds[:m].copy(), m,
    )


def cpu_render_baseline(tris, poses, proj, width: int, height: int):
    """Reference-algorithm CPU renderer (OpenMP over poses) - the measured
    baseline bench.py compares the device pipeline against. Returns
    (n_poses, height, width) int32 mm or None if native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, np.float32)
    poses = np.ascontiguousarray(poses, np.float32)
    proj = np.ascontiguousarray(proj, np.float32)
    n_poses = len(poses)
    out = np.zeros((n_poses, height, width), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.cpu_render(
        tris.ctypes.data_as(f32p), ctypes.c_int(len(tris)),
        poses.ctypes.data_as(f32p), ctypes.c_int(n_poses),
        proj.ctypes.data_as(f32p), ctypes.c_int(width), ctypes.c_int(height),
        out.ctypes.data_as(i32p),
    )
    return out


def cpu_icp_baseline(clouds, valid, scene_pcd, scene_nrm, K,
                     max_dist=0.1, max_iter=30, rel_fit=1e-5, rel_rmse=1e-5):
    """Reference-algorithm projective point-to-plane ICP on the CPU
    (OpenMP over poses). clouds (N, P, 3) float32 meters.
    Returns (T (N,4,4), fitness (N,), rmse (N,)) or None.

    NOTE: the native code refines a PRIVATE COPY of the clouds - np.asarray
    of a CPU jax.Array is zero-copy, so mutating the caller's buffer in
    place would silently corrupt jax arrays."""
    lib = _lib()
    if lib is None:
        return None
    clouds = np.array(clouds, np.float32, copy=True, order="C")
    valid = np.ascontiguousarray(valid, np.uint8)
    scene_pcd = np.ascontiguousarray(scene_pcd, np.float32)
    scene_nrm = np.ascontiguousarray(scene_nrm, np.float32)
    K = np.ascontiguousarray(K, np.float32)
    n_poses, n_pts = clouds.shape[:2]
    sh, sw = scene_pcd.shape[:2]
    T = np.zeros((n_poses, 4, 4), np.float32)
    fit = np.zeros(n_poses, np.float32)
    rmse = np.zeros(n_poses, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cpu_icp(
        clouds.ctypes.data_as(f32p), valid.ctypes.data_as(u8p),
        ctypes.c_int(n_poses), ctypes.c_int(n_pts),
        scene_pcd.ctypes.data_as(f32p), scene_nrm.ctypes.data_as(f32p),
        ctypes.c_int(sh), ctypes.c_int(sw),
        K.ctypes.data_as(f32p), ctypes.c_float(max_dist),
        ctypes.c_int(max_iter), ctypes.c_float(rel_fit), ctypes.c_float(rel_rmse),
        T.ctypes.data_as(f32p), fit.ctypes.data_as(f32p), rmse.ctypes.data_as(f32p),
    )
    return T, fit, rmse


def cpu_threads() -> int:
    lib = _lib()
    return int(lib.cpu_threads()) if lib is not None else 0
