"""Shared bench workload + timing helper for the study scripts.

Every study must measure the EXACT workload bench.py measures (same mesh,
truth pose, rng seed and draw order), or its numbers stop being comparable
to the headline. This module is that workload, written once. bench.py
itself stays self-contained (it is the driver artifact), but its
construction and this one are kept in lockstep - change both or neither.
"""
import time

import numpy as np

W, H = 640, 480

# the reference demo viewpoint (test.cpp:29-38)
R_REN = np.array(
    [
        [0.34768538, 0.93761126, 0.0],
        [0.70540612, -0.26157897, -0.65877056],
        [-0.61767070, 0.22904489, -0.75234390],
    ],
    np.float32,
)


def setup(n_poses: int = 256, seed: int = 0):
    """(model, tris, K, proj, truth, poses) - the bench workload.

    poses are n_poses hypotheses perturbed ±10°/axis ±20 mm from truth with
    rng(seed), drawn rotations-then-translations like bench.py. To study a
    SUBSET comparable to bench's first k cases, call with n_poses=256 and
    slice - drawing fewer changes every pose.
    """
    import jax

    from pose_refine.platform import enable_compile_cache


    enable_compile_cache()
    import jax.numpy as jnp

    from pose_refine import geometry, mesh

    model = mesh.load_benchmark_model()
    tris = jnp.asarray(model.tris[mesh.morton_order(model.tris)])
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, W, H)
    truth = np.asarray(
        geometry.pose_from_Rt(R_REN, np.array([0, 0, 300], np.float32))
    )
    rng = np.random.default_rng(seed)
    d_rot = np.asarray(
        geometry.euler_to_rotation(
            rng.uniform(-0.17, 0.17, (n_poses, 3)).astype(np.float32)
        )
    )
    d_t = rng.uniform(-20, 20, (n_poses, 3)).astype(np.float32)
    poses = np.asarray(
        geometry.pose_from_Rt(
            np.einsum("nij,jk->nik", d_rot, truth[:3, :3]), truth[:3, 3] + d_t
        )
    )
    return model, tris, K, proj, truth, poses


def scene_render(tris, truth, proj):
    """The observed scene: a full-res render of the truth pose with the
    platform's rasterizer (the GPU kernel; XLA scatter on the CPU, so
    studies can smoke-test their code paths there)."""
    import jax
    import jax.numpy as jnp

    from pose_refine.ops.rasterize import render

    return np.asarray(
        jax.block_until_ready(render(tris, jnp.asarray(truth)[None], W, H, proj))
    )[0]


def time_median(fn, iters: int = 5):
    """Warm once, then median of `iters` sync-fenced wall-clock runs."""
    from jax import block_until_ready as sync

    out = sync(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = sync(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out
