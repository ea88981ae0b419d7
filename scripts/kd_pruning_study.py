"""Measure the kd traversal step-count win from far-child bbox pruning.

The reference's stackless traversal gates the far-child descent on the
CURRENT node's bbox (pcd_scene.h:104-118) - a box that also spans the
already-visited child, so its min-possible distance is never larger than the
far child's own. Gating on the far child's bbox (prune="far", the default in
scene/nn.py) prunes strictly more while staying exact; this script measures
by how much on a realistic scene.

Run on CPU (the traversal is the production NN path there):
  PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/kd_pruning_study.py
"""

import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from pose_refine import geometry, mesh  # noqa: E402
from pose_refine.ops import rasterize as rz  # noqa: E402
from pose_refine.scene.nn import SceneNN, _nn_kdtree  # noqa: E402


def main():
    W, H = 640, 480
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, W, H)
    m = mesh.load_benchmark_model()
    tris = jnp.asarray(m.tris[mesh.morton_order(m.tris)])

    R_ren = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = np.asarray(geometry.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    depth = np.asarray(rz.rasterize_scatter(tris, jnp.asarray(truth)[None],
                                            W, H, proj, window=64))[0]
    scene = SceneNN.from_depth(depth, K)
    print(f"scene: {scene.points.shape[0]} points, {scene.parent.shape[0]} nodes")

    # queries: the scene points jittered by a few mm (ICP-like: queries sit
    # near the surface), plus a uniform far set (gate-miss behavior)
    rng = np.random.default_rng(0)
    near = np.asarray(scene.points) + rng.normal(0, 0.004, scene.points.shape).astype(np.float32)
    far = rng.uniform(-0.3, 0.3, (4096, 3)).astype(np.float32) + np.asarray(scene.points).mean(0)

    for tag, q in (("near-surface", near[:16384]), ("uniform", far)):
        q = jnp.asarray(q)
        out = {}
        for prune in ("node", "far"):
            run = jax.jit(lambda s: _nn_kdtree(s, scene, prune=prune, return_steps=True))
            idx, dist, steps = run(q)
            jax.block_until_ready(steps)
            t0 = time.perf_counter()
            idx, dist, steps = run(q)
            jax.block_until_ready(steps)
            dt = time.perf_counter() - t0
            out[prune] = (np.asarray(idx), np.asarray(dist), np.asarray(steps), dt)
        i_n, d_n, s_n, t_n = out["node"]
        i_f, d_f, s_f, t_f = out["far"]
        assert np.array_equal(d_n, d_f), "pruning changed NN distances!"
        print(
            f"{tag:13s}: steps node {s_n.mean():7.1f} -> far {s_f.mean():7.1f} "
            f"({(1 - s_f.mean() / s_n.mean()) * 100:4.1f}% fewer), "
            f"max {s_n.max()} -> {s_f.max()}, "
            f"wall {t_n * 1e3:.0f} -> {t_f * 1e3:.0f} ms"
        )


if __name__ == "__main__":
    main()
