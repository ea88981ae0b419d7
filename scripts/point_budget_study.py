"""Accuracy + speed vs ICP point budget (max_points).

The association gather is row-count-bound (~200M rows/s, profile_gather),
so ICP cost scales with points x iterations. The reference compacts ALL
valid pixels (~26k @640x480); we subsample. Question: how few points keep
(a) recovery rate, (b) ADD-to-truth, (c) ADD parity vs the reference
baseline AT THE SAME budget, on the failure-parity workload?
"""
import time
import jax
from pose_refine.platform import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp, numpy as np
import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.ops.rasterize_pallas import rasterize_pallas
from pose_refine.utils.metrics import add_error, rotation_angle_deg
from jax import block_until_ready as sync

W, H, N = 640, 480, 64
model = mesh.load_benchmark_model()
tris = jnp.asarray(model.tris[mesh.morton_order(model.tris)])
K = geometry.LINEMOD_K
proj = geometry.compute_proj(K, W, H)
R1 = np.array([[0.34768538, 0.93761126, 0.0],
               [0.70540612, -0.26157897, -0.65877056],
               [-0.61767070, 0.22904489, -0.75234390]], np.float32)
truth = np.asarray(geometry.pose_from_Rt(R1, np.array([0, 0, 300], np.float32)))
rng = np.random.default_rng(0)
d_rot = np.asarray(geometry.euler_to_rotation(rng.uniform(-0.17, 0.17, (N, 3)).astype(np.float32)))
poses = np.asarray(geometry.pose_from_Rt(
    jnp.einsum("nij,jk->nik", d_rot, truth[:3, :3]),
    truth[:3, 3] + rng.uniform(-20, 20, (N, 3)).astype(np.float32)))
scene_depth = np.asarray(sync(rasterize_pallas(tris, jnp.asarray(truth)[None], W, H, proj)))[0]

poses_j = jax.device_put(jnp.asarray(poses))

for mp in (16384, 8192, 4096, 2048, 1024):
    refiner = prt.PoseRefiner(model, K=K, width=W, height=H, max_points=mp,
                              chunk_iters=64)
    refiner.set_scene_depth(scene_depth)
    refined, res = refiner.refine(poses_j)   # compile
    sync((refined,))
    t0 = time.perf_counter()
    refined, res = refiner.refine(poses_j)
    sync((refined,))
    wall = time.perf_counter() - t0
    refined = np.asarray(refined)
    adds = add_error(refined, truth, model.vertices)
    rot = rotation_angle_deg(refined, truth)
    rec = (rot < 3.0)
    print(f"max_points {mp:6d}: wall {wall*1000:6.1f} ms (N=64) | recovered {rec.mean()*100:3.0f}% | "
          f"ADD-to-truth (recovered only) mean {adds[rec].mean():.4f} max {adds[rec].max():.4f} mm | "
          f"fitness {float(np.asarray(res.fitness).mean()):.3f}", flush=True)
