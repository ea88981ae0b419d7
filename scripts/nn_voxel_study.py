"""NN-scene voxel downsampling: accuracy vs throughput on the bench workload.

Exact NN is O(queries x scene points), so shrinking the scene cloud is
the honest lever for the NN pipeline. Voxel downsampling (centroid +
renormalized mean normal) is the standard practice the reference leaves to
its users. Gates: recovery, ADD-to-truth of recovered poses, and agreement
with the voxel=0 NN run.
"""
import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine.utils.metrics import add_error, rotation_angle_deg

N = 256
model, tris, K, proj, truth, poses = setup(N)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))

base_ok = None
for vox in (0.0, 2.0, 3.0, 4.0, 6.0):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                              chunk_iters=64, window=128, stride=2,
                              max_points=2048, decimate_mm=2.0,
                              scene="nn_bruteforce", scene_voxel_mm=vox)
    refiner.set_scene_depth(scene_depth)
    n_scene = refiner.scene.points.shape[0]
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j), iters=3)
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    print(f"voxel {vox:3.1f} mm ({n_scene:6d} scene pts): wall {wall*1000:7.1f} ms "
          f"({N/wall:5.0f} poses/s) | recovered {rec.mean()*100:3.0f}% | agree vs vox0 "
          f"{(rec == base_ok).mean()*100:3.0f}% | ADD(recovered) mean "
          f"{adds[rec].mean():.3f} max {adds[rec].max():.3f} mm", flush=True)
