"""Follow-up to budget2k_study: valid-count distribution + finer top_k sweep.

budget2k_study found w128/s2 + top_k(2048) keeps 100%% verdict agreement with
identical ADD -- suggesting the on-object valid count already fits in 2048,
so top_k drops nothing and only shrinks the ICP gather buffer. Verify, and
find the knee.
"""
import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine import geometry
from pose_refine.ops.depth_to_cloud import window_cloud_batched
from pose_refine.ops.rasterize_pallas import rasterize_pallas
from pose_refine.utils.metrics import add_error, rotation_angle_deg
from jax import block_until_ready as sync

N = 256
model, tris, K, proj, truth, poses = setup(N)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))

# valid counts in the production lift geometry (render_scale=2)
K2 = K.copy(); K2[:2] /= 2
dep2 = rasterize_pallas(tris, poses_j, 320, 240, geometry.compute_proj(K2, 320, 240))
_, _, nv = window_cloud_batched(dep2, jnp.asarray(K2), window=128, stride=2)
nv = np.asarray(sync(nv))
print(f"valid counts over 256 hypothesis renders (w128/s2, render_scale=2): "
      f"min {nv.min()} mean {nv.mean():.0f} p95 {np.percentile(nv, 95):.0f} max {nv.max()}",
      flush=True)

base_ok = None
for mp in (4096, 2560, 2304, 2048, 1792, 1536):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                              chunk_iters=64, window=128, stride=2, max_points=mp)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    print(f"mp {mp:5d}: wall {wall*1000:6.1f} ms ({N/wall:5.0f} poses/s) | "
          f"recovered {rec.mean()*100:3.0f}% | verdict agree vs 4096 "
          f"{(rec == base_ok).mean()*100:3.0f}% | ADD(recovered) mean "
          f"{adds[rec].mean():.3f} max {adds[rec].max():.3f} mm", flush=True)
