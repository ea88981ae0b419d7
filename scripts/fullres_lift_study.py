"""Full-res (render_scale=1) lift geometry: stride/top_k trade-off study.

The w256/s2 window emits 16384 top_k candidates; stride 3 emits 7396 at
the same crop coverage. Arms: s2/mp4096, s3/mp4096 and s3/mp2048 on the
bench workload, gated on verdict agreement and ADD.
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
for name, cfg in (("fullres w256/s2 mp4096", dict(window=256, stride=2, max_points=4096)),
                  ("fullres w256/s3 mp4096", dict(window=256, stride=3, max_points=4096)),
                  ("fullres w256/s3 mp2048", dict(window=256, stride=3, max_points=2048))):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480, chunk_iters=64, **cfg)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    print(f"{name}: wall {wall*1000:6.1f} ms ({N/wall:5.0f}/s) | rec {rec.mean()*100:3.0f}% | "
          f"agree {(rec == base_ok).mean()*100:3.0f}% | ADD(rec) mean {adds[rec].mean():.3f} "
          f"max {adds[rec].max():.3f} mm", flush=True)
