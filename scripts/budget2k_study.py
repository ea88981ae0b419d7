"""Can the production point budget drop below 4096? (round-2 follow-up)

point_budget_study.py showed recovery/ADD flat down to ~2k points at full
resolution. ICP is gather-bound (cost ~ points x iters), so halving the
budget should cut ~75 ms off the 256-pose batch -- IF a sort-free lift
geometry exists at that budget and accuracy holds at render_scale=2.

Candidates (all sort-free unless noted):
  A  window 128 / stride 2 -> 4096 pts   (was production)
  B  window 128 / stride 3 -> 1849 pts   (same crop coverage, sparser)
  C  window  96 / stride 2 -> 2304 pts   (tighter crop, same density)
  D  window 128 / stride 2 -> top_k 2048 (sort cost vs gather saving)
Outcome: D won (lossless - see budget2k_sweep.py) and is now production.
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

configs = [
    ("A w128/s2 mp4096", dict(window=128, stride=2, max_points=4096)),
    ("B w128/s3 mp1849", dict(window=128, stride=3, max_points=1849)),
    ("C w96/s2  mp2304", dict(window=96, stride=2, max_points=2304)),
    ("D w128/s2 topk2048", dict(window=128, stride=2, max_points=2048)),
]

base_ok = None
for name, cfg in configs:
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                              chunk_iters=64, **cfg)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    print(f"{name}: wall {wall*1000:6.1f} ms ({N/wall:5.0f} poses/s) | "
          f"recovered {rec.mean()*100:3.0f}% | verdict agree vs A "
          f"{(rec == base_ok).mean()*100:3.0f}% | ADD(recovered) mean "
          f"{adds[rec].mean():.3f} max {adds[rec].max():.3f} mm", flush=True)
