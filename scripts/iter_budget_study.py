"""ICP iteration budget study: does the fused loop need all 31 iterations?

The fused program runs max_iteration+1 passes regardless of convergence
(the done-latch freezes state but not work), so iterations are pure wall
time: ~1.75 ms per iteration at the production config (49% of device
time). The reference default is 30 (icp.h:42-45); most hypotheses converge
earlier. Sweep max_iteration with the usual gates: per-case verdict
agreement vs the 30-iter run, ADD(recovered), recovery.

Run: python scripts/iter_budget_study.py   (GPU)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine.icp import ICPConvergenceCriteria
from pose_refine.utils.metrics import add_error, rotation_angle_deg

N = 256
model, tris, K, proj, truth, poses = setup(N)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))

refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                          window=128, stride=2, max_points=2048, decimate_mm=4.0)
refiner.set_scene_depth(scene_depth)

base_ok = None
base_T = None
for mi in (30, 24, 20, 16, 12):
    crit = ICPConvergenceCriteria(max_iteration=mi)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j, criteria=crit))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    adds = add_error(refined, truth, model.vertices)
    if base_ok is None:
        base_ok, base_T = rec, refined
    # ADD distance of each pose to ITS 30-iter twin (residual refinement)
    d30 = np.array([
        add_error(refined[i][None], base_T[i], model.vertices)[0] for i in range(N)
    ])
    flips = np.nonzero(rec != base_ok)[0]
    flip_txt = "" if not len(flips) else (
        " | flips: " + ", ".join(
            f"{i}({'RECOVERS' if rec[i] else 'FAILS'})" for i in flips))
    print(f"max_iter {mi:2d}: wall {wall*1e3:6.1f} ms ({N/wall:5.0f}/s) | "
          f"recovered {rec.mean()*100:3.0f}% | verdict agree {(rec==base_ok).mean()*100:5.1f}% | "
          f"ADD(rec) mean {adds[rec].mean():.3f} max {adds[rec].max():.3f} mm | "
          f"vs-30-iter ADD(rec) max {d30[rec].max():.3f} mm{flip_txt}", flush=True)
