"""render_scale=3 accuracy/throughput study (builder backlog r2 #3).

The production config renders hypotheses at 1/2 resolution (320x240); this
asks whether 1/3 (213x160, floor-divided - the divisibility constraint was
relaxed for this study) buys throughput without losing accuracy. The honest
quantization floor at rs=2 is ~0.6 mm ADD; rs=3 coarsens the
hypothesis clouds ~1.5x further, so the prior is rejection - the adoption
bar is STRICT DOMINANCE like the 4 mm decimation call: every verdict flip
vs rs=2 must be a recovery AND ADD must not degrade.

Gates: recovery, per-case verdict agreement vs the rs=2 production run,
ADD-to-truth of recovered poses, throughput.

Run: python scripts/render_scale3_study.py   (GPU)
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
from pose_refine.utils.metrics import add_error, rotation_angle_deg

N = 256
model, tris, K, proj, truth, poses = setup(N)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))

base_ok = None
# (render_scale, window, max_points): window/max_points sized to the same
# object coverage at each scale (128 px at rs=2 -> ~85 px at rs=3, rounded
# to 96 for tile alignment; candidate count (96/2)^2 = 2304 -> budget 2048
# still lossless only if the strided valid count stays under it - the
# saturation warning flags otherwise)
for rs, window, mp in ((2, 128, 2048), (3, 96, 2048), (3, 96, 1536)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=rs, window=window, stride=2,
                              max_points=mp, decimate_mm=4.0)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    n_pts = np.asarray(res.n_points)
    flips = np.nonzero(rec != base_ok)[0]
    flip_txt = "" if not len(flips) else (
        " | flips: " + ", ".join(
            f"{i}({'RECOVERS' if rec[i] else 'FAILS'})" for i in flips)
    )
    print(f"rs={rs} win={window} mp={mp} ({refiner.render_w}x{refiner.render_h}): "
          f"wall {wall*1000:6.1f} ms ({N/wall:5.0f} poses/s) | "
          f"recovered {rec.mean()*100:3.0f}% | verdict agree vs rs2 "
          f"{(rec == base_ok).mean()*100:4.1f}% | ADD(rec) mean "
          f"{adds[rec].mean():.3f} max {adds[rec].max():.3f} mm | "
          f"n_pts max {n_pts.max():.0f}/{mp}{flip_txt}", flush=True)
