"""Robustness to sensor-like depth corruption (the bench scene is a clean
render; real LINEMOD frames carry noise, holes and quantization).

Corruptions applied to the OBSERVED scene depth only (hypothesis renders
are synthetic by definition):
  - additive Gaussian depth noise, sigma in mm (Kinect-class: 1-3 mm at
    this range, rising with distance)
  - random dropout holes (speckle/edge returns lost), fraction of pixels
  - the int mm quantization is already inherent

Gates: recovery and ADD-to-truth of the production config vs the clean
scene. The association gate (0.1 m) and the bilateral normal estimation
(50 mm diff threshold, common.cpp:32-34) are the designed noise defenses;
robust_delta adds Huber-IRLS weighting (beyond parity) and is measured
alongside at each corruption level.
"""
import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine.utils.metrics import add_error, rotation_angle_deg

N = 256
model, tris, K, proj, truth, poses = setup(N)
clean = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))
rng = np.random.default_rng(42)

cases = [
    ("clean", 0.0, 0.0),
    ("sigma 1 mm", 1.0, 0.0),
    ("sigma 3 mm", 3.0, 0.0),
    ("sigma 3 mm + 10% holes", 3.0, 0.10),
    ("sigma 5 mm + 20% holes", 5.0, 0.20),
]
base_ok = None
for name, sigma, holes in cases:
    d = clean.astype(np.float32)
    valid = d > 0
    if sigma > 0:
        d = d + rng.normal(0, sigma, d.shape).astype(np.float32) * valid
    if holes > 0:
        d = d * (rng.uniform(size=d.shape) >= holes * valid)
    d = np.maximum(np.round(d), 0).astype(np.int32) * valid

    for delta, tag in ((0.0, "plain "), (0.02, "huber ")):
        refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                                  render_scale=2, chunk_iters=64, window=128,
                                  stride=2, max_points=2048, decimate_mm=2.0,
                                  robust_delta=delta)
        refiner.set_scene_depth(d)
        wall, (refined, res) = time_median(lambda: refiner.refine(poses_j), iters=3)
        refined = np.asarray(refined)
        rot = rotation_angle_deg(refined, truth)
        rec = rot < 3.0
        if base_ok is None:
            base_ok = rec
        adds = add_error(refined, truth, model.vertices)
        print(f"{name:24s} {tag}: recovered {rec.mean()*100:3.0f}% (agree vs "
              f"clean-plain {(rec == base_ok).mean()*100:3.0f}%) | "
              f"ADD(recovered) mean {adds[rec].mean():.3f} max "
              f"{adds[rec].max():.3f} mm | fitness "
              f"{float(np.asarray(res.fitness).mean()):.3f}", flush=True)
