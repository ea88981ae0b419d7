"""Cascade refinement study: coarse rs=3 recall pass -> rs=2 polish.

The rs=3 study (render_scale3_study.py) rejected 213x160 renders as the
default because ADD doubles - but recovery went UP. That is exactly the
profile of a first cascade stage: refine ALL hypotheses cheaply at rs=3,
keep the top-K by fitness, then polish only the survivors at the accurate
rs=2 config. For the identification workload (find the right pose among N
hypotheses; the reference's re-ranking use case, icp.h:26-36) the polish
pass touches K << N poses.

Gates: the cascade must (a) keep the true-basin pose in the survivor set,
(b) end with rs=2-grade ADD on the winner, (c) beat the flat rs=2 batch
wall-clock.

Run: python scripts/cascade_study.py   (GPU)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine.utils.metrics import add_error, rotation_angle_deg
from jax import block_until_ready as sync

N = 256
model, tris, K, proj, truth, poses = setup(N)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))


def build(rs, window, mp):
    r = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=rs,
                        window=window, stride=2, max_points=mp, decimate_mm=4.0)
    r.set_scene_depth(scene_depth)
    return r


fine = build(2, 128, 2048)
coarse = build(3, 96, 1536)

# flat rs=2 baseline
wall_flat, (ref_flat, res_flat) = time_median(lambda: fine.refine(poses_j))
rot_flat = rotation_angle_deg(np.asarray(ref_flat), truth)
best_flat = int(prt.PoseRefiner.rank(res_flat)[0])
add_flat = add_error(np.asarray(ref_flat)[best_flat][None], truth, model.vertices)[0]
print(f"flat rs2:          wall {wall_flat*1e3:6.1f} ms | best-pose rot "
      f"{rot_flat[best_flat]:.3f} deg ADD {add_flat:.3f} mm | "
      f"recovered {(rot_flat<3).mean()*100:.0f}%", flush=True)

for keep in (16, 32, 64):
    def cascade():
        r1, s1 = coarse.refine(poses_j)
        order = jnp.argsort(-s1.fitness)[:keep]  # device-side top-K
        survivors = jnp.take(r1, order, axis=0)
        r2, s2 = fine.refine(survivors)
        return r1, s1, order, r2, s2

    wall, (r1, s1, order, r2, s2) = time_median(cascade)
    rot2 = rotation_angle_deg(np.asarray(r2), truth)
    best = int(prt.PoseRefiner.rank(s2)[0])
    add2 = add_error(np.asarray(r2)[best][None], truth, model.vertices)[0]
    # did the survivor set contain a true-basin pose?
    print(f"cascade rs3->rs2 keep={keep:3d}: wall {wall*1e3:6.1f} ms "
          f"({wall_flat/wall:.2f}x faster) | best rot {rot2[best]:.3f} deg "
          f"ADD {add2:.3f} mm | survivors recovered {(rot2<3).mean()*100:.0f}%",
          flush=True)
