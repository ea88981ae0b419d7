"""Convergence basin: recovery vs start-perturbation magnitude, with and
without the coarse-to-fine association schedule.

The reference runs one fixed 0.1 m gate (depth_scene.h:9); the schedule
(refine(schedule=[(0.4, 10), (0.1, 21)])) widens the gate first to capture
large displacements, then tightens. This maps where that matters: sweep
rotation perturbations 5..30 deg/axis (translation scaled alongside) and
measure recovery for both modes at the production config.
"""
import jax
import jax.numpy as jnp
import numpy as np

from _workload import R_REN, scene_render, setup

import pose_refine as prt
from pose_refine import geometry
from pose_refine.utils.metrics import rotation_angle_deg
from jax import block_until_ready as sync

N = 256
model, tris, K, proj, truth, _ = setup(N)
scene_depth = scene_render(tris, truth, proj)

refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                          chunk_iters=64, window=128, stride=2,
                          max_points=2048, decimate_mm=2.0)
refiner.set_scene_depth(scene_depth)

print(f"{'deg/axis':>9} {'mm':>5} | {'plain':>6} | {'schedule':>8}")
for deg in (5, 10, 15, 20, 25, 30):
    rad = np.deg2rad(deg)
    mm = 2.0 * deg  # translation scales with rotation severity
    rng = np.random.default_rng(deg)
    d_rot = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-rad, rad, (N, 3)).astype(np.float32)))
    poses = np.asarray(geometry.pose_from_Rt(
        jnp.einsum("nij,jk->nik", d_rot, truth[:3, :3]),
        truth[:3, 3] + rng.uniform(-mm, mm, (N, 3)).astype(np.float32)))
    poses_j = jax.device_put(jnp.asarray(poses))

    plain, _ = refiner.refine(poses_j)
    sched, _ = refiner.refine(poses_j, schedule=[(0.4, 10), (0.1, 21)])
    sync((plain, sched))
    rp = (rotation_angle_deg(np.asarray(plain), truth) < 3.0).mean()
    rs = (rotation_angle_deg(np.asarray(sched), truth) < 3.0).mean()
    print(f"{deg:>9} {mm:>5.0f} | {rp*100:5.0f}% | {rs*100:7.0f}%", flush=True)
