"""Frame-to-frame tracking demo: the production serving loop.

Simulates a sensor stream: each frame the object moves (rotation drift +
translation), the scene is REBUILT from that frame's depth (the reference
re-inits its scene every frame too, SURVEY 3.3 - our warm rebuild is
~10 ms), and a small hypothesis batch seeded from the previous estimate is
refined. Static shapes mean frame 2+ hits the compile cache - the loop
runs at steady-state latency.

Run: PYTHONPATH=. python scripts/demo_track.py [nn] [coarse] [fused]
  'nn' tracks with the fused ON-DEVICE NN scene build
  (SceneNN.from_depth_device + brute-force association) instead of projective.
  'coarse' opts into the coarse-to-fine ICP point schedule (c=16, s=4) -
  the LOW-RISK place for it: the tracking prior is within a few degrees,
  so the borderline-basin flips the headline study gates on cannot arise.
  'fused' runs the full production filter loop via prt.TrackingSession
  (predict -> belief-sampled hypotheses -> track(with_covariance=True) ->
  gated update), still ONE device dispatch per frame (the measurement
  covariance comes fused out of the program). On
  this demo's white-noise motion the filter is correctly a pass-through
  (K ~= 1; scripts/fusion_study.py measures the regimes where it pays) -
  the point here is the loop shape and its cost parity with raw tracking.
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup

import pose_refine as prt
from pose_refine import geometry
from pose_refine.utils.metrics import rotation_angle_deg
from jax import block_until_ready as sync

N_HYP = 16      # tracking needs few hypotheses - the prior is good
N_FRAMES = 30
NN = "nn" in sys.argv[1:]
COARSE = "coarse" in sys.argv[1:]
FUSED = "fused" in sys.argv[1:]
model, tris, K, proj, truth0, _ = setup(4)

refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                          chunk_iters=64, window=128, stride=2,
                          max_points=2048, decimate_mm=4.0,
                          **(dict(coarse_iters=16, coarse_stride=4)
                             if COARSE else {}),
                          **(dict(scene="nn_bruteforce", scene_stride=3)
                             if NN else {}))

rng = np.random.default_rng(3)
truth = truth0.copy()
estimate = truth0.copy()   # perfect init on frame 0
# fused mode = the productized loop: TrackingSession runs predict ->
# belief-sampled hypotheses -> track(with_covariance=True) -> gated update.
# Random-walk process noise sized to the actual per-frame motion (2 deg /
# 5 mm): honest for this white-noise drift - see the study for predict_cv.
session = prt.TrackingSession(
    refiner, truth0,
    init_cov=np.diag([np.radians(2.0) ** 2] * 3 + [0.005 ** 2] * 3),
    process_noise=(np.radians(2.0), 0.005),
    n_hypotheses=N_HYP, seed=3,
) if FUSED else None
lat = []
errs = []
for frame in range(N_FRAMES):
    # object moves: ~2 deg/axis rotation drift + ~5 mm translation per frame
    drift = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.035, 0.035, 3).astype(np.float32)))
    truth = np.asarray(geometry.pose_from_Rt(
        drift @ truth[:3, :3],
        truth[:3, 3] + rng.uniform(-5, 5, 3).astype(np.float32)))

    # "sensor" frame -> ONE fused program: scene build + refinement
    frame_depth = scene_render(tris, truth, proj)
    t0 = time.perf_counter()
    # pure host numpy bookkeeping - no eager device ops inside the loop
    if FUSED:
        # one fused device program per frame; readbacks fence the step
        estimate = session.step(frame_depth).pose
        dt = time.perf_counter() - t0
    else:
        hyps = geometry.sample_hypotheses(
            estimate, N_HYP, rot_deg=np.degrees(0.02), trans_mm=3.0, rng=rng)
        refined, res = refiner.track(frame_depth, hyps)
        sync((refined, res.fitness))
        dt = time.perf_counter() - t0
        best = prt.PoseRefiner.rank(res)[0]
        estimate = np.asarray(refined)[best]
    err = float(rotation_angle_deg(estimate, truth))
    if frame > 0:           # frame 0 pays the compile
        lat.append(dt)
    errs.append(err)

lat = np.array(lat)
print(f"tracked {N_FRAMES} frames on {jax.devices()[0].device_kind}: "
      f"steady-state {np.median(lat)*1000:.0f} ms/frame "
      f"({1/np.median(lat):.1f} fps incl. per-frame scene rebuild), "
      f"rot err mean {np.mean(errs):.3f} max {np.max(errs):.3f} deg")
assert max(errs) < 1.0, "tracking lost the object"
print("PASS")
