"""Temporal fusion study: where does PoseTracker measurably help a track?

Regime analysis first (this drove the study design): the filter's gain is
K = P_pred (P_pred + R)^-1. The refinement measurements are GOOD (R_rot std
~0.1-0.5 deg even on corrupted frames), so whenever inter-frame motion
(process noise) is large - the demo's ~2 deg/frame drift - K ~= 1 and the
filter is correctly a pass-through: no smoothing value, none expected (an
early fast-motion run showed only chaotic trajectory divergence between
raw and fused, not filter behavior). Fusion pays in two real regimes:

  1. SLOW motion relative to measurement noise (high frame rate or a
     near-static object): K < 1 averages measurements, error drops.
  2. WRONG-BASIN refinements (occlusion/glare frames): the chi-square
     innovation gate rejects the outlier measurement outright.

The study measures both, under the noise_robustness.py corruption model
(Gaussian depth noise + dropout holes), with every CORRUPT_EVERY-th frame
heavily degraded (80% of pixels gone, 10x noise - refinement can fail
outright there). Estimators on the same
frames/seeds:

  raw    - best-ranked refined hypothesis fed straight back (the demo loop)
  fused  - PoseTracker: per-frame pose_covariance as measurement noise,
           chi-square innovation gate, belief-mean fed back as the prior
  fused-inprog - same filter, but the per-frame covariance comes FUSED out
           of refine(with_covariance=True) (one program instead of the
           standalone pose_information path's eager ops). Its R is the ICP's own final-cloud covariance rather
           than the probe-cloud one - the production deployment mode.
  fused-fixcov - same but with the frame-0 covariance reused (no per-frame
           pose_information dispatch - the cheap deployment mode)
  fused-cv - constant-velocity prediction (predict_cv) with process noise
           sized to the residual ACCELERATION (~1/10 the drift), not the
           full motion - the principled treatment of the fast regime,
           where random-walk fusion is a pass-through by design

Run: PYTHONPATH=. python scripts/fusion_study.py [fast]
  default: slow-motion regime (0.2 deg / 0.5 mm per frame jitter, no base
           motion)
  'fast':  the demo's ~2 deg / 5 mm per-frame motion as a CONSTANT base
           twist + the slow jitter. Random-walk fusion is expected to show
           K ~= 1 pass-through (documented for honesty); fused-cv explains
           the base motion and should restore the filter's value
"""
import sys
import time

import jax
import numpy as np

from _workload import scene_render, setup

import pose_refine as prt
from pose_refine import geometry, icp
from pose_refine.utils import fusion as fusion_mod
from pose_refine.utils.fusion import PoseTracker
from pose_refine.utils.metrics import rotation_angle_deg
from jax import block_until_ready as sync

FAST = "fast" in sys.argv[1:]
SMOKE = "smoke" in sys.argv[1:]  # tiny CPU-runnable config (code-path check)
VERBOSE_FITNESS = "fitness" in sys.argv[1:]  # per-frame best-fitness dump
MIN_FITNESS = 0.6  # the '-q' arms' quality gate (clean frames >>, corrupt <<)
N_HYP = 4 if SMOKE else 16
N_FRAMES = 10 if SMOKE else 40
SIGMA_MM = 3.0
HOLES = 0.10
CORRUPT_EVERY = 8          # every 8th frame: 80% holes + 30 mm noise
# truth motion = (fast only) a CONSTANT base twist - the realistic fast
# regime: conveyor / turntable / steady camera sweep - plus white
# per-frame jitter (rad/axis, mm/axis) in both regimes
BASE = None
if FAST:
    BASE = np.asarray(fusion_mod.se3_exp([0.0, 0.0, 0.035, 0.0, 0.005, 0.0]))
    BASE[:3, 3] *= 1000.0  # mm pose composition
JIT_ROT, JIT_T = 0.0035, 0.5
# process noise: the random-walk modes must diffuse over the FULL motion
# (base + jitter) - in the fast regime that large Q is exactly why they
# degenerate to a pass-through; predict_cv explains the base motion, so
# its Q only covers jitter + velocity-estimate noise
PROC = (np.radians(2.5), 0.006) if FAST else (np.radians(0.25), 0.0006)
PROC_CV = (np.radians(0.5), 0.0015)
model, tris, K, proj, truth0, _ = setup(4)

refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                          chunk_iters=64, window=128, stride=2,
                          max_points=2048, decimate_mm=4.0)

# model-surface probe cloud for pose_information (camera-frame, meters)
_probe_idx = np.random.default_rng(0).choice(
    len(model.vertices), size=2048, replace=False)
_probe_mm = model.vertices[_probe_idx]


def measurement_cov(pose_mm):
    cam = (pose_mm[:3, :3] @ _probe_mm.T).T + pose_mm[:3, 3]
    info, s2, _ = icp.pose_information(
        (cam / 1000.0).astype(np.float32),
        np.ones(len(cam), bool), refiner.scene.query)
    return np.asarray(icp.pose_covariance(info, s2), np.float64)


def run_track(mode):
    rng = np.random.default_rng(3)
    nrng = np.random.default_rng(7)
    truth = truth0.copy()
    estimate = truth0.copy()
    tracker = None
    errs_r, errs_t, rejected = [], [], 0
    fix_cov = None
    for frame in range(N_FRAMES):
        jit = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-JIT_ROT, JIT_ROT, 3).astype(np.float32)))
        truth = np.asarray(geometry.pose_from_Rt(
            jit @ truth[:3, :3],
            truth[:3, 3] + rng.uniform(-JIT_T, JIT_T, 3).astype(np.float32)))
        if BASE is not None:  # fast regime: constant base twist
            truth = (BASE @ truth).astype(np.float32)

        d = scene_render(tris, truth, proj).astype(np.float32)
        valid = d > 0
        bad = frame > 0 and frame % CORRUPT_EVERY == 0
        sigma = SIGMA_MM * (10.0 if bad else 1.0)
        holes = 0.8 if bad else HOLES
        d = d + nrng.normal(0, sigma, d.shape).astype(np.float32) * valid
        d = d * (nrng.uniform(size=d.shape) >= holes * valid)
        d = np.maximum(d, 0.0).astype(np.int32)

        refiner.set_scene_depth(d)
        # time update FIRST: the predicted pose is the refinement prior
        # (with CV prediction this carries the prior to where the object
        # actually moved - the canonical predict -> refine -> update loop)
        if tracker is not None:
            if mode == "fused-cv":
                tracker.predict_cv()
            else:
                tracker.predict()
        prior = estimate if tracker is None else tracker.pose_mm
        hyps = geometry.sample_hypotheses(
            prior, N_HYP, rot_deg=np.degrees(0.02), trans_mm=3.0, rng=rng)
        inprog = mode.startswith("fused-inprog")
        qgate = mode.endswith("-q")
        if inprog:
            refined, res, unc = refiner.refine(hyps, with_covariance=True)
        else:
            refined, res = refiner.refine(hyps)
        best_idx = prt.PoseRefiner.rank(res)[0]
        best = np.asarray(refined)[best_idx]
        fit_best = float(np.asarray(res.fitness)[best_idx])
        if VERBOSE_FITNESS:
            print(f"  frame {frame:2d} {'BAD' if bad else '   '} "
                  f"best fitness {fit_best:.3f}")

        def frame_cov():
            if inprog:
                return np.asarray(unc.covariance, np.float64)[best_idx]
            return measurement_cov(best)

        if mode == "raw":
            estimate = best
        elif tracker is None:
            proc = PROC_CV if mode == "fused-cv" else PROC
            tracker = PoseTracker(best, process_noise=proc)
            fix_cov = None if inprog else measurement_cov(best)
            estimate = tracker.pose_mm
        else:
            cov = fix_cov if mode == "fused-fixcov" else frame_cov()
            gate = (dict(quality=fit_best, min_quality=MIN_FITNESS)
                    if qgate else {})
            if not tracker.update(best, cov, **gate):
                rejected += 1
            estimate = tracker.pose_mm
        errs_r.append(float(rotation_angle_deg(estimate, truth)))
        errs_t.append(float(np.abs(estimate[:3, 3] - truth[:3, 3]).max()))
    return np.array(errs_r), np.array(errs_t), rejected


motion = (f"base 2.0 deg/5 mm per frame + jitter" if FAST
          else "jitter only")
print("device:", jax.devices()[0].device_kind,
      f"({'fast' if FAST else 'slow'} motion: {motion} "
      f"{np.degrees(JIT_ROT):.1f} deg/{JIT_T:g} mm; "
      f"{N_FRAMES} frames, sigma {SIGMA_MM} mm + {HOLES:.0%} holes, "
      f"every {CORRUPT_EVERY}th frame 80% holes + {SIGMA_MM*10:.0f} mm)")
modes = ("raw", "fused", "fused-inprog", "fused-inprog-q", "fused-fixcov",
         "fused-cv") if FAST else ("raw", "fused", "fused-inprog", "fused-fixcov")
only = [a[5:] for a in sys.argv[1:] if a.startswith("only=")]
if only:
    modes = tuple(m for m in modes if m in only)
for mode in modes:
    t0 = time.time()
    er, et, rej = run_track(mode)
    badf = [i for i in range(N_FRAMES) if i > 0 and i % CORRUPT_EVERY == 0]
    print(f"{mode:13s} rot err mean {er.mean():.3f} p95 "
          f"{np.percentile(er, 95):.3f} max {er.max():.3f} deg | "
          f"t err mean {et.mean():.2f} max {et.max():.2f} mm | "
          f"bad-frame rot mean {er[badf].mean():.3f} deg | "
          f"rejected {rej} | {time.time()-t0:.0f} s")
