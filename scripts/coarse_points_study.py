"""Coarse-to-fine ICP point schedule study.

An ICP iteration's cost is gather-row-bound (~2.1 ms for 256x2048 rows,
the ICP profile), so iterations on a 1-in-s strided subsample cost ~1/s of a
full one. coarse_iters=c runs the first c iterations on cloud[::s] (pure
Gauss-Newton warm-up, no scoring) and the remaining max_iter-c + scoring
pass on the full cloud - one fused program, no extra dispatch (unlike the
rs3->rs2 cascade, which was wall-neutral from fixed per-pass costs).

Expected ceiling at the production config (24-iter criteria): c=12, s=2
removes ~12 half-gathers ~= 12 x ~1.05 ms ~= 13 ms of the 141 ms wall
(~+10%). Gates as always: fixed-seed per-case verdicts vs c=0, ADD,
per-pose drift vs the c=0 twin.

Run: python scripts/coarse_points_study.py   (GPU)
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
CRIT = ICPConvergenceCriteria(max_iteration=24)

base_ok = None
base_T = None
for c, s in ((0, 2), (8, 2), (12, 2), (16, 2), (12, 4), (16, 4)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=2, window=128, stride=2,
                              max_points=2048, decimate_mm=4.0,
                              coarse_iters=c, coarse_stride=s)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j, criteria=CRIT))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    adds = add_error(refined, truth, model.vertices)
    if base_ok is None:
        base_ok, base_T = rec, refined
    d0 = np.array([
        add_error(refined[i][None], base_T[i], model.vertices)[0] for i in range(N)
    ])
    flips = np.nonzero(rec != base_ok)[0]
    flip_txt = "" if not len(flips) else (
        " | flips: " + ", ".join(
            f"{i}({'RECOVERS' if rec[i] else 'FAILS'})" for i in flips))
    print(f"coarse {c:2d}/stride {s}: wall {wall*1e3:6.1f} ms ({N/wall:5.0f}/s) | "
          f"recovered {rec.mean()*100:3.0f}% | verdict agree {(rec==base_ok).mean()*100:5.1f}% | "
          f"ADD(rec) mean {adds[rec].mean():.3f} max {adds[rec].max():.3f} mm | "
          f"vs-c0 ADD(rec) max {d0[rec].max():.3f} mm{flip_txt}", flush=True)


# ---- part 2: the opt-in's value in the other serving modes ----
# streaming ceiling (batch 512 x 4 in flight, the r3 sweet spot) and the
# NN pipeline (voxel-2mm scene). Run only when part 1 completed (same
# process, warm cache for c=0 configs).

from pose_refine.pipeline import fence

print("\n-- streaming ceiling (batch 512, 4 in flight) --", flush=True)
big = np.concatenate([poses, poses], axis=0)
big_j = jax.device_put(jnp.asarray(big))
for c, s in ((0, 2), (12, 2), (16, 4)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=2, window=128, stride=2,
                              max_points=2048, decimate_mm=4.0,
                              coarse_iters=c, coarse_stride=s)
    refiner.set_scene_depth(scene_depth)
    refiner.refine(big_j, criteria=CRIT)  # warm
    def run():
        pending = [refiner.refine_async(big_j, criteria=CRIT) for _ in range(4)]
        return fence(*pending)
    wall, _ = time_median(run)
    print(f"coarse {c:2d}/stride {s}: {4 * len(big) / wall:5.0f} poses/s "
          f"({wall*1e3:.0f} ms / 4x{len(big)})", flush=True)

print("\n-- NN pipeline (voxel-2mm scene, batch 256) --", flush=True)
for c, s in ((0, 2), (12, 2), (16, 4)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=2, window=128, stride=2,
                              max_points=2048, decimate_mm=4.0,
                              scene="nn_bruteforce", scene_voxel_mm=2.0,
                              coarse_iters=c, coarse_stride=s)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j, criteria=CRIT))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    print(f"coarse {c:2d}/stride {s}: {N / wall:5.0f} poses/s "
          f"({wall*1e3:.0f} ms) | recovered {rec.mean()*100:3.0f}%", flush=True)


# ---- part 3: are NN verdicts flip-stable under the coarse schedule? ----
# Projective association is discontinuous at occlusion boundaries (a moved
# point's image-space lookup jumps surfaces), which is where the
# borderline-basin flips plausibly come from; NN association is
# continuous in the pose. Build a genuinely BORDERLINE NN workload
# (+-15 deg / +-30 mm: beyond the acceptance recipe, so some cases fail)
# and check per-case verdict agreement c>0 vs c=0.

from pose_refine.geometry import sample_hypotheses

print("\n-- NN borderline flip check (+-15 deg/+-30 mm, batch 256) --", flush=True)
hard = sample_hypotheses(truth, N, rot_deg=15.0, trans_mm=30.0,
                         rng=np.random.default_rng(7))
hard_j = jax.device_put(jnp.asarray(hard))
nn_base = None
for c, s in ((0, 2), (8, 2), (12, 2), (16, 2), (16, 4)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=2, window=128, stride=2,
                              max_points=2048, decimate_mm=4.0,
                              scene="nn_bruteforce", scene_voxel_mm=2.0,
                              coarse_iters=c, coarse_stride=s)
    refiner.set_scene_depth(scene_depth)
    refined, res = refiner.refine(hard_j, criteria=CRIT)
    rec = rotation_angle_deg(np.asarray(refined), truth) < 3.0
    if nn_base is None:
        nn_base = rec
    flips = np.nonzero(rec != nn_base)[0]
    flip_txt = "" if not len(flips) else (
        " | flips: " + ", ".join(
            f"{i}({'RECOVERS' if rec[i] else 'FAILS'})" for i in flips))
    print(f"coarse {c:2d}/stride {s}: recovered {rec.mean()*100:4.1f}% | "
          f"verdict agree {(rec==nn_base).mean()*100:5.1f}%{flip_txt}", flush=True)

# and the projective twin of the same hard workload, for a fair read on
# whether flip-proneness is the ASSOCIATION's property, not the workload's
print("\n-- projective twin of the borderline workload --", flush=True)
pj_base = None
for c, s in ((0, 2), (12, 2), (16, 4)):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480,
                              render_scale=2, window=128, stride=2,
                              max_points=2048, decimate_mm=4.0,
                              coarse_iters=c, coarse_stride=s)
    refiner.set_scene_depth(scene_depth)
    refined, res = refiner.refine(hard_j, criteria=CRIT)
    rec = rotation_angle_deg(np.asarray(refined), truth) < 3.0
    if pj_base is None:
        pj_base = rec
    flips = np.nonzero(rec != pj_base)[0]
    print(f"coarse {c:2d}/stride {s}: recovered {rec.mean()*100:4.1f}% | "
          f"verdict agree {(rec==pj_base).mean()*100:5.1f}% | {len(flips)} flips", flush=True)
