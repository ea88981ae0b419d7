"""NN scene-cascade study : does
scene_cascade=(coarse_voxel_mm, coarse_iters) + a short full-resolution pass
match the accuracy of a full-length raw-scene refine at ~2x the throughput?

Arms (bench workload: 256 jittered hypotheses, 26k-pt raw scene cloud):
  raw-24          - single level, 24 iters against the raw cloud (the r3/r4
                    bench config for poses_per_sec_batch256_nn_scene_raw_cloud)
  cascade-16+8    - scene_cascade=(2.0, 16), 8 fine iters (same total 24)
  cascade-16+4    - the aggressive variant
  voxel-24        - 2 mm voxel scene end-to-end (the non-raw config, context)

Reports poses/s, recovery (<3 deg), per-case verdict agreement vs raw-24, and
max ADD-style translation/rotation deltas of the refined poses vs raw-24.

Run: PYTHONPATH=. python scripts/nn_cascade_study.py [smoke]
"""
import sys
import time

import numpy as np

SMOKE = "smoke" in sys.argv[1:]
if SMOKE:
    import jax
    jax.config.update("jax_platforms", "cpu")
import jax
from pose_refine.platform import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp

import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.utils.metrics import rotation_angle_deg
from jax import block_until_ready as sync

W, H = (320, 240) if SMOKE else (640, 480)
N_POSES = 8 if SMOKE else 256


def main():
    model = mesh.load_benchmark_model()
    K = geometry.LINEMOD_K.copy()
    if SMOKE:
        K[:2] *= 0.5
    R_ren = np.array([[0.34768538, 0.93761126, 0.0],
                      [0.70540612, -0.26157897, -0.65877056],
                      [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = np.asarray(geometry.pose_from_Rt(
        R_ren, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    d_rot = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.17, 0.17, (N_POSES, 3)).astype(np.float32)))
    poses = np.asarray(geometry.pose_from_Rt(
        np.einsum("nij,jk->nik", d_rot, truth[:3, :3]),
        truth[:3, 3] + rng.uniform(-20, 20, (N_POSES, 3)).astype(np.float32)))

    r = prt.PoseRenderer(model, K=K, width=W, height=H)
    scene_depth = np.asarray(r.render_depth(truth[None]))[0].astype(np.int32)

    CFG = dict(render_scale=2, max_points=2048, window=128, stride=2,
               decimate_mm=4.0) if not SMOKE else dict(
                   max_points=2048, window=96, stride=2)
    poses_dev = jax.device_put(jnp.asarray(poses))

    def arm(tag, voxel, cascade, fine_iters):
        print(f"[{tag}] building + compiling...", flush=True)
        ref = prt.PoseRefiner(model, K=K, width=W, height=H,
                              scene="nn_bruteforce",
                              scene_voxel_mm=voxel, scene_cascade=cascade,
                              **CFG)
        ref.set_scene_depth(scene_depth)
        crit = prt.ICPConvergenceCriteria(max_iteration=fine_iters)
        f = lambda: ref.refine(poses_dev, criteria=crit)
        out = f(); sync((out[0], out[1].fitness))
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = f(); sync((out[0], out[1].fitness))
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        refined = np.asarray(out[0])
        fit = np.asarray(out[1].fitness)
        rot = rotation_angle_deg(refined, truth)
        trans = np.linalg.norm(
            (refined[:, :3, 3] - truth[:3, 3]), axis=1)
        verdict = (rot < 3.0) & (fit > 0.7)
        print(f"[{tag}] scene {ref.scene.points.shape[0]} pts"
              + (f" (coarse {ref._scene_coarse.points.shape[0]})" if cascade else "")
              + f" | {N_POSES/wall:6.1f} poses/s ({wall*1000:.0f} ms) | "
              f"recovered {(rot < 3.0).mean()*100:5.1f}% | "
              f"fit {fit.mean():.3f}", flush=True)
        return dict(tag=tag, refined=refined, rot=rot, trans=trans,
                    verdict=verdict, rate=N_POSES / wall)

    arms = [
        arm("raw-24", 0.0, None, 24),
        arm("cascade-16+8", 0.0, (2.0, 16), 8),
        arm("cascade-16+4", 0.0, (2.0, 16), 4),
        arm("voxel-24", 2.0, None, 24),
    ]
    base = arms[0]
    for a in arms[1:]:
        agree = (a["verdict"] == base["verdict"]).mean()
        # pose deltas only where BOTH recovered (same basin)
        both = a["verdict"] & base["verdict"]
        dr = np.abs(a["rot"][both] - base["rot"][both]).max() if both.any() else 0
        dt = np.abs(a["trans"][both] - base["trans"][both]).max() if both.any() else 0
        print(f"{a['tag']:>14} vs raw-24: verdict agreement {agree*100:5.1f}% "
              f"| speedup {a['rate']/base['rate']:.2f}x "
              f"| max |d rot| {dr:.3f} deg, |d trans| {dt:.3f} mm (both-recovered)")


if __name__ == "__main__":
    main()
