"""scene_pool study: does on-device centroid pooling match host voxel
downsampling on CLUTTERED scenes?

A comparison of scene_stride and scene_voxel_mm on object-only scenes has
nothing to prune; this study adds real
background clutter - a wall plane behind the object and a second object
beside it - where depth edges are exactly where plain pooling would
fabricate ghost points and where downsampling quality actually matters.

Arms (all NN brute-force association):
  full        - device-built scene at full grid resolution
  stride2/3   - grid subsampling (drops points, no denoising)
  pool(auto)  - on-device depth-aware centroid pooling, auto-derived from
                scene_voxel_mm (the round-4 track() path)
  host voxel  - set_scene_depth + refine with scene_voxel_mm (the reference
                -style host build; the accuracy yardstick)

Run: PYTHONPATH=. python scripts/scene_pool_study.py [smoke]
(CPU ok for accuracy; on the GPU also reports per-batch wall.)
"""
import sys
import time

import numpy as np

SMOKE = "smoke" in sys.argv[1:]
if "cpu" in sys.argv[1:] or SMOKE:
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp
from jax import block_until_ready as sync

import pose_refine as prt
from pose_refine import geometry, mesh, platform
from pose_refine.utils.metrics import rotation_angle_deg

platform.enable_compile_cache()

# CPU exact-NN is O(Q x S) single-core: keep the CPU config small
_CPU = SMOKE or "cpu" in sys.argv[1:] or not platform.is_accelerator()
W, H = (160, 120) if _CPU else (320, 240)
N_POSES = 4 if SMOKE else (8 if _CPU else 32)


def composite(*depths):
    out = np.zeros_like(depths[0])
    for d in depths:
        take = (d > 0) & ((out == 0) | (d < out))
        out = np.where(take, d, out)
    return out


def main():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= W / 640.0
    obj = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    clutter = mesh.make_icosphere(radius=35.0, subdivisions=3)
    r_obj = prt.PoseRenderer(obj, K=K, width=W, height=H, backend="dense")
    r_cl = prt.PoseRenderer(clutter, K=K, width=W, height=H, backend="dense")

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(geometry.euler_to_rotation(
        np.float32([0.4, -0.3, 0.2])))
    pose[:3, 3] = [-20.0, 0.0, 300.0]
    pose_cl = pose.copy()
    pose_cl[:3, 3] = [75.0, 10.0, 330.0]

    d_obj = np.asarray(r_obj.render_depth(pose))[0].astype(np.int32)
    d_cl = np.asarray(r_cl.render_depth(pose_cl))[0].astype(np.int32)
    # background wall at 600 mm with +-3 mm texture, everywhere
    rng = np.random.default_rng(0)
    wall = (600 + rng.integers(-3, 4, size=(H, W))).astype(np.int32)
    depth = composite(d_obj, d_cl, wall)
    frac_obj = (d_obj > 0).mean()
    print(f"scene {W}x{H}: object {frac_obj*100:.1f}% of pixels, clutter+wall fill the rest")

    hyps = []
    for _ in range(N_POSES):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.12, 0.12, 3).astype(np.float32)))
        hyps.append(np.asarray(geometry.pose_from_Rt(
            d @ pose[:3, :3],
            pose[:3, 3] + rng.uniform(-12, 12, 3).astype(np.float32))))
    hyps = np.stack(hyps)

    common = dict(K=K, width=W, height=H, max_points=4096, window=96,
                  stride=1,
                  scene="nn_bruteforce")

    def run_track(tag, **kw):
        ref = prt.PoseRefiner(obj, **common, **kw)
        t0 = time.perf_counter()
        refined, results = ref.track(depth, hyps)
        sync((refined, results.fitness))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        refined, results = ref.track(depth, hyps)
        sync((refined, results.fitness))
        wall = time.perf_counter() - t0
        # explicit ints never populate _scene_pool_cache (only the "auto"
        # path does) - resolve the pool the same way track() did
        pool = (ref.scene_pool if isinstance(ref.scene_pool, int)
                else ref._scene_pool_cache or 1)
        report(tag, ref, refined, results, wall,
               ref._scene_perm(depth.shape, pool).shape[0])

    def run_host_voxel(tag, vox):
        ref = prt.PoseRefiner(obj, **common, scene_voxel_mm=vox)
        ref.set_scene_depth(depth)
        t0 = time.perf_counter()
        refined, results = ref.refine(hyps)
        sync((refined, results.fitness))
        t0 = time.perf_counter()
        refined, results = ref.refine(hyps)
        sync((refined, results.fitness))
        wall = time.perf_counter() - t0
        report(tag, ref, refined, results, wall, ref.scene.points.shape[0])

    def report(tag, ref, refined, results, wall, scene_pts):
        rot = rotation_angle_deg(np.asarray(refined), pose)
        fit = np.asarray(results.fitness)
        t_err = np.abs(np.asarray(refined)[:, :3, 3] - pose[:3, 3]).max(1)
        rec = (rot < 3.0)
        print(f"{tag:>22}: scene {scene_pts:6d} pts | recovered "
              f"{rec.mean()*100:3.0f}% | best rot {rot.min():.3f} deg "
              f"t {t_err[rot.argmin()]:.2f} mm | fit(best) {fit.max():.3f} "
              f"| wall {wall*1000:.0f} ms")

    run_track("full-res device", scene_pool=1)
    run_track("stride 2", scene_stride=2, scene_pool=1)
    run_track("stride 3", scene_stride=3, scene_pool=1)
    # explicit pool factors: stride's centroid-pooling counterpart at the
    # SAME scene size (pool k and stride k both yield ~1/k^2 points)
    run_track("pool 2", scene_pool=2)
    run_track("pool 3", scene_pool=3)
    # the track() auto path: pool derived from scene_voxel_mm + median
    # depth (resolves to 1 when the grid pitch already exceeds the voxel,
    # e.g. at the smoke resolution - that is correct, not a missed config)
    run_track("pool auto (voxel 2mm)", scene_voxel_mm=2.0)
    run_track("pool auto (voxel 4mm)", scene_voxel_mm=4.0)
    run_host_voxel("host voxel 2mm", 2.0)
    run_host_voxel("host voxel 4mm", 4.0)


if __name__ == "__main__":
    main()
