"""ADD parity study (BASELINE north star: "ADD pose error matched to 1e-3").

Two levels, on the failure-parity workload (64 random hypotheses around a
LINEMOD viewpoint of obj_06 @ 640x480):

1. IMPLEMENTATION parity - identical inputs (same lifted clouds, same scene)
   through (a) the jitted ICP and (b) the C++ reference-algorithm
   baseline (native/cpu_baseline.cpp). This isolates the ICP math;
   target ADD <= 1e-3 m = 1.0 mm over the obj_06 vertices.
2. PIPELINE parity - each side's full pipeline (device: raster kernel + window
   lift; CPU: scanline render + scan compaction). Render/lift differences
   make this looser; reported for context.

Reference accuracy criterion: /root/reference/test.cpp:177-192.
Results recorded in PARITY.md.
"""
import jax
from pose_refine.platform import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp, numpy as np
import pose_refine as prt
from pose_refine import geometry, icp as icp_mod, mesh, native
from pose_refine.ops.rasterize import render
from pose_refine.ops.depth_to_cloud import depth_to_cloud
from pose_refine.utils.metrics import add_error, adds_error, rotation_angle_deg
from jax import block_until_ready as sync

W, H, N = 640, 480, 64
model = mesh.load_benchmark_model()
tris = jnp.asarray(model.tris[mesh.morton_order(model.tris)])
K = geometry.LINEMOD_K
proj = geometry.compute_proj(K, W, H)
R1 = np.array([[0.34768538, 0.93761126, 0.0],
               [0.70540612, -0.26157897, -0.65877056],
               [-0.61767070, 0.22904489, -0.75234390]], np.float32)
truth = np.asarray(geometry.pose_from_Rt(R1, np.array([0, 0, 300], np.float32)))
rng = np.random.default_rng(0)
d_rot = np.asarray(geometry.euler_to_rotation(rng.uniform(-0.17, 0.17, (N, 3)).astype(np.float32)))
poses = np.asarray(geometry.pose_from_Rt(
    jnp.einsum("nij,jk->nik", d_rot, truth[:3, :3]),
    truth[:3, 3] + rng.uniform(-20, 20, (N, 3)).astype(np.float32)))

scene_depth = np.asarray(sync(render(tris, jnp.asarray(truth)[None], W, H, proj)))[0]
refiner = prt.PoseRefiner(model, K=K, width=W, height=H, max_points=8192)
refiner.set_scene_depth(scene_depth)
scene = refiner.scene

# ---- level 1: implementation parity (identical clouds + scene) ----
# clouds rendered per-hypothesis by the SAME renderer for both sides
dep = np.asarray(sync(render(tris, jnp.asarray(poses), W, H, proj)))
clouds, valids = [], []
for i in range(N):
    c, v, _ = depth_to_cloud(dep[i], K, max_points=32768)
    clouds.append(np.asarray(c)); valids.append(np.asarray(v))
clouds = np.stack(clouds); valids = np.stack(valids)

res, _ = icp_mod.icp_point_to_plane_batch(
    jax.device_put(jnp.asarray(clouds)), jax.device_put(jnp.asarray(valids)), scene)
T_dev = np.asarray(sync(res.transformation))

T_ref, fit_ref, rmse_ref = native.cpu_icp_baseline(
    clouds, valids, np.asarray(scene.pcd), np.asarray(scene.normal), K)

def compose(T_icp):
    T_mm = np.asarray(T_icp).copy()
    T_mm[:, :3, 3] *= 1000.0
    return np.einsum("nij,njk->nik", T_mm, poses)

final_dev = compose(T_dev)
final_ref = compose(T_ref)
adds = add_error(final_dev, final_ref, model.vertices)
rot = rotation_angle_deg(final_dev, final_ref)
fit_diff = np.abs(np.asarray(res.fitness) - fit_ref)
print(f"[impl parity, N={N}] ADD mm: mean {adds.mean():.4f}  p95 {np.percentile(adds,95):.4f}  max {adds.max():.4f}")
print(f"[impl parity] rot deg: max {rot.max():.4f}   |fitness diff|: max {fit_diff.max():.5f}")
sub = model.vertices[:: max(1, len(model.vertices) // 2000)]
adds_s = adds_error(final_dev, final_ref, sub)
print(f"[impl parity] ADD-S mm (2k-vert subsample): mean {adds_s.mean():.4f}  max {adds_s.max():.4f}")

# ---- level 2: full-pipeline parity ----
refined, _ = refiner.refine(jax.device_put(jnp.asarray(poses)))
refined = np.asarray(sync(refined))

dep_cc = native.cpu_render_baseline(np.asarray(tris), poses, np.asarray(proj), W, H)
clouds2, valids2 = [], []
for i in range(N):
    c, v, _ = depth_to_cloud(dep_cc[i], K, max_points=32768)
    clouds2.append(np.asarray(c)); valids2.append(np.asarray(v))
T_cc, _, _ = native.cpu_icp_baseline(
    np.stack(clouds2), np.stack(valids2), np.asarray(scene.pcd), np.asarray(scene.normal), K)
final_cpu_pipe = compose(T_cc)
adds_pipe = add_error(refined, final_cpu_pipe, model.vertices)
# exclude shared convergence failures (both sides in the same local minimum
# still land within mm of each other; a case where they disagree >3 deg in
# verdict means divergent basins - report both populations)
agree = rotation_angle_deg(refined, final_cpu_pipe) < 3.0
print(f"[pipeline parity] ADD mm: mean {adds_pipe.mean():.3f}  max {adds_pipe.max():.3f}  "
      f"(same-basin {agree.mean()*100:.0f}%: mean {adds_pipe[agree].mean():.3f}, max {adds_pipe[agree].max():.3f})")
