"""Third-party cross-validation of ICP results against Open3D (optional dep).

The reference's acceptance demo cross-checks its ICP fitness/rmse/transform
against Open3D's point-to-plane registration on the same clouds
(/root/reference/test.cpp:96-126: model cloud lifted from the perturbed
render, scene cloud from the target render, EstimateNormals, 0.1 max
correspondence distance, identity init). Open3D is not in this image, so the
suite anchors ICP against numpy/f64 oracles (utils/oracle.py), a C++
reference-algorithm baseline (native/cpu_baseline.cpp) and analytic fixtures
(tests/test_icp_anchor.py) instead; this script restores the THIRD-PARTY leg
for environments that do have Open3D, and skips cleanly (exit 0) elsewhere.

Workload = the reference acceptance recipe (test.cpp:22-75): obj_06 at a
LINEMOD viewpoint, second pose = 10 deg/axis + (20, 20, 20) mm off, model
cloud lifted from render(pose1), scene built from render(pose2). Both sides
then solve the same registration from identity, so their transforms,
fitness and rmse are directly comparable (both use a 0.1 m gate; Open3D
re-estimates normals from the scene cloud, ours carry LINEMOD stencil
normals - small fitness/rmse deltas are expected, gross disagreement is
the failure signal).

Usage: python scripts/open3d_crosscheck.py [smoke]
  smoke: icosphere + 160x120 frame (no reference assets, CPU-friendly).
"""
import sys

try:
    import open3d as o3d
except ImportError:
    print("open3d not installed - cross-check skipped (exit 0); see "
          "utils/oracle.py + native/cpu_baseline.cpp for the in-tree anchors")
    sys.exit(0)

import jax
from pose_refine.platform import enable_compile_cache

enable_compile_cache()
import numpy as np
import jax.numpy as jnp

from pose_refine import geometry, mesh
from pose_refine import icp as icp_mod
import pose_refine.ops.rasterize as R
from pose_refine.ops.depth_to_cloud import depth_to_cloud
from pose_refine.scene.nn import SceneNN
from pose_refine.utils.metrics import rotation_angle_deg


def run(smoke: bool = False):
    if smoke:
        W, H = 160, 120
        model = mesh.make_icosphere(radius=60.0, subdivisions=3)
        K = geometry.LINEMOD_K.copy()
        K[:2] *= 0.25
    else:
        W, H = 640, 480
        model = mesh.load_benchmark_model()
        K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, W, H)

    # test.cpp:29-44 poses
    R_ren = np.array([[0.34768538, 0.93761126, 0.0],
                      [0.70540612, -0.26157897, -0.65877056],
                      [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    ang = np.float32(10.0 / 180.0 * 3.14)
    rot = np.asarray(geometry.euler_to_rotation(np.array([ang, ang, ang])))
    pose1 = np.asarray(geometry.pose_from_Rt(
        R_ren, np.array([0, 0, 300], np.float32)))
    pose2 = np.asarray(geometry.pose_from_Rt(
        rot @ R_ren, np.array([20, 20, 320], np.float32)))

    tris = jnp.asarray(model.tris)
    deps = np.asarray(R.render(tris, jnp.asarray(np.stack([pose1, pose2])),
                               W, H, proj))
    cloud, valid, _ = depth_to_cloud(deps[0], K, max_points=32768)
    cloud = np.asarray(cloud)
    valid = np.asarray(valid)
    scene = SceneNN.from_depth(deps[1], K, backend="bruteforce")

    # ours: point-to-plane from identity on the already-posed clouds
    res, _ = icp_mod.icp_point_to_plane(
        jnp.asarray(cloud), jnp.asarray(valid), scene.query)
    T_ours = np.asarray(res.transformation)
    fit_ours = float(res.fitness)
    rmse_ours = float(res.inlier_rmse)

    # Open3D leg, exactly test.cpp:96-126: raw clouds, EstimateNormals,
    # 0.1 max-correspondence, identity init, point-to-plane
    mp = o3d.geometry.PointCloud(
        o3d.utility.Vector3dVector(cloud[valid].astype(np.float64)))
    sp = o3d.geometry.PointCloud(
        o3d.utility.Vector3dVector(np.asarray(scene.points, np.float64)))
    mp.estimate_normals()
    sp.estimate_normals()
    reg = o3d.pipelines.registration.registration_icp(
        mp, sp, 0.1, np.eye(4),
        o3d.pipelines.registration.TransformationEstimationPointToPlane())
    T_o3d = np.asarray(reg.transformation)

    dR = rotation_angle_deg(T_ours, T_o3d)
    dt = np.linalg.norm(T_ours[:3, 3] - T_o3d[:3, 3]) * 1000.0
    print(f"ours : fitness {fit_ours:.4f} rmse {rmse_ours:.6f}")
    print(f"open3d: fitness {reg.fitness:.4f} rmse {reg.inlier_rmse:.6f}")
    print(f"transform delta: {float(dR):.3f} deg / {dt:.3f} mm")
    ok = float(dR) < 2.0 and dt < 5.0 and abs(fit_ours - reg.fitness) < 0.15
    print("CROSS-CHECK", "OK" if ok else "DISAGREES")
    return ok


if __name__ == "__main__":
    ok = run(smoke="smoke" in sys.argv[1:])
    sys.exit(0 if ok else 1)
