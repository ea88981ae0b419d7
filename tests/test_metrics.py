"""ADD/ADD-S metric unit tests + the ADD implementation-parity regression:
our jitted ICP vs the native reference-algorithm baseline on identical
inputs must agree to the BASELINE north-star budget (1e-3 m = 1 mm)."""

import numpy as np
import pytest

import pose_refine.ops.rasterize as R
from pose_refine import geometry, icp as icp_mod, mesh, native
from pose_refine.ops.depth_to_cloud import depth_to_cloud
from pose_refine.scene.projective import SceneProjective
from pose_refine.utils.metrics import add_error, adds_error, rotation_angle_deg
from tests.test_icp import reference_demo_poses, small_K

W, H = 160, 120


def test_add_identity_and_translation():
    pts = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32) * 50
    T = np.eye(4, dtype=np.float32)
    assert add_error(T, T, pts) == 0.0
    T2 = T.copy()
    T2[:3, 3] = [3.0, 0.0, 4.0]
    np.testing.assert_allclose(add_error(T2, T, pts), 5.0, rtol=1e-12)
    # ADD-S <= ADD always; equal for pure translation of a degenerate cloud
    assert adds_error(T2, T, pts) <= add_error(T2, T, pts) + 1e-9


def test_adds_invariant_to_symmetry():
    """ADD-S forgives a rotation that maps the model point set to itself."""
    th = np.pi / 2
    Rz = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
        np.float64,
    )
    # 4-fold symmetric point set around z
    base = np.array([[10.0, 0, 5], [0, 10, 5], [-10, 0, 5], [0, -10, 5]])
    T_ref = np.eye(4)
    T_est = np.eye(4)
    T_est[:3, :3] = Rz
    assert add_error(T_est, T_ref, base) > 5.0
    assert adds_error(T_est, T_ref, base) < 1e-9


def test_batched_broadcasting():
    pts = np.random.default_rng(1).normal(size=(64, 3)) * 20
    T = np.tile(np.eye(4), (5, 1, 1))
    T[:, 0, 3] = np.arange(5)
    out = add_error(T, np.eye(4), pts)
    np.testing.assert_allclose(out, np.arange(5), atol=1e-12)
    assert rotation_angle_deg(T, np.eye(4)).shape == (5,)


@pytest.mark.skipif(not native.native_available(), reason="no native toolchain")
def test_add_implementation_parity_vs_reference_baseline():
    """North-star regression (BASELINE.json): refine the same clouds against
    the same scene with (a) our jitted ICP and (b) the C++ reference-algorithm
    baseline; the refined poses must agree to ADD <= 1 mm."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = small_K()
    proj = geometry.compute_proj(K, W, H)
    pose1, pose2, _ = reference_demo_poses()

    rng = np.random.default_rng(7)
    starts = []
    for _ in range(4):
        d = np.asarray(
            geometry.euler_to_rotation(rng.uniform(-0.08, 0.08, 3).astype(np.float32))
        )
        p = pose1.copy()
        p[:3, :3] = d @ pose1[:3, :3]
        p[:3, 3] += rng.uniform(-8, 8, 3).astype(np.float32)
        starts.append(p)
    starts = np.stack(starts)

    depth = np.asarray(R.rasterize_dense(m.tris, np.concatenate([pose1[None], starts]), W, H, proj))
    scene = SceneProjective.from_depth(depth[0], K)

    clouds, valids = [], []
    for i in range(len(starts)):
        c, v, _ = depth_to_cloud(depth[1 + i], K, max_points=8192)
        clouds.append(np.asarray(c))
        valids.append(np.asarray(v))
    clouds = np.stack(clouds)
    valids = np.stack(valids)

    res, _ = icp_mod.icp_point_to_plane_batch(clouds, valids, scene)
    T_ours = np.asarray(res.transformation)

    T_ref, fit_ref, _ = native.cpu_icp_baseline(
        clouds, valids, np.asarray(scene.pcd), np.asarray(scene.normal), K
    )

    # compare the refined POSES: left-compose each ICP result (mm-scaled)
    # onto the same starts, then ADD over the model vertices
    def compose(T_icp):
        T_mm = np.asarray(T_icp).copy()
        T_mm[:, :3, 3] *= 1000.0
        return np.einsum("nij,njk->nik", T_mm, starts)

    adds = add_error(compose(T_ours), compose(T_ref), m.vertices)
    assert np.isfinite(adds).all()
    assert adds.max() < 1.0, f"ADD parity broken: {adds} mm"
    np.testing.assert_allclose(
        np.asarray(res.fitness), fit_ref, atol=2e-3
    )
