import jax.numpy as jnp
import numpy as np

from pose_refine import geometry


def test_euler_roundtrip(rng):
    theta = rng.uniform(-1.2, 1.2, size=(16, 3)).astype(np.float32)
    R = geometry.euler_to_rotation(theta)
    # orthonormality
    eye = jnp.einsum("...ij,...kj->...ik", R, R)
    np.testing.assert_allclose(np.asarray(eye), np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-5)
    back = geometry.rotation_to_euler(R)
    np.testing.assert_allclose(np.asarray(back), theta, atol=1e-5)


def test_euler_matches_component_matrices(rng):
    # Rz @ Ry @ Rx composition, as helper.h:187-209
    t = rng.uniform(-1, 1, size=3).astype(np.float32)

    def rx(a):
        return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])

    def ry(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])

    def rz(a):
        return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    expected = rz(t[2]) @ ry(t[1]) @ rx(t[0])
    got = np.asarray(geometry.euler_to_rotation(t))
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_compute_proj_values():
    # spot-check against hand-evaluated reference formulas (renderer.cpp:161-185)
    K = geometry.LINEMOD_K
    p = np.asarray(geometry.compute_proj(K, 640, 480))
    assert np.isclose(p[0, 0], 2 * 572.4114 / 640)
    assert np.isclose(p[0, 2], 2 * 325.2611 / 640 - 1)
    assert np.isclose(p[1, 1], -2 * 573.57043 / 480)
    assert np.isclose(p[1, 2], 1 - 2 * 242.04899 / 480)
    assert np.isclose(p[2, 2], (10000 + 10) / (10000 - 10))
    assert np.isclose(p[2, 3], -2 * 10000 * 10 / (10000 - 10))
    assert np.allclose(p[3], [0, 0, 1, 0])


def test_pcd_dep_roundtrip(rng):
    K = geometry.LINEMOD_K
    # random pixels and depths
    x = rng.integers(0, 640, size=200)
    y = rng.integers(0, 480, size=200)
    d = rng.integers(200, 2000, size=200)
    pts = geometry.dep2pcd(x, y, d, K)
    xyd = np.asarray(geometry.pcd2dep(pts, K))
    np.testing.assert_array_equal(xyd[:, 0], x)
    np.testing.assert_array_equal(xyd[:, 1], y)
    np.testing.assert_array_equal(xyd[:, 2], d)


def test_dep2pcd_zero_depth():
    K = geometry.LINEMOD_K
    p = np.asarray(geometry.dep2pcd(10, 20, 0, K))
    np.testing.assert_array_equal(p, np.zeros(3))


def test_twist_to_mat4_small_angles():
    v = jnp.array([0.01, -0.02, 0.03, 1.0, 2.0, 3.0], jnp.float32)
    T = np.asarray(geometry.twist_to_mat4(v))
    assert T.shape == (4, 4)
    np.testing.assert_allclose(T[:3, 3], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1])
    # small-angle approximation: R ~ I + skew([rx,ry,rz])
    skew = np.array([[0, -0.03, -0.02], [0.03, 0, -0.01], [0.02, 0.01, 0]])
    np.testing.assert_allclose(T[:3, :3], np.eye(3) + skew, atol=1e-3)


def test_transform_points_batched(rng):
    pts = rng.normal(size=(4, 10, 3)).astype(np.float32)
    theta = rng.uniform(-1, 1, size=(4, 3)).astype(np.float32)
    T = geometry.pose_from_Rt(geometry.euler_to_rotation(theta), rng.normal(size=(4, 3)).astype(np.float32))
    out = np.asarray(geometry.transform_points(T, pts))
    Tn = np.asarray(T)
    for i in range(4):
        expected = pts[i] @ Tn[i, :3, :3].T + Tn[i, :3, 3]
        np.testing.assert_allclose(out[i], expected, atol=1e-5)


def test_sample_hypotheses():
    from pose_refine.geometry import (
        pose_from_Rt, rotation_to_euler, sample_hypotheses,
    )

    center = np.asarray(pose_from_Rt(np.eye(3, dtype=np.float32),
                                     np.array([10, 20, 300], np.float32)))
    hyps = sample_hypotheses(center, 64, rot_deg=10, trans_mm=20, rng=0,
                             include_center=True)
    assert hyps.shape == (64, 4, 4) and hyps.dtype == np.float32
    np.testing.assert_allclose(hyps[0], center, atol=1e-6)  # include_center
    # translations inside the box, rotations inside the per-axis bound
    dt = hyps[:, :3, 3] - center[:3, 3]
    assert np.abs(dt).max() <= 20.0 + 1e-4
    for h in hyps[1:8]:
        eul = np.degrees(np.asarray(rotation_to_euler(h[:3, :3])))
        assert np.abs(eul).max() <= 10.0 + 1e-3
    # deterministic under a seed
    np.testing.assert_array_equal(
        hyps, sample_hypotheses(center, 64, rot_deg=10, trans_mm=20, rng=0,
                                include_center=True))
