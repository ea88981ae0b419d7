"""Independent anchors for the ICP core.

The reference cross-validates against Open3D (test.cpp:96-126), which is not
installable here; the repo's other comparators (numpy oracle, C++ baseline)
share authorship with the code under test. These tests anchor the ICP math
to things that CANNOT inherit a common misreading:

  * analytic scenes - query() computes the closest point and normal of an
    exactly-known surface (the corner of three orthogonal planes) from
    closed-form geometry written in this file;
  * ground truth from the generative model - the expected transform is the
    one the points were synthesized with, not any implementation's output;
  * an independent float64 implementation of the TEXTBOOK point-to-plane
    normal equations (rows [cross(p,n), n], residual dot(q-p, n)),
    assembled in numpy in this file, against which the packed/matmul
    functors and the damped f32 solve are checked;
  * a calculus property - Gauss-Newton on exact correspondences converges
    quadratically: halving the perturbation quarters the one-step error.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pose_refine import geometry, icp


def corner_scene_query(src):
    """Closest point + normal on the corner {x=0} U {y=0} U {z=0}, picked per
    query as the plane with the smallest |distance|. Pure closed-form."""
    q = src
    dists = jnp.abs(q)  # (P, 3): |distance| to plane x=0, y=0, z=0
    plane = jnp.argmin(dists, axis=-1)  # (P,)
    n = jnp.eye(3, dtype=q.dtype)[plane]  # normal of the chosen plane
    dst = q - q * n  # zero the chosen coordinate
    valid = jnp.ones(q.shape[0], bool)
    return dst, n, valid


def corner_points(rng, n_per_plane=200, extent=0.3):
    """Points on the three planes, offset from the corner (rotation-observable)."""
    pts = []
    for axis in range(3):
        p = rng.uniform(0.05, extent, (n_per_plane, 3))
        p[:, axis] = 0.0
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def small_transform(theta, t_scale, rng):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    t = rng.normal(size=3)
    t = t / np.linalg.norm(t) * t_scale
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T.astype(np.float32)


def apply_T(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


def pose_error(T_est, T_true):
    """(rotation error rad, translation error m) of T_est vs T_true."""
    dR = T_est[:3, :3] @ T_true[:3, :3].T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    dt = np.linalg.norm(T_est[:3, 3] - T_true[:3, 3])
    return ang, dt


def run_icp(cloud, max_iter):
    res, _ = icp.icp_point_to_plane(
        jnp.asarray(cloud), jnp.ones(len(cloud), bool), corner_scene_query,
        icp.ICPConvergenceCriteria(0.0, 0.0, max_iter),  # never early-exit
        chunk_iters=max_iter + 1,
    )
    return np.asarray(res.transformation)


def test_full_icp_recovers_generative_transform():
    """Points synthesized ON the corner surface, displaced by a known small
    transform: full ICP must invert that transform (the ground truth comes
    from the generative model, not from any implementation)."""
    rng = np.random.default_rng(0)
    on_surface = corner_points(rng)
    T_true = small_transform(np.radians(2.0), 0.004, rng)
    # the cloud is the surface points moved AWAY; ICP must move them back
    cloud = apply_T(np.linalg.inv(T_true).astype(np.float32), on_surface)
    T_est = run_icp(cloud, max_iter=20)
    ang, dt = pose_error(T_est, T_true)
    assert ang < 2e-5 and dt < 2e-6, (ang, dt)


def test_one_step_gauss_newton_is_quadratic():
    """Calculus anchor: with exact correspondences, the one-iteration error
    of Gauss-Newton is O(theta^2) - scaling the perturbation by 1/4 must
    shrink the one-step error by ~1/16 (allowing margin)."""
    rng = np.random.default_rng(1)
    on_surface = corner_points(rng)
    errs = []
    for theta in (0.2, 0.05):
        T_true = small_transform(theta, theta * 0.02, rng)
        cloud = apply_T(np.linalg.inv(T_true).astype(np.float32), on_surface)
        T_est = run_icp(cloud, max_iter=1)
        ang, dt = pose_error(T_est, T_true)
        errs.append(ang + dt)
    # exact quadratic would give 16.0; damping + f32 leave margin
    assert errs[0] / max(errs[1], 1e-12) > 8.0, errs


@pytest.mark.parametrize("reduction", ["matmul", "packed"])
def test_normal_equations_match_independent_f64(reduction):
    """Both reduction variants against a from-scratch float64 assembly of
    the textbook point-to-plane normal equations written here."""
    rng = np.random.default_rng(2)
    P = 500
    cloud = rng.uniform(-0.3, 0.3, (P, 3)).astype(np.float32)
    valid = rng.random(P) > 0.2

    fn = (icp._normal_equations if reduction == "matmul"
          else icp._normal_equations_packed)
    AtA, Atb, count, mse = fn(
        jnp.asarray(cloud), jnp.asarray(valid), corner_scene_query
    )

    # independent f64 assembly (textbook linearization)
    q = cloud.astype(np.float64)
    plane = np.argmin(np.abs(q), axis=1)
    n = np.eye(3)[plane]
    dst = q.copy()
    dst[np.arange(P), plane] = 0.0
    b = np.sum((dst - q) * n, axis=1)
    A = np.concatenate([np.cross(q, n), n], axis=1)
    w = valid.astype(np.float64)
    AtA_ref = (A * w[:, None]).T @ A
    Atb_ref = (A * w[:, None]).T @ b
    mse_ref = np.sum(np.sum((dst - q) ** 2, axis=1) * w)

    np.testing.assert_allclose(np.asarray(AtA), AtA_ref, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(Atb), Atb_ref, rtol=2e-5, atol=1e-7)
    assert int(count) == int(w.sum())
    np.testing.assert_allclose(float(mse), mse_ref, rtol=1e-5)

    # and the damped f32 solve against an f64 np.linalg.solve of the SAME
    # (independently assembled) system
    x = np.asarray(icp._solve_damped(jnp.asarray(AtA_ref, jnp.float32),
                                     jnp.asarray(Atb_ref, jnp.float32)))
    x_ref = np.linalg.solve(AtA_ref + 0.01 * np.eye(6), Atb_ref)
    np.testing.assert_allclose(x, x_ref, rtol=1e-4, atol=1e-7)


def test_twist_composition_matches_euler_f64():
    """geometry.twist_to_mat4 (the reference's Rz*Ry*Rx + t, icp.cpp:7-17)
    against a from-scratch f64 composition."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.uniform(-0.3, 0.3, 6)
        got = np.asarray(geometry.twist_to_mat4(jnp.asarray(x, jnp.float32)))
        a, b_, c = x[0], x[1], x[2]  # rx, ry, rz

        def rot(axis, th):
            c_, s = np.cos(th), np.sin(th)
            m = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            m[i, i] = c_; m[j, j] = c_
            m[i, j] = -s if axis != 1 else s
            m[j, i] = s if axis != 1 else -s
            return m

        R = rot(2, c) @ rot(1, b_) @ rot(0, a)
        np.testing.assert_allclose(got[:3, :3], R, atol=2e-6)
        np.testing.assert_allclose(got[:3, 3], x[3:], atol=1e-7)


def plane_scene_query(src):
    """Closest point + normal on the single plane z=0. Pure closed-form."""
    n = jnp.zeros_like(src).at[:, 2].set(1.0)
    dst = src * jnp.asarray([1.0, 1.0, 0.0], src.dtype)
    return dst, n, jnp.ones(src.shape[0], bool)


def test_pose_information_nullspace_on_plane():
    """A single plane constrains exactly 3 DOFs (t_z, rot_x, rot_y); the
    information matrix must be rank-3 with its null space spanning
    {rot_z, t_x, t_y} - closed-form structure, no implementation to agree
    with by accident."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    pts[:, 2] = 0.0
    info, sigma2, count = icp.pose_information(
        jnp.asarray(pts), jnp.ones(len(pts), bool), plane_scene_query
    )
    info = np.asarray(info, np.float64)
    assert int(count) == 500
    assert float(sigma2) < 1e-10  # exact correspondences: zero residual
    # rows/cols for rot_z (2), t_x (3), t_y (4) are identically zero:
    # J rows are [p_y, -p_x, 0, 0, 0, 1] for n = z
    for idx in (2, 3, 4):
        np.testing.assert_allclose(info[idx], 0.0, atol=1e-6)
    w = np.linalg.eigvalsh(info)
    assert np.all(w[:3] < 1e-6) and np.all(w[3:] > 1e-3)


def test_pose_covariance_matches_noise_level():
    """Gaussian depth noise sigma along the plane normal must come back as
    sigma2 ~ sigma^2 and var(t_z) ~ sigma^2 / n - the textbook Laplace
    approximation, checked against the generative model."""
    rng = np.random.default_rng(12)
    n_pts, sigma = 4000, 0.002
    pts = rng.uniform(-0.3, 0.3, (n_pts, 3))
    pts[:, 2] = rng.normal(0.0, sigma, n_pts)  # noisy height off z=0
    pts = pts.astype(np.float32)
    info, sigma2, count = icp.pose_information(
        jnp.asarray(pts), jnp.ones(n_pts, bool), plane_scene_query
    )
    assert abs(float(sigma2) - sigma**2) < 0.15 * sigma**2
    cov = np.asarray(icp.pose_covariance(info, sigma2))
    var_tz = cov[5, 5]
    expect = sigma**2 / n_pts
    assert abs(var_tz - expect) < 0.3 * expect
    # unconstrained directions come back huge, not NaN/inf
    assert np.isfinite(cov).all()
    assert cov[3, 3] > 1e3 * var_tz and cov[2, 2] > 1e3 * var_tz


def test_pose_information_full_rank_on_corner_and_vmap():
    """The corner scene constrains all 6 DOFs; pose_information must be
    full-rank there and compose with vmap (batched serving use)."""
    import jax

    rng = np.random.default_rng(13)
    pts = corner_points(rng)
    info, _, _ = icp.pose_information(
        jnp.asarray(pts), jnp.ones(len(pts), bool), corner_scene_query
    )
    w = np.linalg.eigvalsh(np.asarray(info, np.float64))
    assert w[0] > 1e-3  # smallest eigenvalue bounded away from zero

    batch = jnp.stack([jnp.asarray(pts), jnp.asarray(pts * 0.9)])
    valids = jnp.ones(batch.shape[:2], bool)
    infos, s2s, counts = jax.vmap(
        lambda c, v: icp.pose_information(c, v, corner_scene_query)
    )(batch, valids)
    assert infos.shape == (2, 6, 6) and s2s.shape == (2,)
    covs = icp.pose_covariance(infos, s2s)
    assert covs.shape == (2, 6, 6) and np.isfinite(np.asarray(covs)).all()
