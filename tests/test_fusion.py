"""SE(3) pose fusion filter (utils/fusion.py, beyond parity).

Anchors are analytic: the exp/log maps check against their defining series
and each other; the filter checks against scalar-Kalman closed forms
(variance 1/N shrink, per-axis weighting) that 6x6 block structure must
reproduce.
"""

import numpy as np
import pytest

from pose_refine import geometry
from pose_refine import icp as icp_mod
from pose_refine.utils import fusion
from pose_refine.utils.fusion import PoseTracker, se3_exp, se3_log


def test_se3_exp_log_roundtrip(rng):
    for _ in range(20):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        # log inverts exp only below pi - sample angles up to 3.0 rad
        w = axis * rng.uniform(0.0, 3.0)
        xi = np.concatenate([w, rng.uniform(-1.0, 1.0, 3)])
        np.testing.assert_allclose(se3_log(se3_exp(xi)), xi, atol=1e-9)
    # small-angle branch
    xi = np.array([1e-9, -2e-9, 1e-9, 0.01, -0.02, 0.03])
    np.testing.assert_allclose(se3_log(se3_exp(xi)), xi, atol=1e-12)


def test_se3_exp_is_rigid_and_matches_euler_to_first_order(rng):
    xi = np.array([0.01, -0.02, 0.015, 0.003, 0.001, -0.002])
    T = se3_exp(xi)
    R = T[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(R) - 1.0) < 1e-12
    # agrees with the solver's Euler composition to second order
    T_euler = np.asarray(geometry.twist_to_mat4(xi.astype(np.float32)))
    np.testing.assert_allclose(T, T_euler, atol=5e-4)


def _hat4(xi):
    H = np.zeros((4, 4))
    H[:3, :3] = fusion._skew(xi[:3])
    H[:3, 3] = xi[3:]
    return H


def test_se3_exp_log_match_scipy_matrix_functions(rng):
    """Authorship-independent anchor (the PARITY.md validation pattern):
    the hand-derived Rodrigues/V closed forms must equal scipy's GENERIC
    matrix exponential/logarithm of the 4x4 hat matrix, and the rotation
    block must equal scipy Rotation.from_rotvec - none of which share a
    line of math with fusion.py."""
    from scipy.linalg import expm, logm
    from scipy.spatial.transform import Rotation

    for mag in (1e-8, 1e-3, 0.5, 2.0, 3.05):
        for _ in range(4):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            xi = np.concatenate([axis * mag, rng.uniform(-1.0, 1.0, 3)])
            T = se3_exp(xi)
            np.testing.assert_allclose(T, expm(_hat4(xi)), atol=1e-9)
            np.testing.assert_allclose(
                T[:3, :3], Rotation.from_rotvec(xi[:3]).as_matrix(),
                atol=1e-12)
            # principal matrix log is real below pi; logm's precision
            # degrades approaching pi, hence the looser tolerance
            H = np.real(logm(T))
            anchor = np.array([H[2, 1], H[0, 2], H[1, 0],
                               H[0, 3], H[1, 3], H[2, 3]])
            np.testing.assert_allclose(se3_log(T), anchor, atol=1e-6)


def test_se3_adjoint_matches_conjugation(rng):
    """Defining property pinning the [omega, v] twist ordering:
    T exp(xi) T^-1 == exp(Ad_T xi) for arbitrary T and xi."""
    from pose_refine.utils.fusion import se3_adjoint

    for _ in range(10):
        T = se3_exp(rng.uniform(-1.0, 1.0, 6))
        xi = rng.uniform(-0.5, 0.5, 6)
        lhs = T @ se3_exp(xi) @ np.linalg.inv(T)
        rhs = se3_exp(se3_adjoint(T) @ xi)
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_se3_log_rejects_pi_rotation():
    T = np.eye(4)
    T[:3, :3] = np.diag([1.0, -1.0, -1.0])  # 180 deg about x
    with pytest.raises(ValueError, match="180"):
        se3_log(T)


def _random_pose_mm(rng):
    w = rng.uniform(-0.5, 0.5, 3)
    T = se3_exp(np.concatenate([w, np.zeros(3)]))
    T[:3, 3] = rng.uniform(-50, 50, 3) + np.array([0, 0, 300.0])
    return T.astype(np.float32)


def test_static_fusion_variance_shrinks_as_1_over_n(rng):
    """With Q=0 and identical R the filter is a running average: after N
    updates P == R/N (exact for the linear error-state; tiny curvature
    slack allowed) and the pose error beats a single measurement."""
    truth = _random_pose_mm(rng)
    std_rot, std_t = np.radians(1.0), 0.004
    R = np.diag([std_rot**2] * 3 + [std_t**2] * 3)
    tracker = PoseTracker(truth, init_cov=R, process_noise=np.zeros((6, 6)))
    # init at the truth + one measurement-noise draw, like a first frame
    n_meas = 15
    errs = []
    for _ in range(n_meas):
        xi = np.concatenate(
            [rng.normal(0, std_rot, 3), rng.normal(0, std_t, 3)]
        )
        meas = (se3_exp(xi) @ tracker._to_m(truth))
        meas[:3, 3] *= 1000.0
        errs.append(np.linalg.norm(xi))
        assert tracker.update(meas.astype(np.float32), R)
    expect_P = R / (n_meas + 1)  # prior counts as one measurement
    np.testing.assert_allclose(tracker.P, expect_P, rtol=0.05)
    fused_err = np.linalg.norm(
        se3_log(tracker._to_m(tracker.pose_mm) @ np.linalg.inv(tracker._to_m(truth)))
    )
    assert fused_err < np.mean(errs) * 0.6


def test_anisotropic_measurement_weights_per_axis(rng):
    """A measurement that is tight in translation but useless in rotation
    must update translation variance only - the 6x6 filter reduces to
    independent scalar Kalman updates for diagonal matrices."""
    truth = _random_pose_mm(rng)
    P0 = np.diag([np.radians(5.0) ** 2] * 3 + [0.02**2] * 3)
    R = np.diag([1e6] * 3 + [0.001**2] * 3)  # rotation-blind, mm-tight
    tracker = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    assert tracker.update(truth, R, gate_chi2=None)
    # translation variance collapses to ~R_t (prior 20 mm >> meas 1 mm)
    assert np.all(np.diag(tracker.P)[3:] < 1.1 * 0.001**2)
    # rotation variance keeps the prior (measurement carries no info)
    np.testing.assert_allclose(
        np.diag(tracker.P)[:3], np.diag(P0)[:3], rtol=1e-3
    )


def test_innovation_gate_rejects_wrong_basin(rng):
    truth = _random_pose_mm(rng)
    R = np.diag([np.radians(0.5) ** 2] * 3 + [0.002**2] * 3)
    tracker = PoseTracker(truth, init_cov=R, process_noise=np.zeros((6, 6)))
    # an ICP that latched 30 degrees off
    bad = se3_exp(np.array([0.5, 0.0, 0.2, 0.05, 0.0, 0.0])) @ tracker._to_m(truth)
    bad[:3, 3] *= 1000.0
    before = tracker.pose_mm.copy()
    assert not tracker.update(bad.astype(np.float32), R)
    assert tracker.n_rejected == 1
    np.testing.assert_array_equal(tracker.pose_mm, before)
    # a sane measurement still fuses
    assert tracker.update(truth, R)


def test_predict_grows_uncertainty_and_applies_motion(rng):
    truth = _random_pose_mm(rng)
    tracker = PoseTracker(
        truth, process_noise=(np.radians(2.0), 0.01)
    )
    P0 = tracker.P.copy()
    tracker.predict()
    np.testing.assert_allclose(
        np.diag(tracker.P - P0),
        [np.radians(2.0) ** 2] * 3 + [0.01**2] * 3,
        rtol=1e-9,
    )
    # external motion increment: pure +z 10 mm camera-frame shift
    shift = np.eye(4, dtype=np.float32)
    shift[2, 3] = 10.0
    before = tracker.pose_mm.copy()
    tracker.predict(T_motion_mm=shift)
    np.testing.assert_allclose(
        tracker.pose_mm[:3, 3], before[:3, 3] + [0, 0, 10.0], atol=1e-3
    )


def test_filter_is_chi2_consistent_under_rotating_motion(rng):
    """Monte-Carlo NEES consistency: with matched noise models the
    normalized estimation error e' P^-1 e must average ~6 (chi-square,
    6 dof). Runs under a steadily ROTATING motion model with anisotropic
    initial covariance, so a wrong adjoint transport in predict() (or any
    broken piece of the predict/update algebra) inflates NEES well past
    the gate below."""
    q_rot = np.radians(0.5)
    Q = np.diag([q_rot**2] * 3 + [0.001**2] * 3)
    # ANISOTROPIC translation measurement noise (30 / 0.3 / 3 mm std):
    # steady-state P inherits the anisotropy, so the 30 deg/frame yaw
    # below keeps exercising the covariance transport - with the adjoint
    # replaced by identity this scenario measures NEES ~15, not ~6
    r_rot = np.radians(1.0)
    R = np.diag([r_rot**2] * 3 + [0.03**2, 0.0003**2, 0.003**2])
    # known per-frame motion: 30 deg yaw + 2 mm drift
    Tm = se3_exp([0.0, 0.0, np.radians(30.0), 0.002, 0.0, 0.001])
    Tm_mm = Tm.copy()
    Tm_mm[:3, 3] *= 1000.0

    def to_mm(T):
        out = T.copy()
        out[:3, 3] *= 1000.0
        return out

    nees = []
    for run in range(25):
        rr = np.random.default_rng(1000 + run)
        T_true = se3_exp(np.concatenate([rr.uniform(-0.3, 0.3, 3),
                                         [0.0, 0.0, 0.4]]))
        # anisotropic initial belief consistent with an initial error draw
        P0 = np.diag([np.radians(2.0) ** 2, np.radians(0.2) ** 2,
                      np.radians(1.0) ** 2, 1e-6, 4e-4, 1e-5])
        e0 = np.sqrt(np.diag(P0)) * rr.standard_normal(6)
        tracker = PoseTracker(to_mm(se3_exp(e0) @ T_true).astype(np.float32),
                              init_cov=P0, process_noise=Q)
        for _ in range(20):
            q = np.sqrt(np.diag(Q)) * rr.standard_normal(6)
            T_true = se3_exp(q) @ Tm @ T_true
            tracker.predict(T_motion_mm=Tm_mm)
            r = np.sqrt(np.diag(R)) * rr.standard_normal(6)
            meas = to_mm(se3_exp(r) @ T_true).astype(np.float32)
            tracker.update(meas, R, gate_chi2=None)
            e = se3_log(T_true @ np.linalg.inv(tracker._T))
            nees.append(float(e @ np.linalg.inv(tracker.P) @ e))
    mean_nees = float(np.mean(nees))
    # chi-square 6-dof mean is 6; float32 pose round-trips and the
    # correlated samples within a run widen the Monte-Carlo band
    # (measured: 6.76 correct, 14.87 with the adjoint zeroed out)
    assert 4.8 < mean_nees < 8.6, f"filter inconsistent: NEES {mean_nees:.2f}"


def test_gate_rejects_180_deg_flip_instead_of_crashing(rng):
    """A refinement that latched onto a 180-deg-flipped basin (the log's
    non-unique point) must be gate-rejected, not raise from se3_log."""
    truth = _random_pose_mm(rng)
    R = np.diag([np.radians(0.5) ** 2] * 3 + [0.002**2] * 3)
    tracker = PoseTracker(truth, init_cov=R, process_noise=np.zeros((6, 6)))
    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # 180 deg about x
    bad = (flip @ tracker._to_m(truth)).astype(np.float64)
    bad[:3, 3] *= 1000.0
    before = tracker.pose_mm.copy()
    assert not tracker.update(bad.astype(np.float32), R)
    assert tracker.n_rejected == 1
    np.testing.assert_array_equal(tracker.pose_mm, before)
    # with gating explicitly disabled the ambiguity still surfaces loudly
    with np.testing.assert_raises(ValueError):
        tracker.update(bad.astype(np.float32), R, gate_chi2=None)


def test_predict_motion_transports_covariance_through_adjoint(rng):
    """An external motion increment must conjugate P by its adjoint: a
    90-deg camera yaw swaps which translation axis carries the variance."""
    from pose_refine.utils.fusion import se3_adjoint

    truth = _random_pose_mm(rng)
    # tight in t_x, loose in t_y
    P0 = np.diag([1e-6] * 3 + [1e-8, 1e-2, 1e-8])
    tracker = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    yaw = np.asarray(se3_exp([0.0, 0.0, np.pi / 2, 0.0, 0.0, 0.0]))
    yaw_mm = yaw.copy()  # pure rotation: mm/m scaling is a no-op
    tracker.predict(T_motion_mm=yaw_mm)
    # variance moved from t_y to t_x
    assert tracker.P[3, 3] > 9e-3
    assert tracker.P[4, 4] < 1e-6
    np.testing.assert_allclose(
        tracker.P, se3_adjoint(yaw) @ P0 @ se3_adjoint(yaw).T, atol=1e-12
    )


def test_predict_cv_tracks_constant_motion_exactly(rng):
    """Under exactly constant-twist motion and (near-)noise-free
    measurements, predict_cv's prediction IS the next true pose - and it
    keeps coasting at that velocity through missed measurements. A
    random-walk predict() leaves the pose behind by one full motion step."""
    Tm = se3_exp([0.02, -0.05, 0.08, 0.003, -0.001, 0.002])

    def to_mm(T):
        out = np.asarray(T, np.float64).copy()
        out[:3, 3] *= 1000.0
        return out

    truth = se3_exp(np.concatenate([rng.uniform(-0.3, 0.3, 3),
                                    [0.0, 0.0, 0.4]]))
    tracker = PoseTracker(to_mm(truth))
    R_tiny = np.eye(6) * 1e-14
    # two frames of (noise-free) measurements teach the velocity
    for _ in range(2):
        truth = Tm @ truth
        tracker.predict_cv()
        assert tracker.update(to_mm(truth), R_tiny, gate_chi2=None)
    # now coast: predictions alone must follow the constant-twist truth
    for _ in range(3):
        truth = Tm @ truth
        pred = tracker.predict_cv()
        np.testing.assert_allclose(np.asarray(pred, np.float64),
                                   to_mm(truth), rtol=0, atol=2e-3)
    # decay=0 degenerates to the random walk (pose unchanged)
    pose_before = tracker._T.copy()
    tracker.predict_cv(decay=0.0)
    np.testing.assert_allclose(tracker._T, pose_before, atol=1e-15)


def test_gate_rejects_non_finite_measurement(rng):
    """A diverged refinement handing in a NaN pose must be gate-REJECTED
    ('nan > gate' is False - the gate tests acceptance, not rejection),
    never fused into the filter state."""
    truth = _random_pose_mm(rng)
    R = np.diag([np.radians(0.5) ** 2] * 3 + [0.002**2] * 3)
    tracker = PoseTracker(truth, init_cov=R, process_noise=np.zeros((6, 6)))
    bad = truth.astype(np.float64).copy()
    bad[0, 3] = np.nan
    before = tracker.pose_mm.copy()
    assert not tracker.update(bad.astype(np.float32), R)
    assert tracker.n_rejected == 1
    np.testing.assert_array_equal(tracker.pose_mm, before)
    assert np.isfinite(tracker.P).all()


def test_hypotheses_sampling(rng):
    truth = _random_pose_mm(rng)
    tracker = PoseTracker(truth)
    hyp = tracker.hypotheses(8, seed=0)
    assert hyp.shape == (8, 4, 4)
    np.testing.assert_allclose(hyp[0], truth, atol=1e-3)
    # spread tracks the belief: wider P -> wider samples
    spread1 = np.std(hyp[1:, :3, 3], axis=0).mean()
    tracker.P *= 25.0
    hyp2 = tracker.hypotheses(8, seed=0)
    spread2 = np.std(hyp2[1:, :3, 3], axis=0).mean()
    assert spread2 > 3.0 * spread1
    # rotations stay valid
    for T in hyp2:
        R = T[:3, :3].astype(np.float64)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_fusion_consumes_pose_covariance(rng):
    """End-to-end with the uncertainty API: refine a synthetic cloud, take
    pose_information -> pose_covariance as the measurement noise, fuse.
    The fused pose must stay at the refined optimum and the filter
    variance must not exceed the measurement's."""
    pts = rng.uniform(-0.1, 0.1, size=(512, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    normals = rng.normal(size=(512, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    truth_xi = np.array([0.02, -0.01, 0.03, 0.01, -0.015, 0.01], np.float32)
    truth = np.asarray(geometry.twist_to_mat4(truth_xi))
    target = (pts @ truth[:3, :3].T + truth[:3, 3]).astype(np.float32)
    target += rng.normal(0, 5e-4, target.shape).astype(np.float32)

    import jax.numpy as jnp

    def query(src):
        return jnp.asarray(target), jnp.asarray(normals), jnp.ones(len(src), bool)

    valid = np.ones(len(pts), bool)
    result, moved = icp_mod.icp_point_to_plane(
        pts, valid, query, icp_mod.ICPConvergenceCriteria(max_iteration=40)
    )
    info, s2, _cnt = icp_mod.pose_information(moved, valid, query)
    R = np.asarray(icp_mod.pose_covariance(info, s2), np.float64)

    meas_mm = np.asarray(result.transformation).copy()
    meas_mm[:3, 3] *= 1000.0
    tracker = PoseTracker(meas_mm, init_cov=4.0 * R,
                          process_noise=np.zeros((6, 6)))
    assert tracker.update(meas_mm, R)
    # fused stays at the optimum; posterior tighter than the measurement
    np.testing.assert_allclose(tracker.pose_mm, meas_mm, atol=1e-3)
    assert np.trace(tracker.P) < np.trace(R)


def test_tracker_refiner_integration_loop(rng):
    """The documented serving loop end-to-end (PoseTracker docstring):
    constant-motion truth, predict_cv prior -> refiner.track ->
    pose_covariance measurement noise -> update. A wrong-basin
    'refinement' injected mid-track must be gate-rejected without
    derailing the track."""
    import jax.numpy as jnp

    import pose_refine as prt
    from pose_refine import mesh

    W, H = 160, 120
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)

    base = se3_exp([0.0, 0.0, np.radians(1.0), 0.001, 0.0005, 0.0])
    base_mm = base.copy()
    base_mm[:3, 3] *= 1000.0
    truth = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.float32([0, 0, 400])))

    probe = m.vertices[rng.choice(len(m.vertices), 512, replace=False)]

    def meas_cov(pose_mm, depth):
        # track() does not touch refiner.scene - build the frame's scene
        scene = prt.SceneProjective.from_depth(jnp.asarray(depth), K)
        cam = (pose_mm[:3, :3] @ probe.T).T + pose_mm[:3, 3]
        info, s2, _ = icp_mod.pose_information(
            (cam / 1000.0).astype(np.float32),
            np.ones(len(cam), bool), scene.query)
        return np.asarray(icp_mod.pose_covariance(info, s2), np.float64)

    tracker = None
    errs = []
    for frame in range(6):
        truth = (base_mm @ truth).astype(np.float32)
        d = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        if tracker is None:
            prior = truth  # perfect init on frame 0, like the demo
        else:
            tracker.predict_cv()
            prior = tracker.pose_mm
        refined, res = refiner.track(d, prior)
        best = np.asarray(refined)
        if tracker is None:
            tracker = PoseTracker(best,
                                  process_noise=(np.radians(0.5), 0.0015))
        else:
            if frame == 3:  # a refinement that latched onto a wrong basin
                bad = best.copy()
                bad[:3, :3] = np.asarray(geometry.euler_to_rotation(
                    np.float32([0.6, 0, 0]))) @ bad[:3, :3]
                assert not tracker.update(bad, meas_cov(bad, d))
            assert tracker.update(best, meas_cov(best, d))
        errs.append(float(
            np.degrees(np.arccos(np.clip(
                (np.trace(tracker.pose_mm[:3, :3] @ truth[:3, :3].T) - 1) / 2,
                -1, 1)))))
    assert tracker.n_rejected == 1
    assert max(errs) < 4.0, f"tracking errors {errs}"
    t_err = np.abs(tracker.pose_mm[:3, 3] - truth[:3, 3]).max()
    assert t_err < 6.0, f"translation off by {t_err} mm"


def test_predict_cv_survives_180_deg_increment(rng):
    """A basin flip fused with gating disabled leaves a ~180-deg one-frame
    increment; the next predict_cv must degrade to a random walk (velocity
    unobservable at the log's branch point), not crash the loop."""
    truth = _random_pose_mm(rng)
    tracker = PoseTracker(truth, init_cov=np.eye(6) * 1e-4,
                          process_noise=np.zeros((6, 6)))
    # 90-deg motion in predict + a 90-deg fused correction composes to a
    # one-frame increment of EXACTLY 180 deg from the baseline, while
    # update()'s own innovation stays well below the log's branch point
    yaw90 = se3_exp([np.pi / 2, 0.0, 0.0, 0.0, 0.0, 0.0])
    tracker.predict(T_motion_mm=yaw90)  # baseline = truth, pure rotation
    m = se3_exp([np.pi, 0.0, 0.0, 0.0, 0.0, 0.0]) @ tracker._to_m(truth)
    m_mm = m.copy()
    m_mm[:3, 3] *= 1000.0
    assert tracker.update(m_mm, np.eye(6) * 1e-14, gate_chi2=None)
    before = tracker._T.copy()
    tracker.predict_cv()  # must not raise
    np.testing.assert_allclose(tracker._T, before, atol=1e-12)


def test_from_state_validates_t_prev():
    truth = np.eye(4, dtype=np.float32)
    truth[2, 3] = 300.0
    tracker = PoseTracker(truth)
    state = tracker.state_dict()
    state["T_prev"] = np.zeros((3, 4))
    with pytest.raises(ValueError, match="T_prev"):
        PoseTracker.from_state(state)


def test_max_innovation_hard_cap_catches_inflated_covariance(rng):
    """A failed refinement on a degraded frame reports an INFLATED
    covariance from that same frame, widening its own chi-square gate
    (measured in the fusion study: a 21 mm slip gate-passed). The hard
    physical cap rejects it regardless of the claimed covariance."""
    truth = _random_pose_mm(rng)
    P0 = np.diag([np.radians(0.5) ** 2] * 3 + [0.002**2] * 3)
    tracker = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    # outlier: 20 deg / 30 mm off, claiming a huge (1 rad, 0.3 m) noise
    bad = se3_exp([0.35, 0.0, 0.0, 0.0, 0.03, 0.0]) @ tracker._to_m(truth)
    bad[:3, 3] *= 1000.0
    R_inflated = np.diag([1.0] * 3 + [0.09] * 3)
    # the chi-square gate ALONE is fooled (S is dominated by R_inflated)
    probe = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    assert probe.update(bad.astype(np.float32), R_inflated)
    # the hard cap is not
    cap = (np.radians(10.0), 0.010)
    assert not tracker.update(bad.astype(np.float32), R_inflated,
                              max_innovation=cap)
    assert tracker.n_rejected == 1
    # a sane measurement still fuses under the same cap
    assert tracker.update(truth, P0, max_innovation=cap)
    # and the cap works with the chi-square gate disabled
    solo = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    assert not solo.update(bad.astype(np.float32), R_inflated,
                           gate_chi2=None, max_innovation=cap)


def test_quality_gate(rng):
    """The fitness gate is an INDEPENDENT acceptance signal: a refinement
    on a corrupted frame can inflate its own covariance past both
    statistical gates, but it cannot fake the inlier fraction (measured
    in the fusion study: corrupt frames score 0.07-0.15 vs >=0.835
    clean). Reject-unless-provably-inside like the other gates."""
    truth = _random_pose_mm(rng)
    P0 = np.diag([np.radians(0.5) ** 2] * 3 + [0.002**2] * 3)
    tracker = PoseTracker(truth, init_cov=P0, process_noise=np.zeros((6, 6)))
    T_before = tracker.pose_mm.copy()

    # low quality rejects, state untouched
    assert not tracker.update(truth, P0, quality=0.15, min_quality=0.6)
    assert tracker.n_rejected == 1
    np.testing.assert_array_equal(tracker.pose_mm, T_before)

    # NaN quality rejects (a diverged refinement must not fuse)
    assert not tracker.update(truth, P0, quality=float("nan"),
                              min_quality=0.6)
    assert tracker.n_rejected == 2

    # good quality fuses; no quality args = previous behavior
    assert tracker.update(truth, P0, quality=0.9, min_quality=0.6)
    assert tracker.update(truth, P0)

    # min_quality without a quality value is a usage error
    with pytest.raises(ValueError, match="quality"):
        tracker.update(truth, P0, min_quality=0.6)
