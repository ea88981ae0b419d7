"""TrackingSession: the productized per-frame loop (predict -> belief
hypotheses -> fused track(with_covariance=True) -> rank -> gated fusion).

Mirrors the reference's acceptance loop shape (test.cpp:29-44: jitter
hypotheses around the last estimate, refine, keep the best) with the
filter layered on top."""

import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh
from tests.test_icp import reference_demo_poses

W, H = 160, 120


@pytest.fixture(scope="module")
def setup():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    return m, K, r


def _refiner(m, K):
    return prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                           use_pallas=False, window=64, stride=1)


def _drift(truth, rng, rot=0.02, trans=3.0):
    d = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-rot, rot, 3).astype(np.float32)))
    return np.asarray(geometry.pose_from_Rt(
        d @ truth[:3, :3],
        truth[:3, 3] + rng.uniform(-trans, trans, 3).astype(np.float32)))


def test_session_tracks_drifting_object(setup):
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  seed=1)
    rng = np.random.default_rng(7)
    truth = pose2.copy()
    for frame in range(5):
        truth = _drift(truth, rng)
        depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        step = session.step(depth)
        assert step.accepted, f"frame {frame}: clean frame rejected"
        assert step.fitness > 0.7
        assert step.refined.shape == (3, 4, 4)
        assert step.covariance.shape == (6, 6)
        t_err = np.abs(step.pose[:3, 3] - truth[:3, 3]).max()
        assert t_err < 6.0, f"frame {frame}: lost track ({t_err} mm)"
    assert session.n_frames == 5 and session.n_rejected == 0
    np.testing.assert_array_equal(session.pose, step.pose)


def test_session_rejects_corrupt_frame(setup):
    """A dropout-corrupted frame must fail the fitness gate and leave the
    estimate at the prediction (random walk: the pre-step pose)."""
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=2,
                                  seed=2)
    rng = np.random.default_rng(11)
    truth = pose2.copy()
    depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
    assert session.step(depth).accepted

    before = session.pose.copy()
    corrupt = depth * (rng.random(depth.shape) < 0.03).astype(np.int32)
    step = session.step(corrupt)
    assert not step.accepted
    assert step.fitness < 0.6
    assert session.n_rejected == 1
    # random-walk prediction leaves the mean untouched on rejection
    np.testing.assert_array_equal(step.pose, before)

    # the loop recovers on the next clean frame
    assert session.step(depth).accepted


def test_session_cold_start_needs_matching_init_cov(setup):
    """Cold-start acquisition: initializing the session at the reference
    acceptance perturbation (10 deg/axis + 20 mm off truth, test.cpp:29-44)
    is ~3.4 sigma outside the default diffuse prior (5 deg / 20 mm), so the
    chi-square innovation gate rejects the (perfectly good) first
    refinement BY DESIGN - wrong-basin protection cannot distinguish a bad
    measurement from a bad prior. The documented recipe is to pass an
    init_cov as wide as the detector's actual error; then frame 0 is
    accepted and the fused pose lands on truth."""
    m, K, r = setup
    pose1, pose2, _ = reference_demo_poses()
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    # default tight prior: refinement jumps ~17 deg -> gated out
    tight = prt.TrackingSession(_refiner(m, K), pose1, n_hypotheses=2,
                                seed=3)
    step = tight.step(depth)
    assert not step.accepted and tight.n_rejected == 1
    np.testing.assert_array_equal(step.pose, pose1)  # prediction kept

    # prior that admits the detector error: accepted, converged
    wide = prt.TrackingSession(
        _refiner(m, K), pose1, n_hypotheses=2, seed=3,
        init_cov=np.diag([0.12**2] * 3 + [0.03**2] * 3))
    step = wide.step(depth)
    assert step.accepted and step.fitness > 0.7
    R_err = step.pose[:3, :3] @ pose2[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 4.0, f"cold start failed to converge ({ang} deg)"
    assert np.abs(step.pose[:3, 3] - pose2[:3, 3]).max() < 6.0


def test_session_resume_bit_exact(setup):
    """state_dict/from_state resumes the exact loop: same frames in, same
    poses out, bit for bit (incl. the hypothesis rng stream)."""
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    refiner = _refiner(m, K)
    rng = np.random.default_rng(3)
    truth = pose2.copy()
    frames = []
    for _ in range(5):
        truth = _drift(truth, rng)
        frames.append(np.asarray(r.render_depth(truth))[0].astype(np.int32))

    session = prt.TrackingSession(refiner, pose2, n_hypotheses=3, seed=5,
                                  max_innovation=(0.5, 0.05))
    for f in frames[:3]:
        session.step(f)
    state = session.state_dict()
    ref_poses = [session.step(f).pose for f in frames[3:]]

    resumed = prt.TrackingSession.from_state(refiner, state)
    assert resumed.n_frames == 3
    assert resumed.max_innovation == (0.5, 0.05)
    for f, want in zip(frames[3:], ref_poses):
        got = resumed.step(f).pose
        np.testing.assert_array_equal(got, want)


def test_session_constant_velocity_mode(setup):
    """constant_velocity keeps tracking fast smooth motion (the regime the
    fusion study measured random walk degrading in)."""
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  motion="constant_velocity", seed=4)
    truth = pose2.copy()
    for frame in range(5):
        truth = np.asarray(geometry.pose_from_Rt(
            truth[:3, :3], truth[:3, 3] + np.float32([4.0, 3.0, 0.0])))
        depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        step = session.step(depth)
        t_err = np.abs(step.pose[:3, 3] - truth[:3, 3]).max()
        assert t_err < 6.0, f"frame {frame}: lost track ({t_err} mm)"


def test_session_multi_model(setup):
    """MultiModelRefiner sessions pin every hypothesis to one model id."""
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    refiner = prt.MultiModelRefiner([m, m], K=K, width=W, height=H,
                                    max_points=4096, use_pallas=False,
                                    window=64, stride=1)
    session = prt.TrackingSession(refiner, pose2, n_hypotheses=2, seed=6)
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    with pytest.raises(ValueError, match="model_id"):
        session.step(depth)
    step = session.step(depth, model_id=1)
    assert step.accepted and step.fitness > 0.7


def _composite(*depths):
    """Min-nonzero depth composite: several objects in one sensor frame."""
    out = np.zeros_like(depths[0])
    for d in depths:
        take = (d > 0) & ((out == 0) | (d < out))
        out = np.where(take, d, out)
    return out


@pytest.fixture(scope="module")
def multi_setup():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    bumpy = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    ico = mesh.make_icosphere(radius=30.0, subdivisions=3)
    r_a = prt.PoseRenderer(bumpy, K=K, width=W, height=H, backend="dense")
    r_b = prt.PoseRenderer(ico, K=K, width=W, height=H, backend="dense")
    refiner = prt.MultiModelRefiner([bumpy, ico], K=K, width=W, height=H,
                                    max_points=8192, use_pallas=False,
                                    window=96, stride=1)
    _, pose2, _ = reference_demo_poses()
    pose_a = pose2.copy()
    pose_a[:3, 3] = [-45.0, 0.0, 300.0]
    pose_b = pose2.copy()
    pose_b[:3, 3] = [45.0, 0.0, 300.0]
    return refiner, r_a, r_b, pose_a, pose_b


def test_multi_object_session_tracks_both(multi_setup):
    """Two objects of different meshes, one fused dispatch per frame."""
    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=1)
    rng = np.random.default_rng(13)
    truth_a, truth_b = pose_a.copy(), pose_b.copy()
    for frame in range(4):
        truth_a = _drift(truth_a, rng, rot=0.015, trans=2.0)
        truth_b = _drift(truth_b, rng, rot=0.015, trans=2.0)
        depth = _composite(
            np.asarray(r_a.render_depth(truth_a))[0].astype(np.int32),
            np.asarray(r_b.render_depth(truth_b))[0].astype(np.int32))
        steps = session.step(depth)
        assert len(steps) == 2
        for step, truth in zip(steps, (truth_a, truth_b)):
            assert step.accepted
            assert step.refined.shape == (3, 4, 4)
            t_err = np.abs(step.pose[:3, 3] - truth[:3, 3]).max()
            assert t_err < 6.0, f"frame {frame}: lost an object ({t_err} mm)"
    np.testing.assert_array_equal(
        session.poses, np.stack([steps[0].pose, steps[1].pose]))


def test_multi_object_per_object_gating(multi_setup):
    """One object vanishing from the frame must reject ONLY its own
    measurement; the other keeps fusing."""
    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=2, seed=2)
    full = _composite(
        np.asarray(r_a.render_depth(pose_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32))
    steps = session.step(full)
    assert steps[0].accepted and steps[1].accepted

    before_a = session.trackers[0].pose_mm.copy()
    only_b = np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32)
    steps = session.step(only_b)
    assert not steps[0].accepted and steps[0].fitness < 0.6
    assert steps[1].accepted
    np.testing.assert_array_equal(steps[0].pose, before_a)


def test_multi_object_resume_bit_exact(multi_setup):
    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    depth = _composite(
        np.asarray(r_a.render_depth(pose_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32))
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=3)
    session.step(depth)
    state = session.state_dict()
    want = [s.pose for s in session.step(depth)]
    resumed = prt.MultiObjectSession.from_state(refiner, state)
    got = [s.pose for s in resumed.step(depth)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_multi_object_validation(setup, multi_setup):
    m, K, _ = setup
    refiner, _, _, pose_a, pose_b = multi_setup
    with pytest.raises(ValueError, match="MultiModelRefiner"):
        prt.MultiObjectSession(_refiner(m, K), [(0, pose_a)])
    with pytest.raises(ValueError, match="at least one"):
        prt.MultiObjectSession(refiner, [])
    with pytest.raises(ValueError, match="out of range"):
        prt.MultiObjectSession(refiner, [(2, pose_a)])
    session = prt.MultiObjectSession(refiner, [(0, pose_a), (1, pose_b)])
    with pytest.raises(ValueError, match="motions"):
        session.step(np.zeros((H, W), np.int32), motions_mm=[None])


def test_session_validation(setup):
    m, K, _ = setup
    _, pose2, _ = reference_demo_poses()
    with pytest.raises(ValueError, match="motion"):
        prt.TrackingSession(_refiner(m, K), pose2, motion="warp")
    with pytest.raises(ValueError, match="n_hypotheses"):
        prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=0)
    session = prt.TrackingSession(_refiner(m, K), pose2)
    with pytest.raises(ValueError, match="model_id"):
        session.step(np.zeros((H, W), np.int32), model_id=0)


def test_session_npz_roundtrip(setup, tmp_path):
    """utils.serialization persists a TrackingSession to one .npz and
    load(path, refiner=...) resumes the exact loop (the advertised
    checkpoint path must actually exist)."""
    from pose_refine.utils import serialization

    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    refiner = _refiner(m, K)
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    session = prt.TrackingSession(refiner, pose2, n_hypotheses=2, seed=9,
                                  max_innovation=(0.5, 0.05))
    session.step(depth)
    p = str(tmp_path / "session.npz")
    serialization.save(p, session)
    want = session.step(depth).pose

    with pytest.raises(ValueError, match="refiner"):
        serialization.load(p)
    resumed = serialization.load(p, refiner=refiner)
    assert resumed.n_frames == 1
    assert resumed.max_innovation == (0.5, 0.05)
    np.testing.assert_array_equal(resumed.step(depth).pose, want)


def test_multi_session_npz_roundtrip(multi_setup, tmp_path):
    from pose_refine.utils import serialization

    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    depth = _composite(
        np.asarray(r_a.render_depth(pose_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32))
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=2, seed=4)
    session.step(depth)
    p = str(tmp_path / "multi.npz")
    serialization.save(p, session)
    want = [s.pose for s in session.step(depth)]
    resumed = serialization.load(p, refiner=refiner)
    got = [s.pose for s in resumed.step(depth)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_from_state_validates_invariants(setup):
    """A corrupted/hand-edited state must error, not silently degrade
    (n_hypotheses=0 would resume as mean-only tracking)."""
    m, K, _ = setup
    _, pose2, _ = reference_demo_poses()
    refiner = _refiner(m, K)
    session = prt.TrackingSession(refiner, pose2, n_hypotheses=2)
    state = session.state_dict()
    bad = dict(state, n_hypotheses=0)
    with pytest.raises(ValueError, match="n_hypotheses"):
        prt.TrackingSession.from_state(refiner, bad)
    bad = dict(state, hypothesis_scale=-1.0)
    with pytest.raises(ValueError, match="hypothesis_scale"):
        prt.TrackingSession.from_state(refiner, bad)
    with pytest.raises(ValueError, match="hypothesis_scale"):
        prt.TrackingSession(refiner, pose2, hypothesis_scale=0.0)


def test_session_pipelined_step_async(setup):
    """step_async: one-frame-lagged results, identical filter ordering
    (predict at fuse time), flush() drains, and mixing without flush()
    raises instead of silently reordering the filter."""
    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  seed=1)
    rng = np.random.default_rng(7)
    truth = pose2.copy()
    truths, steps = [], []
    for frame in range(5):
        truth = _drift(truth, rng)
        truths.append(truth.copy())
        depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        step = session.step_async(depth)
        if frame == 0:
            assert step is None
            with pytest.raises(RuntimeError, match="flush"):
                session.state_dict()
            with pytest.raises(RuntimeError, match="flush"):
                session.step(depth)
        else:
            steps.append(step)
    steps.append(session.flush())
    assert session.flush() is None
    assert session.n_frames == 5 and len(steps) == 5
    for i, (step, truth) in enumerate(zip(steps, truths)):
        assert step.accepted, f"frame {i}: clean frame rejected"
        t_err = np.abs(step.pose[:3, 3] - truth[:3, 3]).max()
        assert t_err < 6.0, f"frame {i}: lost track ({t_err} mm)"
    # after flush, synchronous stepping works again
    assert session.step(np.asarray(r.render_depth(truth))[0].astype(
        np.int32)).accepted


def test_multi_object_pipelined_step_async(multi_setup):
    """MultiObjectSession.step_async: the pipelined twin of step() - one
    fused dispatch for ALL objects enqueued before the previous frame's
    fence; results lag one frame; filter ordering identical (per-tracker
    predict at fuse time); flush() drains; mixing without flush raises."""
    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=1)
    rng = np.random.default_rng(13)
    truth_a, truth_b = pose_a.copy(), pose_b.copy()
    truths, all_steps = [], []
    for frame in range(4):
        truth_a = _drift(truth_a, rng, rot=0.015, trans=2.0)
        truth_b = _drift(truth_b, rng, rot=0.015, trans=2.0)
        truths.append((truth_a.copy(), truth_b.copy()))
        depth = _composite(
            np.asarray(r_a.render_depth(truth_a))[0].astype(np.int32),
            np.asarray(r_b.render_depth(truth_b))[0].astype(np.int32))
        steps = session.step_async(depth)
        if frame == 0:
            assert steps is None
            with pytest.raises(RuntimeError, match="flush"):
                session.state_dict()
            with pytest.raises(RuntimeError, match="flush"):
                session.step(depth)
        else:
            all_steps.append(steps)
    all_steps.append(session.flush())
    assert session.flush() is None
    assert session.n_frames == 4 and len(all_steps) == 4
    for i, (steps, (ta, tb)) in enumerate(zip(all_steps, truths)):
        assert len(steps) == 2
        for step, truth in zip(steps, (ta, tb)):
            assert step.accepted, f"frame {i}: clean frame rejected"
            t_err = np.abs(step.pose[:3, 3] - truth[:3, 3]).max()
            assert t_err < 6.0, f"frame {i}: lost an object ({t_err} mm)"
    # after flush, synchronous stepping works again
    depth = _composite(
        np.asarray(r_a.render_depth(truth_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(truth_b))[0].astype(np.int32))
    assert all(s.accepted for s in session.step(depth))


def _assert_state_equal(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            _assert_state_equal(va, vb, f"{path}{k}.")
        elif isinstance(va, (list, tuple)) and va and isinstance(va[0], dict):
            assert len(va) == len(vb), f"{path}{k}"
            for i, (ea, eb) in enumerate(zip(va, vb)):
                _assert_state_equal(ea, eb, f"{path}{k}[{i}].")
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{path}{k}")
        else:
            assert va == vb, f"{path}{k}: {va} != {vb}"


def test_failed_step_does_not_mutate_session(setup):
    """A step()/step_async() call that fails validation must leave the
    session byte-identical (filter, hypothesis rng stream, frame count):
    otherwise a corrected retry samples a different stream than an
    error-free run, breaking the bit-exact-resume contract the
    serialization tests pin."""
    m, K, _ = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  seed=1)
    before = session.state_dict()
    depth = np.zeros((H, W), np.int32)
    with pytest.raises(ValueError, match="model_id"):
        session.step(depth, model_id=0)
    with pytest.raises(ValueError, match="model_id"):
        session.step_async(depth, model_id=0)
    assert session._inflight is None
    _assert_state_equal(before, session.state_dict())
    # failures the pre-checks CANNOT catch - track() itself rejects the
    # frame AFTER the filter predicted / the rng stream moved; the
    # snapshot+rollback must undo both (step) / the stream (step_async)
    bad = np.zeros((H, W, 3), np.int32)  # wrong ndim
    with pytest.raises(Exception):
        session.step(bad)
    with pytest.raises(Exception):
        session.step_async(bad)
    assert session._inflight is None
    _assert_state_equal(before, session.state_dict())


def test_failed_fuse_rolls_back_step_async(setup, monkeypatch):
    """step_async enqueues the NEW frame, then fuses the PREVIOUS one. If
    that fusion fails (e.g. LinAlgError inside the filter update), the full
    pre-call state must come back: rng stream, filter, and the pending
    previous frame - otherwise the enqueued result is silently dropped
    while the stream stays advanced."""
    import json as _json

    import pose_refine.tracking as tracking_mod

    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  seed=6)
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    assert session.step_async(depth) is None  # frame 1 now in flight

    rng_before = _json.dumps(session._rng.bit_generator.state)
    tracker_before = session.tracker.state_dict()
    inflight_before = session._inflight
    n_before = session.n_frames

    def boom(*a, **k):
        raise np.linalg.LinAlgError("synthetic fuse failure")

    monkeypatch.setattr(tracking_mod, "_fuse_ranked_best", boom)
    with pytest.raises(np.linalg.LinAlgError):
        session.step_async(depth)
    monkeypatch.undo()

    assert session._inflight is inflight_before  # pending frame re-installed
    assert _json.dumps(session._rng.bit_generator.state) == rng_before
    _assert_state_equal(tracker_before, session.tracker.state_dict())
    assert session.n_frames == n_before
    # the corrected retry replays the same stream and fuses frame 1
    step = session.step_async(depth)
    assert step is not None and step.accepted
    assert session.flush() is not None


def test_failed_fuse_rolls_back_multi_step_async(multi_setup, monkeypatch):
    """MultiObjectSession twin of the fuse-failure rollback."""
    import json as _json

    import pose_refine.tracking as tracking_mod

    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=3)
    depth = _composite(
        np.asarray(r_a.render_depth(pose_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32))
    assert session.step_async(depth) is None

    rng_before = _json.dumps(session._rng.bit_generator.state)
    trackers_before = [t.state_dict() for t in session.trackers]
    inflight_before = session._inflight
    n_before = session.n_frames

    def boom(*a, **k):
        raise np.linalg.LinAlgError("synthetic fuse failure")

    monkeypatch.setattr(tracking_mod, "_fuse_ranked_best", boom)
    with pytest.raises(np.linalg.LinAlgError):
        session.step_async(depth)
    monkeypatch.undo()

    assert session._inflight is inflight_before
    assert _json.dumps(session._rng.bit_generator.state) == rng_before
    for before, tracker in zip(trackers_before, session.trackers):
        _assert_state_equal(before, tracker.state_dict())
    assert session.n_frames == n_before
    steps = session.step_async(depth)
    assert steps is not None and all(s.accepted for s in steps)
    assert session.flush() is not None


def test_failed_flush_rolls_back(setup, monkeypatch):
    """flush() must carry the same atomic contract as step()/step_async():
    a failure during the final fuse (a failed readback, LinAlgError
    in the update) leaves the tracker untouched and the in-flight frame
    re-installed for a corrected retry - not predicted-but-not-updated
    with the frame discarded."""
    import json as _json

    import pose_refine.tracking as tracking_mod

    m, K, r = setup
    _, pose2, _ = reference_demo_poses()
    session = prt.TrackingSession(_refiner(m, K), pose2, n_hypotheses=3,
                                  seed=8)
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    assert session.step_async(depth) is None  # frame 1 in flight

    rng_before = _json.dumps(session._rng.bit_generator.state)
    tracker_before = session.tracker.state_dict()
    inflight_before = session._inflight
    n_before = session.n_frames

    def boom(*a, **k):
        raise np.linalg.LinAlgError("synthetic flush failure")

    monkeypatch.setattr(tracking_mod, "_fuse_ranked_best", boom)
    with pytest.raises(np.linalg.LinAlgError):
        session.flush()
    monkeypatch.undo()

    assert session._inflight is inflight_before
    assert _json.dumps(session._rng.bit_generator.state) == rng_before
    _assert_state_equal(tracker_before, session.tracker.state_dict())
    assert session.n_frames == n_before
    # corrected retry fuses the SAME pending frame
    step = session.flush()
    assert step is not None and step.accepted
    assert session.n_frames == n_before + 1


def test_failed_flush_rolls_back_multi(multi_setup, monkeypatch):
    """MultiObjectSession twin: a mid-list _fuse_all failure must not
    leave earlier trackers fused while later ones only predicted."""
    import json as _json

    import pose_refine.tracking as tracking_mod

    refiner, r_a, r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=9)
    depth = _composite(
        np.asarray(r_a.render_depth(pose_a))[0].astype(np.int32),
        np.asarray(r_b.render_depth(pose_b))[0].astype(np.int32))
    assert session.step_async(depth) is None

    trackers_before = [t.state_dict() for t in session.trackers]
    inflight_before = session._inflight
    n_before = session.n_frames

    calls = {"n": 0}
    real = tracking_mod._fuse_ranked_best

    def boom_second(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:  # first object fuses, second fails mid-list
            raise np.linalg.LinAlgError("synthetic mid-list failure")
        return real(*a, **k)

    monkeypatch.setattr(tracking_mod, "_fuse_ranked_best", boom_second)
    with pytest.raises(np.linalg.LinAlgError):
        session.flush()
    monkeypatch.undo()

    assert session._inflight is inflight_before
    for before, tracker in zip(trackers_before, session.trackers):
        _assert_state_equal(before, tracker.state_dict())
    assert session.n_frames == n_before
    steps = session.flush()
    assert steps is not None and all(s.accepted for s in steps)


def test_failed_step_does_not_mutate_multi_session(multi_setup):
    """The MultiObjectSession twin of the rollback contract: every
    tracker's filter AND the shared rng stream roll back when the fused
    dispatch rejects a frame after sampling."""
    refiner, _r_a, _r_b, pose_a, pose_b = multi_setup
    session = prt.MultiObjectSession(
        refiner, [(0, pose_a), (1, pose_b)], n_hypotheses=3, seed=2)
    before = session.state_dict()
    with pytest.raises(ValueError, match="motions"):
        session.step(np.zeros((H, W), np.int32), motions_mm=[None])
    bad = np.zeros((H, W, 3), np.int32)  # rejected inside track()
    with pytest.raises(Exception):
        session.step(bad)
    with pytest.raises(Exception):
        session.step_async(bad)
    assert session._inflight is None
    _assert_state_equal(before, session.state_dict())
