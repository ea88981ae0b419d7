import os

import numpy as np

import pose_refine as prt
from pose_refine import geometry
from pose_refine.scene.kdtree import build_kdtree
from pose_refine.scene.nn import SceneNN
from pose_refine.scene.projective import SceneProjective
from pose_refine.utils import serialization


def _cloud(rng, n=500):
    pts = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def test_scene_nn_roundtrip(tmp_path, rng):
    pts, nrm = _cloud(rng)
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=0.05)
    p = str(tmp_path / "scene.npz")
    serialization.save(p, scene)
    back = serialization.load(p)
    assert isinstance(back, SceneNN)
    assert back.backend == scene.backend and back.leaf_cap == scene.leaf_cap
    q = rng.uniform(-0.1, 0.1, (50, 3)).astype(np.float32)
    q[:, 2] += 0.5
    d1, n1, v1 = scene.query(q)
    d2, n2, v2 = back.query(q)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_scene_projective_roundtrip(tmp_path, rng):
    K = geometry.LINEMOD_K
    depth = np.zeros((60, 80), np.int32)
    depth[20:40, 30:60] = rng.integers(250, 400, (20, 30))
    scene = SceneProjective.from_depth(depth, K)
    p = str(tmp_path / "proj.npz")
    serialization.save(p, scene)
    back = serialization.load(p)
    assert back.height == 60 and back.width == 80
    np.testing.assert_array_equal(np.asarray(back.table), np.asarray(scene.table))


def test_kdtree_roundtrip(tmp_path, rng):
    pts, nrm = _cloud(rng)
    tree = build_kdtree(pts, nrm)
    p = str(tmp_path / "tree.npz")
    serialization.save(p, tree)
    back = serialization.load(p)
    np.testing.assert_array_equal(back.points, tree.points)
    np.testing.assert_array_equal(back.child, tree.child)


def test_result_roundtrip(tmp_path):
    import jax.numpy as jnp

    r = prt.RegistrationResult(
        transformation=jnp.eye(4), fitness=jnp.float32(0.9), inlier_rmse=jnp.float32(0.001)
    )
    p = str(tmp_path / "res.npz")
    serialization.save(p, r)
    back = serialization.load(p)
    np.testing.assert_array_equal(np.asarray(back.transformation), np.eye(4))
    assert abs(float(back.fitness) - 0.9) < 1e-7


def test_pose_tracker_roundtrip(tmp_path, rng):
    from pose_refine.utils.fusion import PoseTracker, se3_exp

    pose = np.asarray(se3_exp(rng.normal(0, 0.1, 6)), np.float64)
    pose[:3, 3] = [10.0, -20.0, 500.0]
    tracker = PoseTracker(pose.astype(np.float32))
    tracker.predict()
    tracker.update(pose.astype(np.float32), np.eye(6) * 1e-4)
    p = str(tmp_path / "tracker.npz")
    serialization.save(p, tracker)
    back = serialization.load(p)
    # bit-exact resume: internal full-precision state, not the f32 view
    np.testing.assert_array_equal(back._T, tracker._T)
    # predict() advanced the velocity baseline - it must resume too
    np.testing.assert_array_equal(back._T_prev, tracker._T_prev)
    assert tracker._T_prev is not None
    np.testing.assert_array_equal(back.P, tracker.P)
    np.testing.assert_array_equal(back.Q, tracker.Q)
    assert back.n_rejected == tracker.n_rejected
    # the resumed filter behaves identically
    meas = pose.astype(np.float32)
    assert back.update(meas, np.eye(6) * 1e-4) == tracker.update(
        meas, np.eye(6) * 1e-4
    )
    np.testing.assert_array_equal(back.pose_mm, tracker.pose_mm)


def test_step_timer():
    from pose_refine.utils.profiling import StepTimer

    t = StepTimer()
    for _ in range(3):
        with t:
            pass
    assert t.count == 3 and t.mean >= 0 and t.worst >= t.mean


def test_device_memory_stats():
    """print_cuda_memory_usage analog (renderer.cu:52-69): returns the
    backend's allocator dict or an honest None; the log line never raises."""
    from pose_refine.utils.profiling import device_memory_stats, log_memory_usage

    stats = device_memory_stats()
    assert stats is None or isinstance(stats, dict)
    msg = log_memory_usage("test")
    assert msg.startswith("test")
    if stats and "bytes_in_use" in stats:
        assert "in_use" in msg


def test_sync_fused_probe():
    """The timing fence (utils.timer: jax.block_until_ready) takes arbitrary
    pytrees: values come back intact, non-array leaves pass through, and
    time_jitted times a pytree-returning function."""
    import jax.numpy as jnp

    from pose_refine.utils.timer import sync, time_jitted

    a = jnp.arange(12.0).reshape(3, 4)
    b = jnp.ones(5, jnp.int32)
    tree = (a, {"b": b, "flag": jnp.zeros((), bool), "meta": "host"}, 7)
    out = sync(tree)
    assert float(np.asarray(out[0]).sum()) == 66.0
    assert int(np.asarray(out[1]["b"]).sum()) == 5
    assert out[1]["meta"] == "host" and out[2] == 7
    assert sync(()) == ()  # no-array tree is a no-op
    assert time_jitted(lambda: tree, warmup=1, iters=3) >= 0.0


def test_device_scene_roundtrip(tmp_path):
    """Serialization of a device-built SceneNN (stubbed kd arrays) -
    serving pipelines may persist per-frame scenes."""
    import jax.numpy as jnp

    from pose_refine import geometry
    from pose_refine.scene.nn import SceneNN

    rng = np.random.default_rng(9)
    depth = (rng.uniform(250, 350, (32, 48)) *
             (rng.random((32, 48)) > 0.3)).astype(np.int32)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.08
    scene = SceneNN.from_depth_device(depth, K)
    p = str(tmp_path / "dev_scene.npz")
    serialization.save(p, scene)
    back = serialization.load(p)
    assert back.backend == "bruteforce"
    np.testing.assert_array_equal(np.asarray(back.points), np.asarray(scene.points))
    q = jnp.asarray(np.asarray(scene.points)[:16])
    d0, n0, v0 = map(np.asarray, scene.query(q))
    d1, n1, v1 = map(np.asarray, back.query(q))
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(v0, v1)


def test_load_backfills_missing_leaf_bboxes(tmp_path):
    """Artifacts saved before round 3 carry no leaf bboxes; far-child
    pruning would silently return wrong neighbors on them. load() must
    backfill leaf boxes from the points."""
    import jax
    import jax.numpy as jnp

    from pose_refine.scene.nn import SceneNN, _nn_kdtree

    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 0.3, (2000, 3)).astype(np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (2000, 1))
    scene = SceneNN.from_cloud(pts, nrm)
    p = str(tmp_path / "scene.npz")
    serialization.save(p, scene)

    # simulate a pre-round-3 artifact: zero out the LEAF bbox rows
    with np.load(p, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    leaf = data["child"][:, 0] < 0
    data["bbox"][leaf] = 0.0
    np.savez_compressed(p, **data)

    back = serialization.load(p)
    q = jnp.asarray(pts[:256] + rng.normal(0, 0.01, (256, 3)).astype(np.float32))
    i0, d0 = jax.jit(lambda s: _nn_kdtree(s, scene))(q)
    i1, d1 = jax.jit(lambda s: _nn_kdtree(s, back))(q)
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
