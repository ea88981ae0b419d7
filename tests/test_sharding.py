import jax
import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.parallel import make_mesh, refine_poses_sharded, shard_pose_batch
from tests.test_icp import reference_demo_poses

W, H = 160, 120


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8  # conftest forces the virtual CPU mesh


@pytest.mark.slow
def test_sharded_refine_matches_single_device():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, pose2, _ = reference_demo_poses()

    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    scene = prt.SceneProjective.from_depth(scene_depth, K)

    # 8 hypotheses (one per device): jittered copies of pose1
    rng = np.random.default_rng(5)
    poses = []
    for i in range(8):
        d = np.asarray(geometry.euler_to_rotation(rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
        poses.append(np.asarray(geometry.pose_from_Rt(d @ pose1[:3, :3], pose1[:3, 3])))
    poses = np.stack(poses)

    tris = m.tris[mesh.morton_order(m.tris)]
    proj = geometry.compute_proj(K, W, H)

    dev_mesh = make_mesh()
    refined_sh, res_sh = refine_poses_sharded(
        tris, poses, scene, proj, K, W, H, max_points=4096, mesh=dev_mesh
    )
    # the result is actually sharded over the pose axis
    assert len(refined_sh.sharding.device_set) == 8

    from pose_refine.pipeline import refine_poses_jit
    import pose_refine.icp as icp_mod

    refined_1, res_1 = refine_poses_jit(
        tris, poses, scene, proj, K, width=W, height=H, max_points=4096,
        criteria=icp_mod.ICPConvergenceCriteria(), use_pallas=False,
    )
    np.testing.assert_allclose(
        np.asarray(refined_sh), np.asarray(refined_1), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.fitness), np.asarray(res_1.fitness), atol=1e-5
    )


def _class_workload(n_poses, seed=7):
    """Scene depth + jittered hypotheses for PoseRefiner-level tests."""
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n_poses):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
        poses.append(np.asarray(geometry.pose_from_Rt(d @ pose1[:3, :3], pose1[:3, 3])))
    return m, K, scene_depth, np.stack(poses)


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [2, 8])
def test_poserefiner_class_sharded_matches_single_device(ndev):
    """The production class routed over a 2- and 8-device mesh ==
    single-device, including a NON-divisible batch (10 poses: padded with a
    replicated first pose, padding dropped from the results)."""
    m, K, scene_depth, poses = _class_workload(10)

    def build(devices):
        r = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                            window=64, devices=devices)
        r.set_scene_depth(scene_depth)
        return r

    sharded = build(devices=ndev)
    assert sharded._device_mesh() is not None
    refined_s, res_s = sharded.refine(poses)
    assert refined_s.shape == (10, 4, 4)

    single = build(devices=1)
    assert single._device_mesh() is None
    refined_1, res_1 = single.refine(poses)

    np.testing.assert_array_equal(np.asarray(refined_s), np.asarray(refined_1))
    np.testing.assert_array_equal(np.asarray(res_s.fitness), np.asarray(res_1.fitness))
    np.testing.assert_array_equal(
        np.asarray(res_s.inlier_rmse), np.asarray(res_1.inlier_rmse))
    np.testing.assert_array_equal(
        np.asarray(res_s.n_points), np.asarray(res_1.n_points))


@pytest.mark.slow
@pytest.mark.parametrize("scene", ["nn_bruteforce", "nn"])
def test_poserefiner_class_sharded_nn_scene_matches_single(scene):
    """NN scenes (brute-force scan AND kd traversal) through the sharded class
    path == single-device: the scene table/tree replicates over the mesh
    while the pose batch shards (same one-scene-many-poses layout as
    projective; pcd_scene.h's device struct is the reference analogue).
    Not bit-exact: the NN query's reduction trees repartition under GSPMD,
    whose float reassociation can flip the Δ<1e-5 convergence latch one
    iteration earlier/later (measured pose delta ≤3e-3 here - far under
    raster quantization; same caveat as the fused track() test below)."""
    m, K, scene_depth, poses = _class_workload(6)

    def run(devices):
        r = prt.PoseRefiner(m, K=K, width=W, height=H, scene=scene,
                            max_points=512, window=96, stride=2,
                            devices=devices)
        r.set_scene_depth(scene_depth)
        refined, res = r.refine(poses)
        return np.asarray(refined), np.asarray(res.fitness)

    refined_s, fit_s = run(8)
    refined_1, fit_1 = run(1)
    np.testing.assert_allclose(refined_s, refined_1, atol=0.02)
    np.testing.assert_allclose(fit_s, fit_1, atol=0.01)


def test_poserefiner_auto_devices_stays_single_on_cpu():
    """devices=None must NOT hijack CPU hosts (the 8-virtual-device test
    mesh included) - auto-sharding engages only on real device backends."""
    m, K, scene_depth, poses = _class_workload(2)
    r = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096, window=64)
    assert r._device_mesh() is None


@pytest.mark.slow
def test_track_class_sharded_matches_single_device():
    """track() (fused per-frame scene build + refine) through the mesh."""
    m, K, scene_depth, poses = _class_workload(5)

    def build(devices):
        return prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                               window=64, devices=devices)

    refined_s, res_s = build(8).track(scene_depth, poses)
    refined_1, res_1 = build(1).track(scene_depth, poses)
    assert refined_s.shape == (5, 4, 4)
    # not bit-exact (unlike refine): the IN-PROGRAM scene build compiles
    # under a different GSPMD partitioning, whose float reassociation can
    # flip the Δ<1e-5 convergence latch one iteration earlier/later - the
    # poses agree to well under raster quantization (refine-level parity is
    # asserted exactly in test_poserefiner_class_sharded_matches_single_device)
    np.testing.assert_allclose(
        np.asarray(refined_s), np.asarray(refined_1), atol=0.02
    )
    np.testing.assert_allclose(
        np.asarray(res_s.fitness), np.asarray(res_1.fitness), atol=0.01
    )


@pytest.mark.slow
def test_multimodel_class_sharded_matches_single_device():
    """MultiModelRefiner: per-pose triangle tables shard with their poses
    through the class API, non-divisible batch."""
    m1 = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    _, K, scene_depth, poses = _class_workload(6)
    ids = [0, 1, 0, 1, 0, 1]

    def build(devices):
        r = prt.MultiModelRefiner([m1, m2], K=K, width=W, height=H,
                                  max_points=4096, window=64, devices=devices)
        r.set_scene_depth(scene_depth)
        return r

    refined_s, res_s = build(8).refine(ids, poses)
    refined_1, res_1 = build(1).refine(ids, poses)
    assert refined_s.shape == (6, 4, 4)
    # sharding the (N, T, 3, 3) table changes GSPMD's partitioning of the
    # raster setup; float reassociation there can flip the convergence
    # latch (see the track test above) - agreement far below raster
    # quantization is the contract (shared-mesh refine is bit-exact)
    np.testing.assert_allclose(
        np.asarray(refined_s), np.asarray(refined_1), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_s.fitness), np.asarray(res_1.fitness), atol=0.01
    )


def test_pad_to_devices_roundtrip():
    from pose_refine.parallel import pad_to_devices, unpad_results

    poses = np.random.default_rng(0).normal(size=(5, 4, 4)).astype(np.float32)
    tris = np.random.default_rng(1).normal(size=(5, 7, 3, 3)).astype(np.float32)
    p, t, n = pad_to_devices(8, poses, jax.numpy.asarray(tris))
    assert p.shape == (8, 4, 4) and t.shape == (8, 7, 3, 3) and n == 5
    np.testing.assert_array_equal(np.asarray(p[5:]), np.tile(poses[:1], (3, 1, 1)))
    r, res = unpad_results(n, p, {"fitness": jax.numpy.zeros(8)})
    assert r.shape == (5, 4, 4) and res["fitness"].shape == (5,)


def test_shard_pose_batch_layout():
    dev_mesh = make_mesh()
    poses = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    sharded = shard_pose_batch(dev_mesh, poses)
    assert sharded.shape == (16, 4, 4)
    assert len(sharded.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_per_pose_tris():
    """Multi-model batches (per-pose (N, T, 3, 3) triangle tables) shard
    with their poses over the mesh and match the single-device result."""
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m1 = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    pose1, pose2, _ = reference_demo_poses()

    r = prt.PoseRenderer(m1, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    scene = prt.SceneProjective.from_depth(scene_depth, K)

    rng = np.random.default_rng(6)
    poses = []
    for i in range(8):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
        poses.append(np.asarray(geometry.pose_from_Rt(d @ pose1[:3, :3], pose1[:3, 3])))
    poses = np.stack(poses)

    t1 = m1.tris[mesh.morton_order(m1.tris)]
    t2 = m2.tris[mesh.morton_order(m2.tris)]
    assert t1.shape == t2.shape
    tris_pp = np.stack([t1, t2, t1, t2, t1, t2, t1, t2])  # (8, T, 3, 3)
    proj = geometry.compute_proj(K, W, H)

    dev_mesh = make_mesh()
    refined_sh, res_sh = refine_poses_sharded(
        tris_pp, poses, scene, proj, K, W, H, max_points=4096, mesh=dev_mesh
    )
    assert len(refined_sh.sharding.device_set) == 8

    from pose_refine.pipeline import refine_poses_jit
    import pose_refine.icp as icp_mod

    refined_1, res_1 = refine_poses_jit(
        tris_pp, poses, scene, proj, K, width=W, height=H, max_points=4096,
        criteria=icp_mod.ICPConvergenceCriteria(), use_pallas=False,
    )
    np.testing.assert_allclose(np.asarray(refined_sh), np.asarray(refined_1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(res_sh.fitness), np.asarray(res_1.fitness), atol=1e-5)


@pytest.mark.slow
def test_sharded_schedule_matches_single_device():
    """Coarse-to-fine schedules re-enter refine() per level; each level must
    route through the mesh and still match single-device exactly."""
    m, K, scene_depth, poses = _class_workload(6)

    def build(devices):
        r = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                            window=64, devices=devices)
        r.set_scene_depth(scene_depth)
        return r

    sched = [(0.3, 8), (0.1, 12)]
    refined_s, res_s = build(8).refine(poses, schedule=sched)
    refined_1, res_1 = build(1).refine(poses, schedule=sched)
    # two chained levels amplify the usual GSPMD float-reassociation noise
    # through the convergence latch (see the track test's comment) - the
    # contract is agreement far below raster quantization
    np.testing.assert_allclose(
        np.asarray(refined_s), np.asarray(refined_1), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_s.fitness), np.asarray(res_1.fitness), atol=0.01
    )


def test_sharded_coarse_schedule_matches_single_device():
    """The coarse-to-fine ICP point schedule rides through _pipeline_items
    into the sharded program: class over an 8-device mesh == single-device,
    bit-for-bit, with coarse_iters set."""
    m, K, scene_depth, poses = _class_workload(10)

    def build(devices):
        r = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                            window=64, coarse_iters=12, coarse_stride=2,
                            devices=devices)
        r.set_scene_depth(scene_depth)
        return r

    sharded = build(devices=8)
    assert sharded._device_mesh() is not None
    refined_s, res_s = sharded.refine(poses)

    single = build(devices=1)
    refined_1, res_1 = single.refine(poses)

    np.testing.assert_array_equal(np.asarray(refined_s), np.asarray(refined_1))
    np.testing.assert_array_equal(
        np.asarray(res_s.fitness), np.asarray(res_1.fitness))
    np.testing.assert_array_equal(
        np.asarray(res_s.inlier_rmse), np.asarray(res_1.inlier_rmse))


def test_sharded_p2p_estimation_matches_single_device():
    """estimation='point_to_point' rides through _pipeline_items into the
    sharded program: class over an 8-device mesh == single-device,
    bit-for-bit. (The bumpy sphere is p2p-hostile for ACCURACY - sharded
    parity only needs both paths to run the identical program.)"""
    m, K, scene_depth, poses = _class_workload(10)

    def build(devices):
        r = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                            window=64, estimation="point_to_point",
                            devices=devices)
        r.set_scene_depth(scene_depth)
        return r

    sharded = build(devices=8)
    assert sharded._device_mesh() is not None
    refined_s, res_s = sharded.refine(poses)

    single = build(devices=1)
    refined_1, res_1 = single.refine(poses)

    np.testing.assert_array_equal(np.asarray(refined_s), np.asarray(refined_1))
    np.testing.assert_array_equal(
        np.asarray(res_s.fitness), np.asarray(res_1.fitness))
    np.testing.assert_array_equal(
        np.asarray(res_s.inlier_rmse), np.asarray(res_1.inlier_rmse))
