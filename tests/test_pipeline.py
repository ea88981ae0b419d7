import jax.numpy as jnp
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
    return m, K


def test_pose_renderer_api(setup):
    m, K = setup
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    pose1, pose2, _ = reference_demo_poses()
    dep = np.asarray(r.render_depth(np.stack([pose1, pose2])))
    assert dep.shape == (2, H, W) and dep.dtype == np.uint16
    mask = np.asarray(r.render_mask(np.stack([pose1, pose2])))
    assert set(np.unique(mask)) <= {0, 255}
    np.testing.assert_array_equal(mask > 0, dep > 0)
    d2, m2 = r.render_depth_mask(pose1)  # single-pose input
    assert np.asarray(d2).shape == (1, H, W)

    # down_sample halves the raster while keeping the same NDC projection
    half = np.asarray(r.render_depth(pose1, down_sample=2))
    assert half.shape == (1, H // 2, W // 2)
    bbox_full = prt.get_bbox(dep[0])
    bbox_half = prt.get_bbox(half[0])
    assert abs(bbox_full[0] / 2 - bbox_half[0]) <= 1.5
    assert abs(bbox_full[2] / 2 - bbox_half[2]) <= 2

    rgb = prt.PoseRenderer.view_dep(dep[0])
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.uint8


def test_refiner_end_to_end(setup):
    m, K = setup
    pose1, pose2, ang = reference_demo_poses()

    # observed scene = render at the true (perturbed) pose
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=8192, use_pallas=False)
    refiner.set_scene_depth(scene_depth)

    refined, results = refiner.refine(pose1)
    # refined pose should now match pose2 (the ground truth of the scene)
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"refined rotation off by {ang_err} deg"
    t_err = np.abs(np.asarray(refined)[:3, 3] - pose2[:3, 3]).max()
    assert t_err < 6.0, f"translation off by {t_err} mm"
    assert float(results.fitness) > 0.7


@pytest.mark.slow
def test_refiner_batch_ranking(setup):
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=8192, use_pallas=False)
    refiner.set_scene_depth(scene_depth)

    # batch: one good hypothesis (pose1, close to truth) and one garbage
    garbage = pose1.copy()
    garbage[:3, 3] += np.array([500.0, 0, 2000.0], np.float32)
    batch = np.stack([garbage, pose1])
    refined, results = refiner.refine(batch)
    assert refined.shape == (2, 4, 4)
    order = prt.PoseRefiner.rank(results)
    assert order[0] == 1  # the good hypothesis wins
    assert float(results.fitness[1]) > float(results.fitness[0])


def test_refiner_nn_scene(setup):
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=8192, scene="nn_bruteforce", use_pallas=False
    )
    refiner.set_scene_depth(scene_depth)
    refined, results = refiner.refine(pose1)
    assert float(results.fitness) > 0.7


@pytest.mark.slow
def test_refine_schedule_widens_basin(setup):
    """Coarse-to-fine gate schedule recovers a perturbation too large for the
    single-level 0.1 m gate."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    # a much larger perturbation: ~25 deg per axis + 40 mm
    big = np.float32(25.0 / 180.0 * np.pi)
    rot = np.asarray(geometry.euler_to_rotation(np.array([big, big, big])))
    start = np.asarray(
        geometry.pose_from_Rt(rot @ pose2[:3, :3], pose2[:3, 3] + np.float32(40.0))
    )

    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=8192, use_pallas=False)
    refiner.set_scene_depth(scene_depth)

    def rot_err(T):
        Rr = np.asarray(T)[:3, :3] @ pose2[:3, :3].T
        return np.degrees(np.arccos(np.clip((np.trace(Rr) - 1) / 2, -1, 1)))

    single, _ = refiner.refine(start)
    sched, _ = refiner.refine(start, schedule=[(0.4, 15), (0.1, 20), (0.03, 15)])
    # the schedule must do at least as well, and actually converge
    assert rot_err(sched) <= rot_err(single) + 1e-3
    assert rot_err(sched) < 5.0, f"schedule failed to converge: {rot_err(sched)} deg"


def test_refiner_render_scale(setup):
    """render_scale=2 (the reference's down_sample knob inside the loop,
    pose_renderer.cpp:28-29) must recover like full-res rendering."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        render_scale=2, window=64, stride=1,
    )
    refiner.set_scene_depth(scene_depth)
    refined, results = refiner.refine(pose1)
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"render_scale=2 rotation off by {ang_err} deg"
    t_err = np.abs(np.asarray(refined)[:3, 3] - pose2[:3, 3]).max()
    assert t_err < 6.0, f"render_scale=2 translation off by {t_err} mm"
    assert float(results.fitness) > 0.7


def test_window_crop_warning(setup, caplog):
    """No silent caps: a window lift too small for the object must warn."""
    import logging

    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=1024, use_pallas=False,
        window=16, stride=1,
    )
    with caplog.at_level(logging.WARNING, logger="pose_refine"):
        refiner.set_scene_depth(scene_depth)
    assert any("cropped" in rec.message for rec in caplog.records)


def test_refiner_decimated_render_mesh(setup):
    """decimate_mm: hypothesis renders from a vertex-clustered mesh must
    still recover the reference perturbation; the refiner keeps the ORIGINAL
    model (metrics use its vertices) and only shrinks the render triangles."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1, decimate_mm=10.0,
    )
    assert refiner.model is m  # original kept
    assert refiner.tris.shape[0] < m.tris.shape[0]  # render mesh shrank
    refiner.set_scene_depth(scene_depth)
    refined, results = refiner.refine(pose1)
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"decimated render mesh rotation off by {ang_err} deg"
    assert float(results.fitness) > 0.7


def test_nn_scene_backend_auto_select(setup, monkeypatch):
    """scene='nn' takes the platform's exact NN backend
    (pose_refine.platform.nn_backend): the kd traversal on CPU, the GPU's
    own choice there. 'nn_kdtree' forces the traversal."""
    import jax

    from pose_refine import platform

    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    auto = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn", use_pallas=False)
    auto.set_scene_depth(scene_depth)
    assert auto.scene.backend == "kdtree"  # tests run on the CPU backend

    forced = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_kdtree",
                             use_pallas=False)
    forced.set_scene_depth(scene_depth)
    assert forced.scene.backend == "kdtree"

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    auto.set_scene_depth(scene_depth)
    assert auto.scene.backend == platform.nn_backend("gpu")
    forced.set_scene_depth(scene_depth)
    assert forced.scene.backend == "kdtree"


def test_set_scene_cloud_applies_voxel(setup):
    """scene_voxel_mm must apply to clouds given directly, not only depths."""
    m, K = setup
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 0.2, (500, 3)).astype(np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (500, 1))
    r = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_bruteforce",
                        use_pallas=False, scene_voxel_mm=50.0)
    r.set_scene_cloud(pts, nrm)
    assert r.scene.points.shape[0] < 500


def test_auto_lift_tuning(setup):
    """window='auto'/max_points='auto' must size the lift from the observed
    object and still recover the golden perturbation."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, window="auto", max_points="auto",
        use_pallas=False, stride=1,
    )
    refiner.set_scene_depth(scene_depth)
    # sized to the object: window covers the extent, budget covers the
    # object's pixel count with margin, both quantized
    ys, xs = np.nonzero(scene_depth > 0)
    extent = max(xs.max() - xs.min(), ys.max() - ys.min())
    assert refiner.window >= extent
    assert refiner.window % 32 == 0 and refiner.max_points % 256 == 0
    assert refiner.max_points >= (scene_depth > 0).sum()

    refined, results = refiner.refine(pose1)
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"auto-tuned lift off by {ang_err} deg"
    assert float(results.fitness) > 0.7


def test_set_scene_cloud_rejects_auto_lift(setup):
    """auto lift sizes need a depth image; a bare cloud must fail loudly
    instead of refining with a zero-sized lift."""
    m, K = setup
    r = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_bruteforce",
                        use_pallas=False, window="auto", max_points="auto")
    pts = np.zeros((10, 3), np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (10, 1))
    with pytest.raises(ValueError, match="auto"):
        r.set_scene_cloud(pts, nrm)


def test_sync_empty_array_leaf():
    """fence() / PendingResult.wait() must handle zero-size arrays (empty
    batches)."""
    import jax.numpy as jnp

    p = prt.PendingResult(jnp.zeros((0, 4, 4)), (jnp.ones((2, 2)),))
    (refined, results), = prt.fence(p)
    assert refined.shape == (0, 4, 4)
    assert p.wait()[1][0].shape == (2, 2)


def test_multi_model_refiner(setup):
    """One fused batch refining hypotheses of TWO different meshes: each
    hypothesis must converge to the truth pose of ITS OWN object's scene."""
    m1, K = setup
    # NOT a plain sphere: rotationally symmetric surfaces have no
    # recoverable rotation under depth-only ICP
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=2)
    pose1, pose2, _ = reference_demo_poses()

    refiner = prt.MultiModelRefiner(
        [m1, m2], K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1,
    )
    # per-pose triangle tables really differ
    assert refiner.tris_table.shape[0] == 2
    assert not np.allclose(
        np.asarray(refiner.tris_table[0]), np.asarray(refiner.tris_table[1])
    )

    # scene: object m1 at pose2 (the observed frame)
    r1 = prt.PoseRenderer(m1, K=K, width=W, height=H, backend="dense")
    refiner.set_scene_depth(np.asarray(r1.render_depth(pose2))[0].astype(np.int32))
    ids = np.array([0, 0], np.int32)
    starts = np.stack([pose1, pose1])
    refined, results = refiner.refine(ids, starts)
    for i in range(2):
        R_err = np.asarray(refined)[i, :3, :3] @ pose2[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
        assert ang < 4.0, f"model-0 hypothesis {i} off by {ang} deg"

    # scene: object m2 at pose2 - model-1 hypotheses must recover against it
    r2 = prt.PoseRenderer(m2, K=K, width=W, height=H, backend="dense")
    refiner.set_scene_depth(np.asarray(r2.render_depth(pose2))[0].astype(np.int32))
    refined2, results2 = refiner.refine(np.array([1, 1], np.int32), starts)
    for i in range(2):
        R_err = np.asarray(refined2)[i, :3, :3] @ pose2[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
        assert ang < 4.0, f"model-1 hypothesis {i} off by {ang} deg"
    assert float(np.asarray(results2.fitness).min()) > 0.7

    # and the padded (degenerate) triangles must not pollute the render:
    # a model-1 render through the multi table == the single-model render
    dep_multi = np.asarray(
        prt.render(np.asarray(refiner.tris_table[1]), pose2[None], W, H,
                   refiner.proj, backend="dense")
    )
    tris1 = m2.tris[mesh.morton_order(m2.tris)]
    dep_single = np.asarray(
        prt.render(tris1, pose2[None], W, H, refiner.proj, backend="dense")
    )
    np.testing.assert_array_equal(dep_multi, dep_single)


@pytest.mark.slow
def test_feature_composition(setup):
    """All the round-2 features composed at once - auto lift sizing +
    decimation + NN scene with voxel downsampling + coarse-to-fine
    schedule - must still recover the golden perturbation."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, use_pallas=False, stride=1,
        window="auto", max_points="auto", decimate_mm=10.0,
        scene="nn_bruteforce", scene_voxel_mm=6.0,
    )
    refiner.set_scene_depth(scene_depth)
    refined, results = refiner.refine(
        pose1, schedule=[(0.3, 10), (0.1, 21)]
    )
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"composed features off by {ang_err} deg"
    assert float(results.fitness) > 0.7


def test_schedule_coarse_iters_conflict(setup):
    """schedule= levels must out-iterate coarse_iters; the conflict raises an
    actionable error up front (naming both features), and compatible levels
    still run."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, use_pallas=False, stride=1,
        coarse_iters=12, coarse_stride=2,
    )
    refiner.set_scene_depth(scene_depth)
    with pytest.raises(ValueError, match="schedule"):
        refiner.refine(pose1, schedule=[(0.25, 10), (0.05, 20)])
    refined, _ = refiner.refine(pose1, schedule=[(0.25, 15), (0.05, 20)])
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 5.0


def test_roi_hysteresis(setup):
    """The ROI is a static jit argument; small object drift must NOT move it
    (per-frame recompiles turn a tracking loop from ~5 fps to ~0.1), while a
    large displacement must re-crop."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False)

    d1 = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner.set_scene_depth(d1)
    roi1 = refiner.roi
    assert roi1 != (0, 0, 0, 0)

    # a few-pixel drift: same ROI object, program stays compiled
    drift = np.asarray(geometry.pose_from_Rt(pose2[:3, :3], pose2[:3, 3] + np.float32([2, 2, 0])))
    d2 = np.asarray(r.render_depth(drift))[0].astype(np.int32)
    refiner.set_scene_depth(d2)
    assert refiner.roi == roi1

    # a large jump: must re-crop
    far = np.asarray(geometry.pose_from_Rt(pose2[:3, :3], pose2[:3, 3] + np.float32([0, 0, -150])))
    d3 = np.asarray(r.render_depth(far))[0].astype(np.int32)
    assert (d3 > 0).any()
    refiner.set_scene_depth(d3)
    assert refiner.roi != roi1


def test_track_matches_set_scene_plus_refine(setup):
    """track() (fused per-frame scene build + refine) must match the
    two-step set_scene_depth + refine path."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    d = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)
    tracked, res_t = refiner.track(d, pose1)
    refiner.set_scene_depth(d)
    refined, res_r = refiner.refine(pose1)
    np.testing.assert_allclose(np.asarray(tracked), np.asarray(refined), atol=1e-5)
    np.testing.assert_allclose(float(res_t.fitness), float(res_r.fitness), atol=1e-6)

    # NN scenes fuse too since round 3 (test_track_nn_scene_fused); only
    # the kd-tree backend stays host-built and must refuse to fuse
    with pytest.raises(ValueError, match="kd-tree"):
        prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_kdtree",
                        use_pallas=False).track(d, pose1)


def test_track_coarse_schedule(setup):
    """track() with the coarse point schedule (its low-risk home - tracking
    priors are degrees-close): fused path == two-step path, and the result
    still converges to the frame pose."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    d = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1,
                              coarse_iters=8, coarse_stride=2)
    tracked, res_t = refiner.track(d, pose1)
    refiner.set_scene_depth(d)
    refined, _ = refiner.refine(pose1)
    np.testing.assert_allclose(np.asarray(tracked), np.asarray(refined), atol=1e-5)
    R_err = np.asarray(tracked)[:3, :3] @ pose2[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 2.0 and float(np.asarray(res_t.fitness)) > 0.8


def test_multi_model_track(setup):
    """MultiModelRefiner.track: fused per-frame step with per-pose models."""
    m1, K = setup
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=2)
    pose1, pose2, _ = reference_demo_poses()
    r1 = prt.PoseRenderer(m1, K=K, width=W, height=H, backend="dense")
    d = np.asarray(r1.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.MultiModelRefiner(
        [m1, m2], K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1,
    )
    refined, res = refiner.track(d, [0, 0], np.stack([pose1, pose1]))
    R_err = np.asarray(refined)[0, :3, :3] @ pose2[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 4.0


@pytest.mark.slow
def test_multi_model_schedule_and_validation(setup):
    """Regressions from review: (a) schedule= must compose with
    MultiModelRefiner (the schedule recursion used to dispatch to the
    subclass override and crash); (b) out-of-range model ids fail loudly;
    (c) single-pose calls return unbatched results like PoseRefiner."""
    m1, K = setup
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=2)
    pose1, pose2, _ = reference_demo_poses()
    r1 = prt.PoseRenderer(m1, K=K, width=W, height=H, backend="dense")
    d = np.asarray(r1.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.MultiModelRefiner(
        [m1, m2], K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1,
    )
    refiner.set_scene_depth(d)

    # (a) schedule composes
    refined, res = refiner.refine([0], pose1[None],
                                  schedule=[(0.3, 10), (0.1, 21)])
    R_err = np.asarray(refined)[0, :3, :3] @ pose2[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 4.0

    # (b) id range validation
    with pytest.raises(ValueError, match="model_ids"):
        refiner.refine([2], pose1[None])
    with pytest.raises(ValueError, match="model_ids"):
        refiner.refine([-1], pose1[None])

    # (c) unbatched single-pose results, like PoseRefiner
    single, res_s = refiner.refine(0, pose1)
    assert np.asarray(single).shape == (4, 4)
    float(res_s.fitness)  # scalar


def test_tracking_loop_roi_stability(setup):
    """A drifting object must re-crop the ROI only occasionally (each change
    recompiles the fused program) while tracking stays accurate."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)
    rng = np.random.default_rng(9)
    truth = pose2.copy()
    est = pose2.copy()
    rois = []
    for frame in range(6):
        truth = np.asarray(geometry.pose_from_Rt(
            truth[:3, :3], truth[:3, 3] + np.float32([3, 2, 0])))
        d = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        refined, res = refiner.track(d, est)
        est = np.asarray(refined)
        rois.append(refiner.roi)
        t_err = np.abs(est[:3, 3] - truth[:3, 3]).max()
        assert t_err < 6.0, f"frame {frame}: lost track ({t_err} mm)"
    # few-px drift per frame: the crop must persist across most frames
    assert len(set(rois)) <= 2, f"ROI churned: {rois}"


def test_streaming_unfenced_calls_are_correct(setup):
    """Back-to-back refine calls without fencing (the streaming serving
    pattern) must produce the same results as fenced calls."""
    import jax

    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)
    refiner.set_scene_depth(np.asarray(r.render_depth(pose2))[0].astype(np.int32))
    fenced, _ = refiner.refine(pose1)
    outs = [refiner.refine(pose1) for _ in range(3)]  # no fence in between
    jax.block_until_ready([o[0] for o in outs])
    for o, _res in outs:
        np.testing.assert_array_equal(np.asarray(o), np.asarray(fenced))


def test_multi_model_three_models_same_size(setup):
    """3+ models, equal triangle counts (padding no-op): ids select the
    right mesh."""
    m1, K = setup
    m2 = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    m3 = mesh.make_bumpy_sphere(radius=60.0, subdivisions=3)
    assert m1.tris.shape == m2.tris.shape == m3.tris.shape
    r = prt.MultiModelRefiner([m1, m2, m3], K=K, width=W, height=H,
                              use_pallas=False)
    assert r.tris_table.shape[0] == 3
    pose1, pose2, _ = reference_demo_poses()
    rr = prt.PoseRenderer(m3, K=K, width=W, height=H, backend="dense")
    r.set_scene_depth(np.asarray(rr.render_depth(pose2))[0].astype(np.int32))
    refined, res = r.refine([2], pose1[None])  # the observed model
    R_err = np.asarray(refined)[0, :3, :3] @ pose2[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 4.0


def test_chunk_iters_auto_selection(setup, monkeypatch):
    """chunk_iters='auto' fuses the whole ICP loop on the GPU (no host
    round trip per chunk) and keeps small chunks on CPU; explicit values
    pass through."""
    import jax

    from pose_refine.icp import ICPConvergenceCriteria

    m, K = setup
    crit = ICPConvergenceCriteria()
    r = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False)
    assert r.chunk_iters == "auto"
    assert r._resolve_chunk_iters(crit) == 8  # tests run on CPU

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert r._resolve_chunk_iters(crit) == crit.max_iteration + 1  # fused
    assert r._resolve_chunk_iters(ICPConvergenceCriteria(max_iteration=10)) == 11

    explicit = prt.PoseRefiner(m, K=K, width=W, height=H, use_pallas=False,
                               chunk_iters=16)
    assert explicit._resolve_chunk_iters(crit) == 16


def test_auto_lift_hysteresis(setup):
    """Auto lift sizes are static jit args: an object extent oscillating
    across a quantization boundary must NOT retune (= recompile) every
    frame; growth applies immediately, shrink waits for >1 quantum."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, window="auto",
                              max_points="auto", use_pallas=False, stride=1)
    refiner.set_scene_depth(scene_depth)
    w0, mp0 = refiner.window, refiner.max_points

    ys, xs = np.nonzero(scene_depth > 0)

    # a slightly smaller object (shrunk extent by a few px): keep sizes
    keep = (ys[: int(0.97 * len(ys))], xs[: int(0.97 * len(xs))])
    refiner._tune_lift(keep)
    assert (refiner.window, refiner.max_points) == (w0, mp0)

    # a much smaller object: sizes shrink
    small = (ys[: len(ys) // 6], xs[: len(xs) // 6])
    refiner._tune_lift(small)
    assert refiner.max_points < mp0

    # growth is immediate (undersized budgets drop boundary points)
    refiner._tune_lift((ys, xs))
    assert refiner.window >= w0 and refiner.max_points >= mp0


def test_lift_saturation_warning(setup, caplog):
    """A budget the hypothesis clouds fill to the brim warns once per frame
    (no-silent-caps: compaction drops boundary points when saturated)."""
    import logging

    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=256,
                              window=64, stride=1, use_pallas=False)
    refiner.set_scene_depth(scene_depth)
    with caplog.at_level(logging.WARNING, logger="pose_refine"):
        refiner.refine(pose1)
    assert any("saturated" in rec.message for rec in caplog.records)

    # checked once per frame, not per call
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="pose_refine"):
        refiner.refine(pose1)
    assert not any("saturated" in rec.message for rec in caplog.records)


def test_results_report_n_points(setup):
    """RegistrationResult.n_points = valid cloud points per pose (the
    fitness divisor, icp.cpp:158) - the saturation diagnostic."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              window=64, stride=1, use_pallas=False)
    refiner.set_scene_depth(scene_depth)
    _, res = refiner.refine(np.stack([pose1, pose2]))
    n = np.asarray(res.n_points)
    assert n.shape == (2,) and (n > 100).all() and (n < 4096).all()


def test_refine_async_fence(setup):
    """The streaming serving primitive: refine_async results, fenced in one
    probe, equal synchronous refine results; nothing on the async path
    blocks on the host (the saturation readback is deferred)."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)
    refiner.set_scene_depth(np.asarray(r.render_depth(pose2))[0].astype(np.int32))

    # async path must not consume the once-per-frame saturation check:
    # the FIRST calls are async, and the flag set by set_scene_depth must
    # survive them for the next synchronous refine to perform the check
    assert refiner._check_saturation is True
    warm = refiner.refine_async(pose1)
    warm.wait()
    assert refiner._check_saturation is True

    fenced, fres = refiner.refine(pose1)
    assert refiner._check_saturation is False  # sync refine consumed it
    pending = [refiner.refine_async(pose1) for _ in range(3)]
    assert all(isinstance(p, prt.PendingResult) for p in pending)
    outs = prt.fence(*pending)
    assert len(outs) == 3
    for refined, res in outs:
        np.testing.assert_array_equal(np.asarray(refined), np.asarray(fenced))
        np.testing.assert_array_equal(np.asarray(res.fitness), np.asarray(fres.fitness))
    # wait() on an already-fenced result is a cheap no-op returning the pair
    rf, rr = pending[0].wait()
    np.testing.assert_array_equal(np.asarray(rf), np.asarray(fenced))


@pytest.mark.slow
def test_track_nn_scene_fused(setup):
    """track() with an NN scene: the per-frame scene build runs ON DEVICE
    inside the fused program (from_depth_device) and matches the unfused
    set_scene_depth + refine path built from the same raw cloud."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              scene="nn_bruteforce", use_pallas=False,
                              window=64, stride=1)
    tracked, tres = refiner.track(scene_depth, pose1)

    unfused = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              scene="nn_bruteforce", use_pallas=False,
                              window=64, stride=1)
    unfused.set_scene_depth(scene_depth)
    refined, res = unfused.refine(pose1)

    # identical scene point set (grid vs compacted cloud) -> same
    # refinement up to reduction-order float noise (the tables are ordered
    # differently: Morton grid vs kd-compacted cloud)
    np.testing.assert_allclose(np.asarray(tracked), np.asarray(refined),
                               atol=5e-3)
    assert abs(float(tres.fitness) - float(res.fitness)) < 1e-3

    # and it actually recovered the perturbation
    R_err = np.asarray(tracked)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0


def test_track_nn_kdtree_rejected(setup):
    m, K = setup
    r = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_kdtree",
                        use_pallas=False)
    with pytest.raises(ValueError, match="kd-tree"):
        r.track(np.zeros((H, W), np.int32), np.eye(4, dtype=np.float32))


def test_track_nn_scene_stride(setup):
    """scene_stride=2 (device analog of voxel downsampling) still tracks."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              scene="nn_bruteforce", scene_stride=2,
                              use_pallas=False, window=64, stride=1)
    tracked, tres = refiner.track(scene_depth, pose1)
    R_err = np.asarray(tracked)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"stride-2 NN tracking off by {ang_err} deg"


def test_cluttered_scene_two_objects(setup):
    """Realistic clutter: TWO objects composited into one depth frame, each
    refined from its own perturbed hypothesis in a single MultiModelRefiner
    batch (the reference needs one full pipeline run per object).

    Scenario 1 - adjacent objects (no occlusion, surfaces within the same
    frame): both must refine as tightly as against a clean scene; the other
    object's points are rejected by the association gate.

    Scenario 2 - partial occlusion (B in front, covering ~30% of A): the
    unoccluded object must stay tight; the occluded one degrades gracefully
    (translation still recovered, rotation bounded) - limb points of the
    occluder near the boundary pass any reasonable depth gate and pull the
    occluded surface, an inherent limit of depth-only projective ICP that
    the reference's identical gate (depth_scene.h:9) shares."""
    m1, K = setup
    m2 = mesh.make_bumpy_sphere(radius=35.0, subdivisions=3, bump=0.3)
    pose1, pose2, _ = reference_demo_poses()

    rA = prt.PoseRenderer(m1, K=K, width=W, height=H, backend="dense")
    rB = prt.PoseRenderer(m2, K=K, width=W, height=H, backend="dense")
    rng = np.random.default_rng(13)
    d = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.08, 0.08, 3).astype(np.float32)))
    d2 = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.08, 0.08, 3).astype(np.float32)))

    def run(shift):
        poseB = pose2.copy()
        poseB[:3, 3] += np.float32(shift)
        dA = np.asarray(rA.render_depth(pose2))[0].astype(np.int32)
        dB = np.asarray(rB.render_depth(poseB))[0].astype(np.int32)
        both = np.where((dA > 0) & ((dB == 0) | (dA <= dB)), dA, dB)
        startA = np.asarray(geometry.pose_from_Rt(
            d @ pose2[:3, :3], pose2[:3, 3] + np.float32([4, -3, 6])))
        startB = np.asarray(geometry.pose_from_Rt(
            d2 @ poseB[:3, :3], poseB[:3, 3] + np.float32([-5, 2, -4])))
        # gate 30 mm: the default 0.1 m spans BOTH objects at this toy
        # scale - pick the gate against the expected clutter distance
        ref = prt.MultiModelRefiner([m1, m2], K=K, width=W, height=H,
                                    max_points=4096, window=96, stride=1,
                                    use_pallas=False, max_dist_diff=0.03)
        ref.set_scene_depth(both)
        refined, res = ref.refine([0, 1], np.stack([startA, startB]))
        refined = np.asarray(refined)
        errs = []
        for got, want in ((refined[0], pose2), (refined[1], poseB)):
            Rr = got[:3, :3] @ want[:3, :3].T
            ang = np.degrees(np.arccos(np.clip((np.trace(Rr) - 1) / 2, -1, 1)))
            errs.append((ang, np.abs(got[:3, 3] - want[:3, 3]).max()))
        overlap = int(((dA > 0) & (dB > 0)).sum())
        return errs, overlap, res

    # scenario 1: adjacent, no occlusion
    (errA, errB), overlap, res = run([-90, -10, -10])
    assert overlap == 0
    assert errA[0] < 4.0 and errA[1] < 6.0, f"adjacent A: {errA}"
    assert errB[0] < 4.0 and errB[1] < 6.0, f"adjacent B: {errB}"
    assert float(res.fitness.min()) > 0.7

    # scenario 2: B occludes ~30% of A
    (errA, errB), overlap, res = run([-70, -10, -20])
    assert overlap > 100
    assert errB[0] < 4.0 and errB[1] < 6.0, f"occluder B: {errB}"
    # occluded A: translation recovered, rotation degrades but bounded
    assert errA[1] < 6.0, f"occluded A translation: {errA}"
    assert errA[0] < 30.0, f"occluded A rotation unbounded: {errA}"


def test_track_async_defers_saturation_fence(setup):
    """track_async must not run the once-per-frame lift-saturation readback
    (a full device fence) inside the enqueue: track() -> _prepare_frame
    re-arms the check per frame, so a save/restore of the flag around the
    call would still let _warn_if_saturated fence mid-enqueue, serializing
    the double-buffered sessions. The armed flag SURVIVING track_async
    proves no readback ran; the next synchronous call consumes it."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    d = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                              use_pallas=False, window=64, stride=1)
    pending = refiner.track_async(d, pose1)
    assert refiner._suppress_saturation is False
    assert refiner._check_saturation is True, (
        "async enqueue consumed the deferred saturation check (it fenced)")
    refined_async = np.asarray(pending.refined)
    tracked, _res = refiner.track(d, pose1)
    assert refiner._check_saturation is False, (
        "synchronous track() must consume the deferred check")
    np.testing.assert_allclose(refined_async, np.asarray(tracked), atol=1e-5)


def test_unknown_scene_kind_rejected_at_init():
    """A typo'd scene kind must fail loudly at CONSTRUCTION - before this
    check, set_scene_depths' NN else-branch silently built a bruteforce
    stack for any unknown kind (different speed/semantics, no error)."""
    m = mesh.make_icosphere(radius=50.0, subdivisions=1)
    K = geometry.LINEMOD_K.copy()
    with pytest.raises(ValueError, match="unknown scene kind"):
        prt.PoseRefiner(m, K=K, scene="projectve")
    with pytest.raises(ValueError, match="unknown scene kind"):
        prt.PoseRefiner(m, K=K, scene="nn_flash")


def test_unknown_lift_rejected_at_init():
    """A typo'd lift must fail loudly, not silently take the compact path
    (window/stride ignored, different point budget)."""
    m = mesh.make_icosphere(radius=50.0, subdivisions=1)
    K = geometry.LINEMOD_K.copy()
    with pytest.raises(ValueError, match="unknown lift"):
        prt.PoseRefiner(m, K=K, lift="Window")


def test_track_rejects_scene_cascade():
    """scene_cascade configures a coarse twin of a FIXED scene; track()
    builds its scene in-program and has no twin - it must reject the knob
    loudly rather than silently running full-res while the user believes
    the measured cascade speedup is active."""
    m = mesh.make_icosphere(radius=50.0, subdivisions=1)
    K = geometry.LINEMOD_K.copy()
    refiner = prt.PoseRefiner(m, K=K, width=160, height=120,
                              use_pallas=False, scene="nn_bruteforce",
                              scene_cascade=(2.0, 4))
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))
    depth = np.full((120, 160), 300, np.int32)
    with pytest.raises(ValueError, match="scene_cascade applies to"):
        refiner.track(depth, pose)


def test_track_device_frames_reuse_frame_plan(monkeypatch):
    """Device-resident frames on the tracking path must not pay a
    full-frame D2H per call: after the first planned frame, _prepare_frame
    reuses the standing ROI/window plan (host numpy frames always plan -
    their scans are fence-free)."""
    import pose_refine.pipeline as pl

    m = mesh.make_icosphere(radius=50.0, subdivisions=1)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    refiner = prt.PoseRefiner(m, K=K, width=160, height=120,
                              use_pallas=False, window=64, stride=1)
    r = prt.PoseRenderer(m, K=K, width=160, height=120, backend="dense")
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))
    depth = np.asarray(r.render_depth(pose))[0].astype(np.int32)

    calls = {"n": 0}
    real = prt.PoseRefiner._object_stats

    def counting(self, d):
        calls["n"] += 1
        return real(self, d)

    monkeypatch.setattr(prt.PoseRefiner, "_object_stats", counting)
    # the skip keys on jax.Array input + an accelerator platform; fake the
    # platform the choices are made for
    monkeypatch.setattr(pl.platform, "current", lambda platform=None: "gpu")
    try:
        dev_frame = jnp.asarray(depth)
        refiner._prepare_frame(dev_frame, allow_device_skip=True)
        assert calls["n"] == 1  # first device frame pays one planning scan
        refiner._prepare_frame(dev_frame, allow_device_skip=True)
        refiner._prepare_frame(dev_frame, allow_device_skip=True)
        assert calls["n"] == 1  # later device frames reuse the plan
        assert refiner._check_saturation  # but the per-frame guard re-arms
        refiner._prepare_frame(depth, allow_device_skip=True)
        assert calls["n"] == 2  # host numpy frames always plan
        refiner._prepare_frame(dev_frame)  # set_scene_depth path: plans
        assert calls["n"] == 3
    finally:
        monkeypatch.undo()


def test_scene_cascade_validation():
    m = mesh.make_icosphere(radius=50.0, subdivisions=1)
    K = geometry.LINEMOD_K.copy()
    with pytest.raises(ValueError, match="NN-scene feature"):
        prt.PoseRefiner(m, K=K, scene="projective", scene_cascade=(2.0, 16))
    with pytest.raises(ValueError, match="coarse_voxel_mm > 0"):
        prt.PoseRefiner(m, K=K, scene="nn_bruteforce", scene_cascade=(0.0, 16))
    with pytest.raises(ValueError, match="coarse_iters >= 1"):
        prt.PoseRefiner(m, K=K, scene="nn_bruteforce", scene_cascade=(2.0, 0))
    with pytest.raises(ValueError, match="coarser than scene_voxel_mm"):
        prt.PoseRefiner(m, K=K, scene="nn_bruteforce",
                        scene_voxel_mm=4.0, scene_cascade=(2.0, 16))


@pytest.mark.slow
def test_scene_cascade_matches_full_resolution_refine(setup):
    """scene_cascade=(coarse_voxel, coarse_iters) + few fine iters recovers
    the same poses as the full-iteration single-level refine against the
    raw scene - the coarse pre-pass only repositions the basin entry, the
    full-resolution pass owns the answer (and the RegistrationResult)."""
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    def build(cascade):
        ref = prt.PoseRefiner(
            m, K=K, width=W, height=H, max_points=4096, window=96,
            scene="nn_bruteforce", use_pallas=False, scene_cascade=cascade)
        ref.set_scene_depth(scene_depth)
        return ref

    crit_full = prt.ICPConvergenceCriteria(max_iteration=24)
    crit_fine = prt.ICPConvergenceCriteria(max_iteration=8)
    refined_c, res_c = build((4.0, 16)).refine(pose1, criteria=crit_fine)
    refined_f, res_f = build(None).refine(pose1, criteria=crit_full)
    # same converged pose to sub-raster tolerance, same quality signals
    np.testing.assert_allclose(
        np.asarray(refined_c), np.asarray(refined_f), atol=0.5)
    assert abs(float(res_c.fitness) - float(res_f.fitness)) < 0.05
    assert float(res_c.fitness) > 0.7


@pytest.mark.slow
def test_scene_cascade_composes_with_schedule_and_async(setup):
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    ref = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, window=96,
        scene="nn_bruteforce", use_pallas=False, scene_cascade=(4.0, 8))
    ref.set_scene_depth(scene_depth)
    assert ref._scene_coarse is not None
    assert ref._scene_coarse.points.shape[0] < ref.scene.points.shape[0]

    # schedule: cascade pre-pass first, then the gate levels at full res
    refined, res = ref.refine(
        pose1, criteria=prt.ICPConvergenceCriteria(max_iteration=8),
        schedule=[(0.3, 6), (0.1, 8)])
    assert float(res.fitness) > 0.7

    # async: two unfenced cascade dispatches, fenced once
    pending = ref.refine_async(
        pose1[None], criteria=prt.ICPConvergenceCriteria(max_iteration=8))
    (refined_a, res_a), = prt.fence(pending)
    assert float(res_a.fitness[0]) > 0.7

    # covariance comes from the full-resolution pass
    _, res_cov, unc = ref.refine(
        pose1[None], criteria=prt.ICPConvergenceCriteria(max_iteration=8),
        with_covariance=True)
    assert np.isfinite(np.asarray(unc.covariance)).all()


def test_scene_cascade_from_cloud(setup):
    m, K = setup
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    from pose_refine.scene.nn import SceneNN
    host = SceneNN.from_depth(scene_depth, K, backend="bruteforce")
    ref = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, window=96,
        scene="nn_bruteforce", use_pallas=False, scene_cascade=(6.0, 4))
    ref.set_scene_cloud(np.asarray(host.points), np.asarray(host.normals))
    assert ref._scene_coarse is not None
    assert ref._scene_coarse.points.shape[0] < ref.scene.points.shape[0]
