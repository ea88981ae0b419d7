"""Fused in-program pose uncertainty (refine/track with_covariance=True).

The standalone icp.pose_information path costs ~20 eager dispatches per
frame; these tests pin the fused
alternative: identical refinement outputs, a PoseUncertainty batch computed
at the ICP's final clouds, parity across the sharded/track/multi-model/
async surfaces, and a semantic anchor against the standalone path.
"""
import jax
import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, icp, mesh
from tests.test_icp import reference_demo_poses

W, H = 160, 120


@pytest.fixture(scope="module")
def setup():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    rng = np.random.default_rng(13)
    poses = []
    for _ in range(4):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
        poses.append(np.asarray(geometry.pose_from_Rt(
            d @ pose1[:3, :3], pose1[:3, 3])))
    return m, K, scene_depth, np.stack(poses)


def _refiner(m, K, **kw):
    kw.setdefault("max_points", 4096)
    kw.setdefault("window", 64)
    kw.setdefault("use_pallas", False)
    return prt.PoseRefiner(m, K=K, width=W, height=H, **kw)


def _check_unc(unc, n):
    info = np.asarray(unc.information)
    s2 = np.asarray(unc.sigma2)
    cnt = np.asarray(unc.count)
    cov = np.asarray(unc.covariance)
    assert info.shape == (n, 6, 6) and cov.shape == (n, 6, 6)
    assert s2.shape == (n,) and cnt.shape == (n,)
    assert np.isfinite(info).all() and np.isfinite(cov).all()
    assert (cnt > 6).all() and (s2 >= 0).all()
    np.testing.assert_allclose(info, np.swapaxes(info, 1, 2), rtol=1e-5)
    # jnp.linalg.inv is not exactly symmetric - bound asymmetry relative
    # to the matrix scale, then check positive definiteness on the
    # symmetrized form
    assert np.abs(cov - np.swapaxes(cov, 1, 2)).max() <= 1e-4 * np.abs(cov).max()
    sym = 0.5 * (cov + np.swapaxes(cov, 1, 2))
    assert (np.linalg.eigvalsh(sym) > 0).all()


def test_with_covariance_appends_uncertainty_and_preserves_results(setup):
    """The extra association pass must not perturb the refinement: the
    2-tuple and 3-tuple calls return identical poses/results."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K)
    r.set_scene_depth(scene_depth)
    refined0, res0 = r.refine(poses)
    refined1, res1, unc = r.refine(poses, with_covariance=True)
    np.testing.assert_array_equal(np.asarray(refined0), np.asarray(refined1))
    np.testing.assert_array_equal(np.asarray(res0.fitness),
                                  np.asarray(res1.fitness))
    np.testing.assert_array_equal(np.asarray(res0.inlier_rmse),
                                  np.asarray(res1.inlier_rmse))
    _check_unc(unc, 4)


def test_fused_matches_standalone_pose_information(setup):
    """Semantic anchor: the fused info equals standalone pose_information
    at the final cloud (initial lift transformed by the returned T). The
    ICP loop applies per-iteration increments while this reconstruction
    composes them into one transform, so equality is to f32 accumulation
    noise, not bitwise."""
    from pose_refine.ops import rasterize as rz
    from pose_refine.ops.depth_to_cloud import window_cloud_batched
    from pose_refine.pipeline import refine_poses_jit

    m, K, scene_depth, poses = setup
    scene = prt.SceneProjective.from_depth(scene_depth, K)
    tris = m.tris[mesh.morton_order(m.tris)]
    proj = geometry.compute_proj(K, W, H)
    crit = icp.ICPConvergenceCriteria()

    refined, res, unc = refine_poses_jit(
        tris, poses, scene, proj, K, width=W, height=H, max_points=4096,
        criteria=crit, use_pallas=False,
        window=64, stride=2, chunk_iters=64, with_information=True,
    )

    depth = rz.rasterize_scatter(tris, poses, W, H, proj)
    clouds, valids, _ = window_cloud_batched(depth, K, window=64, stride=2)
    final = jax.vmap(geometry.transform_points)(res.transformation, clouds)
    info2, s2_2, cnt2 = jax.vmap(
        lambda c, v: icp.pose_information(c, v, scene.query)
    )(final, valids)

    # borderline associations may flip under the composed-vs-incremental
    # transform difference: allow a couple of rows out of ~1000
    assert np.abs(np.asarray(cnt2) - np.asarray(unc.count)).max() <= 2
    scale = np.abs(np.asarray(info2)).max()
    np.testing.assert_allclose(np.asarray(unc.information),
                               np.asarray(info2), atol=2e-2 * scale)
    np.testing.assert_allclose(np.asarray(unc.sigma2), np.asarray(s2_2),
                               rtol=0.05)
    # and the returned covariance is exactly the render-calibrated
    # pose_covariance (the pipeline floors sigma2 at the depth + lateral
    # quantization variance and applies RENDER_COV_INFLATION - icp.py
    # rationale)
    v = np.asarray(valids, np.float64)
    mean_z = (np.abs(np.asarray(final)[..., 2]) * v).sum(-1) / v.sum(-1)
    lateral = icp.LATERAL_QUANT_COEFF * mean_z / K[0, 0]
    cov2 = icp.pose_covariance(
        unc.information, unc.sigma2,
        inflation=icp.RENDER_COV_INFLATION,
        sigma2_floor=icp.DEPTH_QUANT_SIGMA_M ** 2 + lateral ** 2)
    np.testing.assert_allclose(np.asarray(unc.covariance), np.asarray(cov2),
                               rtol=1e-4, atol=1e-12)


def test_track_with_covariance_matches_refine(setup):
    """track(with_covariance=True) == set_scene_depth + refine(...) - the
    fused scene build must not change the uncertainty."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K, stride=1)
    tracked, res_t, unc_t = r.track(scene_depth, poses, with_covariance=True)
    r.set_scene_depth(scene_depth)
    refined, res_r, unc_r = r.refine(poses, with_covariance=True)
    np.testing.assert_allclose(np.asarray(tracked), np.asarray(refined),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(unc_t.covariance),
                               np.asarray(unc_r.covariance),
                               rtol=1e-3, atol=1e-10)
    _check_unc(unc_t, 4)


def test_track_nn_with_covariance(setup):
    """NN-scene tracking carries the uncertainty through the device-built
    NN-scene program too."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K, scene="nn_bruteforce")
    _, _, unc = r.track(scene_depth, poses[:2], with_covariance=True)
    _check_unc(unc, 2)


def test_sharded_with_covariance_matches_single_device(setup):
    """Class-level parity on the virtual mesh, uncertainty included (a
    non-divisible 3-pose batch exercises pad/unpad on the new output)."""
    m, K, scene_depth, poses = setup

    def build(devices):
        r = _refiner(m, K, devices=devices, use_pallas=False)
        r.set_scene_depth(scene_depth)
        return r

    out_s = build(8).refine(poses[:3], with_covariance=True)
    out_1 = build(1).refine(poses[:3], with_covariance=True)
    assert out_s[2].covariance.shape == (3, 6, 6)
    # unlike the plain refine program (bit-exact sharded, test_sharding),
    # the appended info einsum changes XLA's fusion of the shared final
    # cloud, so GSPMD reassociation costs a few ULP that the ICP
    # convergence latch amplifies to ~1e-3 pose deltas
    refined_s, refined_1 = np.asarray(out_s[0]), np.asarray(out_1[0])
    np.testing.assert_allclose(refined_s, refined_1, atol=2e-3)
    cov_s, cov_1 = np.asarray(out_s[2].covariance), np.asarray(out_1[2].covariance)
    assert np.abs(cov_s - cov_1).max() <= 1e-3 * np.abs(cov_1).max()
    np.testing.assert_allclose(np.asarray(out_s[1].fitness),
                               np.asarray(out_1[1].fitness), atol=1e-4)


@pytest.mark.slow
def test_refine_async_with_covariance(setup):
    """The streaming surface returns the uncertainty through PendingResult
    and fence, mixed with batches that did not request it."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K)
    r.set_scene_depth(scene_depth)
    p1 = r.refine_async(poses[:2], with_covariance=True)
    p2 = r.refine_async(poses[2:])
    assert p1.uncertainty is not None and p2.uncertainty is None
    out = prt.fence(p1, p2)
    assert len(out[0]) == 3 and len(out[1]) == 2
    _check_unc(out[0][2], 2)
    refined, res, unc = p1.wait()
    _check_unc(unc, 2)


@pytest.mark.slow
def test_schedule_with_covariance_last_level(setup):
    """schedule= computes the uncertainty of the FINAL level's fit."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K)
    r.set_scene_depth(scene_depth)
    refined, res, unc = r.refine(
        poses[:2], schedule=[(0.25, 8), (0.05, 16)], with_covariance=True)
    assert np.asarray(refined).shape == (2, 4, 4)
    _check_unc(unc, 2)


def test_multimodel_single_pose_squeeze_with_covariance(setup):
    """MultiModelRefiner's unbatched path squeezes the uncertainty too."""
    m, K, scene_depth, poses = setup
    mm = prt.MultiModelRefiner([m], K=K, width=W, height=H,
                               max_points=4096, window=64, use_pallas=False)
    mm.set_scene_depth(scene_depth)
    refined, res, unc = mm.refine(0, poses[0], with_covariance=True)
    assert np.asarray(refined).shape == (4, 4)
    assert np.asarray(unc.covariance).shape == (6, 6)
    assert np.isfinite(np.asarray(unc.covariance)).all()


def test_tracker_consumes_fused_covariance(setup):
    """End-to-end: PoseTracker.update accepts the fused covariance (the
    docstring loop in utils/fusion.py, one dispatch per frame)."""
    m, K, scene_depth, poses = setup
    r = _refiner(m, K)
    tracker = prt.PoseTracker(poses[0])
    tracker.predict()
    refined, res, unc = r.track(scene_depth, poses, with_covariance=True)
    best = int(r.rank(res)[0])
    fused = tracker.update(np.asarray(refined)[best],
                           np.asarray(unc.covariance)[best])
    assert fused is True
    assert np.isfinite(tracker.pose_mm).all()
