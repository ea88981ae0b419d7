"""On-device voxel-equivalent scene downsampling (scene.nn._pool_scene_grid
+ the PoseRefiner scene_pool plumbing): track() could not
honor scene_voxel_mm because the host voxel filter needs scatter; centroid
pooling over pixel blocks is the scatter-free grid equivalent."""
import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.scene.nn import _pool_scene_grid
from tests.test_icp import reference_demo_poses

W, H = 160, 120


def test_pool_scene_grid_centroids_and_validity():
    """Uniform-depth blocks pool to the exact centroid of their valid
    pixels; empty blocks come back invalid; normals renormalize."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    pts = rng.uniform(0.1, 0.5, (8, 12, 3)).astype(np.float32)
    pts[..., 2] = 0.3  # flat sheet: no depth-edge exclusion
    nrm = np.zeros((8, 12, 3), np.float32)
    nrm[..., 2] = -1.0
    mask = np.ones((8, 12), bool)
    mask[0:4, 0:4] = False  # one block fully invalid
    mask[4, 4] = False      # one block partially invalid
    p, n, m = _pool_scene_grid(jnp.asarray(pts), jnp.asarray(nrm),
                               jnp.asarray(mask), 4, 0.005)
    p, n, m = np.asarray(p), np.asarray(n), np.asarray(m)
    assert p.shape == (2, 3, 3) and m.shape == (2, 3)
    assert not m[0, 0] and m.sum() == 5
    # full block: plain centroid
    np.testing.assert_allclose(p[0, 1], pts[0:4, 4:8].mean(axis=(0, 1)),
                               rtol=1e-6)
    # partial block: centroid of the 15 valid pixels
    blk = pts[4:8, 4:8].reshape(-1, 3)
    keep = np.ones(16, bool)
    keep[0] = False
    np.testing.assert_allclose(p[1, 1], blk[keep].mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(n[m], axis=-1), 1.0, rtol=1e-6)


def test_pool_scene_grid_depth_edge_keeps_foreground():
    """A block straddling a depth edge must pool the FOREGROUND sheet only
    - never a ghost centroid between the surfaces (the artifact plain
    average pooling would fabricate)."""
    import jax.numpy as jnp

    pts = np.zeros((4, 4, 3), np.float32)
    pts[..., 2] = 0.6           # background wall
    pts[:, :2, 2] = 0.3         # foreground object on the left half
    nrm = np.zeros((4, 4, 3), np.float32)
    nrm[..., 2] = -1.0
    mask = np.ones((4, 4), bool)
    p, n, m = _pool_scene_grid(jnp.asarray(pts), jnp.asarray(nrm),
                               jnp.asarray(mask), 4, 0.005)
    assert bool(np.asarray(m)[0, 0])
    z = float(np.asarray(p)[0, 0, 2])
    assert abs(z - 0.3) < 1e-6, f"ghost point at z={z} (expected 0.3)"


@pytest.fixture(scope="module")
def nn_setup():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    _, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)
    rng = np.random.default_rng(3)
    d = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
    hyps = np.stack([
        np.asarray(geometry.pose_from_Rt(d @ pose2[:3, :3],
                                         pose2[:3, 3] + [2.0, -2.0, 3.0])),
        pose2,
    ])
    return m, K, depth, pose2, hyps


def test_track_auto_pool_honors_scene_voxel(nn_setup, caplog):
    """scene_voxel_mm + track(): the auto-derived centroid pool replaces
    the round-3 'cannot apply' warning; refinement still recovers."""
    import logging

    m, K, depth, pose2, hyps = nn_setup
    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1, scene="nn_bruteforce", scene_voxel_mm=4.0)
    with caplog.at_level(logging.INFO, logger="pose_refine"):
        refined, results = refiner.track(depth, hyps)
    pool = refiner._scene_pool_cache
    assert pool is not None and pool >= 2, f"auto pool derived {pool}"
    assert not any("cannot apply" in r.message for r in caplog.records)
    from pose_refine.utils.metrics import rotation_angle_deg

    err = rotation_angle_deg(np.asarray(refined), pose2)
    assert float(np.asarray(results.fitness).max()) > 0.8
    assert err.min() < 1.0
    # the pooled scene is genuinely smaller: the same call at full res
    full = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1, scene="nn_bruteforce")
    assert refiner._scene_perm(depth.shape, pool).shape[0] < \
        full._scene_perm(depth.shape).shape[0] // (pool * pool - 1)


def test_track_explicit_scene_pool_matches_quality(nn_setup):
    """scene_pool=<int> pins the factor; accuracy stays within the stride
    path's envelope (the pooled scene denoises, never degrades)."""
    m, K, depth, pose2, hyps = nn_setup
    from pose_refine.utils.metrics import rotation_angle_deg

    errs = {}
    for kw in ({"scene_pool": 2}, {"scene_stride": 2},
               {"scene_pool": 1}):
        refiner = prt.PoseRefiner(
            m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
            window=64, stride=1, scene="nn_bruteforce", **kw)
        refined, results = refiner.track(depth, hyps)
        key = tuple(sorted(kw.items()))
        errs[key] = float(rotation_angle_deg(np.asarray(refined), pose2).min())
        assert float(np.asarray(results.fitness).max()) > 0.8, kw
    for k, e in errs.items():
        assert e < 1.0, f"{k}: rot err {e}"


def test_scene_pool_validation():
    m = mesh.make_icosphere(radius=30.0, subdivisions=2)
    with pytest.raises(ValueError, match="scene_pool"):
        prt.PoseRefiner(m, K=geometry.LINEMOD_K, scene_pool=0)
    from pose_refine.scene.nn import SceneNN
    with pytest.raises(ValueError, match="alternative"):
        SceneNN.from_depth_device(
            np.zeros((8, 8), np.int32), geometry.LINEMOD_K,
            stride=2, pool=2)
    # the explicit pool>1 + stride>1 misconfig must fail at __init__ where
    # the other invariants are checked, not as a trace-time error from
    # inside the first track() jit
    with pytest.raises(ValueError, match="alternative"):
        prt.PoseRefiner(m, K=geometry.LINEMOD_K, scene="nn_bruteforce",
                        scene_pool=2, scene_stride=2)


def test_scene_pool_auto_defers_on_empty_first_frame(caplog):
    """An unrepresentative first frame (no valid depth: occlusion/detector
    gap) must NOT pin pool=1 for the session's lifetime - derivation
    defers to the next frame with data. Host inputs that are not ndarrays
    (plain lists) must still derive, not be misread as device-resident."""
    import logging

    m = mesh.make_icosphere(radius=30.0, subdivisions=2)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    r = prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_bruteforce",
                        scene_voxel_mm=8.0, use_pallas=False)
    with caplog.at_level(logging.WARNING):
        pool = r._resolve_scene_pool(np.zeros((H, W), np.int32))
    assert pool == 1
    assert r._scene_pool_cache is None, "empty frame must not cache"
    assert any("deferred" in rec.message for rec in caplog.records)
    # 8 mm voxel at 600 mm depth, fx ~143: pixel pitch ~4.2 mm -> pool 2
    frame = np.full((H, W), 600, np.int32)
    pool = r._resolve_scene_pool(frame.tolist())  # a plain list is host data
    assert pool == 2
    assert r._scene_pool_cache == 2, "valid frame derives and caches"
    # cached: later empty frames keep the derived factor
    assert r._resolve_scene_pool(np.zeros((H, W), np.int32)) == 2
