import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh
import pose_refine.ops.rasterize as R

W, H = 160, 120


def small_K():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def test_models_package_alias():
    from pose_refine import models

    m = models.make_icosphere(radius=5.0, subdivisions=1)
    assert isinstance(m, models.Model)


def test_pallas_roi_non_tile_multiple():
    # ROI dims that are no power of two, at an odd origin: every pixel
    # index the kernel writes must land inside the crop
    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    tris = m.tris[mesh.morton_order(m.tris)]
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32))
    )
    roi = (33, 17, 90, 70)
    got = np.asarray(rasterize_pallas(tris, pose[None], W, H, proj, roi=roi, interpret=True))
    want = np.asarray(R.rasterize_dense(tris, pose[None], W, H, proj, roi=roi))
    assert got.shape == (1, 70, 90)
    assert (got != want).mean() < 1e-3


def test_render_dispatcher_cpu_fallback():
    # on CPU the platform's choice is the XLA scatter path (the kernel runs
    # there only in the interpreter, by explicit request)
    m = mesh.make_icosphere(radius=30.0, subdivisions=1)
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32))
    )
    out = np.asarray(prt.render(m.tris, pose[None], W, H, proj))
    want = np.asarray(R.rasterize_dense(m.tris, pose[None], W, H, proj))
    np.testing.assert_array_equal(out, want)


def test_refiner_requires_scene():
    m = mesh.make_icosphere(radius=30.0, subdivisions=1)
    r = prt.PoseRefiner(m, K=small_K(), width=W, height=H, use_pallas=False)
    with pytest.raises(RuntimeError, match="set_scene"):
        r.refine(np.eye(4, dtype=np.float32))


def test_refiner_empty_scene_depth():
    # a scene with no valid pixels: ROI collapses, ICP returns identity
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=2)
    r = prt.PoseRefiner(m, K=small_K(), width=W, height=H, use_pallas=False)
    r.set_scene_depth(np.zeros((H, W), np.int32))
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32))
    )
    refined, res = r.refine(pose)
    np.testing.assert_allclose(np.asarray(refined), pose, atol=1e-5)
    assert float(res.fitness) == 0.0


def test_pose_renderer_requires_K():
    m = mesh.make_icosphere(radius=30.0, subdivisions=1)
    r = prt.PoseRenderer(m)
    with pytest.raises(RuntimeError, match="set_K"):
        r.render_depth(np.eye(4, dtype=np.float32))


def test_pose_renderer_deferred_K_keeps_constructor_dims():
    """Constructor width/height must survive a deferred set_K_width_height
    (they were silently discarded when K was absent, forcing the caller to
    re-pass dims the constructor had already accepted)."""
    m = mesh.make_icosphere(radius=30.0, subdivisions=1)
    r = prt.PoseRenderer(m, width=320, height=240)
    r.set_K_width_height(small_K())
    assert (r.width, r.height) == (320, 240)
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))
    assert np.asarray(r.render_depth(pose)).shape == (1, 240, 320)
    # explicit dims still override
    r.set_K_width_height(small_K(), 160, 120)
    assert (r.width, r.height) == (160, 120)
