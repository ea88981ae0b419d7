import numpy as np
import pytest

from pose_refine import geometry, mesh
import pose_refine.ops.rasterize as R  # the module (ops exports a same-named function)
from pose_refine.utils import oracle


W, H = 160, 120


def small_K():
    # scale LINEMOD K down to a 160x120 image
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    return K


def make_poses(n, rng, z=300.0):
    thetas = rng.uniform(-np.pi, np.pi, size=(n, 3)).astype(np.float32)
    R3 = np.asarray(geometry.euler_to_rotation(thetas))
    t = np.stack(
        [
            rng.uniform(-20, 20, size=n),
            rng.uniform(-20, 20, size=n),
            rng.uniform(z * 0.8, z * 1.2, size=n),
        ],
        axis=-1,
    ).astype(np.float32)
    return np.asarray(geometry.pose_from_Rt(R3, t))


@pytest.fixture(scope="module")
def scene_setup():
    rng = np.random.default_rng(42)
    m = mesh.make_icosphere(radius=40.0, subdivisions=2)  # 320 tris
    K = small_K()
    proj = geometry.compute_proj(K, W, H)
    poses = make_poses(4, rng)
    return m, K, proj, poses


def test_dense_matches_scanline_oracle(scene_setup):
    m, K, proj, poses = scene_setup
    got = np.asarray(R.rasterize_dense(m.tris, poses, W, H, proj))
    want = oracle.render_scanline(m.tris, poses, W, H, np.asarray(proj))
    mismatched = np.abs(got.astype(np.int64) - want.astype(np.int64)) > 1
    assert mismatched.mean() < 2e-4, f"{mismatched.sum()} pixels differ by >1mm"
    # rendered area should be substantial and depths plausible (~240-360mm)
    assert (want > 0).sum() > 500
    valid = want[want > 0]
    assert 150 < valid.min() < valid.max() < 500


def test_scatter_matches_dense(scene_setup):
    m, K, proj, poses = scene_setup
    ext = R.max_bbox_extent(m.tris, poses, W, H, proj)
    assert ext <= 32, "test mesh triangles should fit the default window"
    d = np.asarray(R.rasterize_dense(m.tris, poses, W, H, proj))
    s = np.asarray(R.rasterize_scatter(m.tris, poses, W, H, proj, window=32))
    np.testing.assert_array_equal(s, d)


def test_roi_crop(scene_setup):
    m, K, proj, poses = scene_setup
    roi = (40, 20, 64, 64)
    full = np.asarray(R.rasterize_dense(m.tris, poses, W, H, proj))
    crop = np.asarray(R.rasterize_dense(m.tris, poses, W, H, proj, roi=roi))
    assert crop.shape == (len(poses), 64, 64)
    np.testing.assert_array_equal(crop, full[:, 20:84, 40:104])
    s = np.asarray(R.rasterize_scatter(m.tris, poses, W, H, proj, roi=roi, window=32))
    np.testing.assert_array_equal(s, crop)


def test_offscreen_render_is_empty():
    # object far outside the frustum -> clamped bboxes are empty -> all zeros
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([5000, 0, 300], np.float32))
    )
    out = np.asarray(R.rasterize_dense(m.tris, pose[None], W, H, proj))
    assert (out == 0).all()
    s = np.asarray(R.rasterize_scatter(m.tris, pose[None], W, H, proj))
    assert (s == 0).all()


def test_behind_camera_matches_oracle():
    # the reference does NOT cull behind-camera geometry (it writes negative
    # depths); we stay bit-faithful to that quirk rather than "fixing" it.
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([0, 0, -500], np.float32))
    )
    got = np.asarray(R.rasterize_dense(m.tris, pose[None], W, H, proj))
    want = oracle.render_scanline(m.tris, pose[None], W, H, np.asarray(proj))
    mism = (got != want).mean()
    assert mism < 1e-3


def test_depth_values_front_surface(scene_setup):
    # sphere at z=300: nearest depth must be about z - radius
    m, K, proj, _ = scene_setup
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32))
    )
    out = np.asarray(R.rasterize_dense(m.tris, pose[None], W, H, proj))
    valid = out[out > 0]
    assert abs(int(valid.min()) - 260) < 5  # 300 - 40, icosphere is slightly faceted
    # deepest *visible* (nearest-surface) pixel is the silhouette ring at
    # z0 - r^2/z0 = 294.7; back faces lose the z-min everywhere else
    assert abs(int(valid.max()) - 295) < 8


def test_converters(scene_setup):
    from pose_refine.ops import convert

    m, K, proj, poses = scene_setup
    raw = R.rasterize_dense(m.tris, poses, W, H, proj)
    dep = np.asarray(convert.raw_to_depth_u16(raw))
    mask = np.asarray(convert.raw_to_mask_u8(raw))
    assert dep.dtype == np.uint16 and mask.dtype == np.uint8
    np.testing.assert_array_equal(dep, np.asarray(raw).astype(np.uint16))
    np.testing.assert_array_equal(mask > 0, np.asarray(raw) > 0)
    d2, m2 = convert.raw_to_depth_mask(raw)
    np.testing.assert_array_equal(np.asarray(d2), dep)
    np.testing.assert_array_equal(np.asarray(m2), mask)


@pytest.mark.slow
def test_reference_mesh_scatter_parity():
    path = mesh.find_reference_ply()
    if path is None:
        pytest.skip("reference obj_06.ply not mounted")
    m = mesh.Model.load(path, verbose=False)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, 640, 480)
    rng = np.random.default_rng(7)
    poses = make_poses(2, rng, z=400.0)
    roi = (192, 128, 256, 224)
    d = np.asarray(R.rasterize_dense(m.tris, poses, 640, 480, proj, roi=roi))
    s = np.asarray(R.rasterize_scatter(m.tris, poses, 640, 480, proj, roi=roi, window=32))
    np.testing.assert_array_equal(s, d)


class TestPallas:
    """The GPU raster kernel vs the dense oracle, in the Pallas interpreter
    (the compiled kernel is checked on the card by chip_smoke.py and the
    chip-marked tests below)."""

    def test_matches_dense(self, scene_setup):
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        m, K, proj, poses = scene_setup
        tris = m.tris[mesh.morton_order(m.tris)]
        want = np.asarray(R.rasterize_dense(tris, poses, W, H, proj))
        got = np.asarray(rasterize_pallas(tris, poses, W, H, proj, interpret=True))
        assert (got != want).mean() < 1e-4

    def test_roi(self, scene_setup):
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        m, K, proj, poses = scene_setup
        tris = m.tris[mesh.morton_order(m.tris)]
        roi = (40, 20, 64, 64)
        want = np.asarray(R.rasterize_dense(tris, poses, W, H, proj, roi=roi))
        got = np.asarray(rasterize_pallas(tris, poses, W, H, proj, roi=roi, interpret=True))
        assert got.shape == (len(poses), 64, 64)
        assert (got != want).mean() < 1e-4

    def test_unordered_triangles_still_correct(self, scene_setup):
        # Morton order is a perf optimization, never a correctness requirement
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        m, K, proj, poses = scene_setup
        want = np.asarray(R.rasterize_dense(m.tris, poses[:1], W, H, proj))
        got = np.asarray(rasterize_pallas(m.tris, poses[:1], W, H, proj, interpret=True))
        assert (got != want).mean() < 1e-4

    def test_offscreen_empty(self):
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        m = mesh.make_icosphere(radius=10.0, subdivisions=1)
        proj = geometry.compute_proj(small_K(), W, H)
        pose = np.asarray(
            geometry.pose_from_Rt(np.eye(3, dtype=np.float32), np.array([5000, 0, 300], np.float32))
        )
        out = np.asarray(rasterize_pallas(m.tris, pose[None], W, H, proj, interpret=True))
        assert (out == 0).all()


def test_morton_order_is_permutation():
    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    perm = mesh.morton_order(m.tris)
    assert sorted(perm.tolist()) == list(range(m.n_tris))


def test_obj06_cpp_baseline_bit_parity():
    """Full-frame obj_06 @640x480: the jitted scatter rasterizer and the
    native C++ baseline implement the same arithmetic - expect bit equality
    (the reference asserted exact CPU==CUDA equality the same way,
    cuda_renderer/test.cpp:94-106)."""
    from pose_refine import native

    path = mesh.find_reference_ply()
    if path is None:
        pytest.skip("reference obj_06.ply not mounted")
    if not native.native_available():
        pytest.skip("g++ unavailable")
    m = mesh.Model.load(path, verbose=False)
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, 640, 480)
    rng = np.random.default_rng(3)
    poses = make_poses(2, rng, z=350.0)
    a = np.asarray(R.rasterize_scatter(m.tris, poses, 640, 480, proj, window=8))
    b = native.cpu_render_baseline(m.tris, poses, np.asarray(proj), 640, 480)
    mismatch = (a != b).mean()
    assert mismatch < 1e-5, f"{(a != b).sum()} pixels differ"


def test_screen_fields_bitwise_equals_screen_triangles():
    """The field-layout vertex transform (used by the kernel path) must be
    BIT-IDENTICAL to screen_triangles (used by the dense/scatter paths and
    the C++-baseline parity tests) - an ulp shift would flip edge-pixel
    coverage between backends."""
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    proj = geometry.compute_proj(K, 160, 120)
    rng = np.random.default_rng(3)
    poses = []
    for _ in range(4):
        d = np.asarray(geometry.euler_to_rotation(rng.uniform(-1, 1, 3).astype(np.float32)))
        poses.append(np.asarray(geometry.pose_from_Rt(d, np.array([0, 0, 300], np.float32))))
    poses = np.stack(poses)

    pts2, zcam = R.screen_triangles(m.tris, poses, proj, 160, 120)
    ax, ay, bx, by, cx, cy, z0, z1, z2 = R.screen_fields(m.tris, poses, proj, 160, 120)
    pts2, zcam = np.asarray(pts2), np.asarray(zcam)
    for got, want in (
        (ax, pts2[..., 0, 0]), (ay, pts2[..., 0, 1]),
        (bx, pts2[..., 1, 0]), (by, pts2[..., 1, 1]),
        (cx, pts2[..., 2, 0]), (cy, pts2[..., 2, 1]),
        (z0, zcam[..., 0]), (z1, zcam[..., 1]), (z2, zcam[..., 2]),
    ):
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.slow
def test_per_pose_triangle_tables():
    """(N, T, 3, 3) per-pose triangle tables (multi-model batches) must
    rasterize identically to rendering each pose with its own mesh."""
    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    rng = np.random.default_rng(12)
    m1 = mesh.make_bumpy_sphere(radius=50.0, subdivisions=2)
    m2 = mesh.make_bumpy_sphere(radius=30.0, subdivisions=2)
    t1 = m1.tris[mesh.morton_order(m1.tris)]
    t2 = m2.tris[mesh.morton_order(m2.tris)]
    assert t1.shape == t2.shape  # same subdivision level
    proj = geometry.compute_proj(small_K(), W, H)
    poses = make_poses(2, rng)
    per_pose = np.stack([t1, t2])  # pose 0 renders m1, pose 1 renders m2

    for fn in (
        R.rasterize_dense,
        lambda t, p, w, h, pr: rasterize_pallas(t, p, w, h, pr, interpret=True),
    ):
        multi = np.asarray(fn(per_pose, poses, W, H, proj))
        one = np.asarray(fn(t1, poses[:1], W, H, proj))
        two = np.asarray(fn(t2, poses[1:], W, H, proj))
        np.testing.assert_array_equal(multi[0], one[0])
        np.testing.assert_array_equal(multi[1], two[0])


def _big_quad_scene():
    """A 120x80 mm quad 200 mm from the camera (bbox ~90 px, far wider than
    the scatter path's 32 px window) in front of a small sphere."""
    quad = np.array([[[-60, -40, 0], [60, -40, 0], [60, 40, 0]],
                     [[-60, -40, 0], [60, 40, 0], [-60, 40, 0]]], np.float32)
    m = mesh.make_icosphere(radius=10.0, subdivisions=1)
    tris = np.concatenate([m.tris, quad]).astype(np.float32)
    proj = geometry.compute_proj(small_K(), W, H)
    poses = np.stack([
        np.asarray(geometry.pose_from_Rt(
            np.asarray(geometry.euler_to_rotation(np.float32(a))),
            np.array([5, -3, 200], np.float32)))
        for a in ([0, 0, 0], [0.3, -0.2, 0.5])])
    return tris, poses, proj


@pytest.mark.parametrize("path", ["scatter", "scatter_w8", "kernel", "kernel_roi"])
def test_large_triangles_exact(path):
    """No size cap: triangles whose bbox spans many windows / loop
    iterations render exactly like the dense oracle on every path."""
    tris, poses, proj = _big_quad_scene()
    assert R.max_bbox_extent(tris, poses, W, H, proj) > 64
    roi = (9, 7, 100, 90) if path == "kernel_roi" else (0, 0, 0, 0)
    want = np.asarray(R.rasterize_dense(tris, poses, W, H, proj, roi=roi))
    if path.startswith("scatter"):
        window = 8 if path == "scatter_w8" else 32
        got = R.rasterize_scatter(tris, poses, W, H, proj, roi=roi, window=window)
    else:
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        got = rasterize_pallas(tris, poses, W, H, proj, roi=roi, interpret=True)
    got = np.asarray(got)
    assert (want > 0).mean() > 0.2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_tris", [1, 127, 129])
def test_kernel_pads_triangle_blocks(n_tris):
    """Triangle counts that do not fill the kernel's 128-lane blocks: the
    padded lanes write nothing."""
    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    tris = m.tris[mesh.morton_order(m.tris)][:n_tris]
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))[None]
    want = np.asarray(R.rasterize_dense(tris, pose, W, H, proj))
    got = np.asarray(rasterize_pallas(tris, pose, W, H, proj, interpret=True))
    assert got.shape == (1, H, W)
    assert (got != want).mean() < 1e-4


def test_kernel_setup_culls_degenerate_and_offscreen():
    """_triangle_setup gives zero-area, off-screen and padded triangles an
    empty pixel loop (area 0) and every visible one a non-empty loop."""
    from pose_refine.ops.rasterize_pallas import BLOCK, _triangle_setup

    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))[None]
    tris = np.array([
        [[0, 0, 0], [10, 0, 0], [0, 10, 0]],          # visible
        [[0, 0, 0], [10, 0, 0], [20, 0, 0]],          # zero area
        [[4000, 0, 0], [4010, 0, 0], [4000, 10, 0]],  # off-screen
    ], np.float32)
    coef, box = _triangle_setup(tris, pose, proj, W, H, (0, 0, 0, 0))
    assert coef.shape == (1, 16, BLOCK) and box.shape == (1, 4, BLOCK)
    area = np.asarray(box)[0, 3]
    assert area[0] > 0
    assert (area[1:] == 0).all()
    assert np.isfinite(np.asarray(coef)).all()


def test_kernel_rejects_int32_index_overflow():
    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    m = mesh.make_icosphere(radius=10.0, subdivisions=0)
    poses = np.tile(np.eye(4, dtype=np.float32), (7000, 1, 1))
    with pytest.raises(ValueError, match="int32"):
        rasterize_pallas(m.tris, poses, 640, 480,
                         geometry.compute_proj(geometry.LINEMOD_K, 640, 480),
                         interpret=True)


def test_render_backend_dispatch():
    m = mesh.make_icosphere(radius=30.0, subdivisions=1)
    proj = geometry.compute_proj(small_K(), W, H)
    pose = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.array([0, 0, 300], np.float32)))[None]
    want = np.asarray(R.rasterize_dense(m.tris, pose, W, H, proj))
    got = np.asarray(R.render(m.tris, pose, W, H, proj, backend="pallas",
                              interpret=True))
    assert (got != want).mean() < 1e-4
    with pytest.raises(ValueError, match="unknown rasterize backend"):
        R.render(m.tris, pose, W, H, proj, backend="tile32")


@pytest.mark.chip
def test_compiled_kernel_matches_dense_on_gpu(gpu):
    """The kernel as compiled for the card (no interpreter) against the
    oracles at a real frame size: XLA's scatter path on the card (equal to
    the dense oracle by the CPU tests above), and rasterize_dense on the
    CPU device for one pose (its full-frame GPU compile takes minutes)."""
    import jax

    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=4)
    tris = m.tris[mesh.morton_order(m.tris)]
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, 640, 480)
    poses = make_poses(8, np.random.default_rng(5))
    got = np.asarray(rasterize_pallas(tris, poses, 640, 480, proj))
    want = np.asarray(R.rasterize_scatter(tris, poses, 640, 480, proj))
    assert (want > 0).any()
    assert (got != want).mean() <= 1e-4
    with jax.default_device(jax.devices("cpu")[0]):
        dense = np.asarray(R.rasterize_dense(tris, poses[:1], 640, 480, proj))
    assert (got[:1] != dense).mean() <= 1e-4
