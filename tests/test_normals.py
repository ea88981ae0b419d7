import numpy as np

from pose_refine import geometry
from pose_refine.ops.normals import estimate_normals


def numpy_normals_oracle(depth, K, r=5, diff_t=50, dist_t=2000):
    """Direct per-pixel reimplementation of the LINEMOD recipe
    (common.cpp:17-107) as an independent oracle."""
    h, w = depth.shape
    out = np.zeros((h, w, 3), np.float32)
    offsets = [(-r, -r), (0, -r), (r, -r), (-r, 0), (r, 0), (-r, r), (0, r), (r, r)]
    d64 = depth.astype(np.int64)
    for y in range(r, h - r - 1):
        for x in range(r, w - r - 1):
            d = d64[y, x]
            if d >= dist_t:
                continue
            A = [0, 0, 0, 0]
            b = [0, 0]
            for dx, dy in offsets:
                delta = d64[y + dy, x + dx] - d
                f = 1 if abs(delta) < diff_t else 0
                A[0] += f * dx * dx
                A[1] += f * dx * dy
                A[3] += f * dy * dy
                b[0] += f * dx * delta
                b[1] += f * dy * delta
            det = A[0] * A[3] - A[1] * A[1]
            ddx = A[3] * b[0] - A[1] * b[1]
            ddy = -A[1] * b[0] + A[0] * b[1]
            nx = np.float32(K[0, 0] * ddx)
            ny = np.float32(K[1, 1] * ddy)
            nz = np.float32(-det * d)
            nrm = np.sqrt(nx * nx + ny * ny + nz * nz)
            if nrm > 0:
                out[y, x] = [nx / nrm, ny / nrm, nz / nrm]
    return out


def test_normals_match_oracle(rng):
    K = geometry.LINEMOD_K
    h, w = 40, 50
    # smooth surface + sharp step + background zeros
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (300 + 2 * xx + 1 * yy).astype(np.int32)
    depth[:, 35:] += 500  # depth discontinuity
    depth[:8, :8] = 0  # background
    got = np.asarray(estimate_normals(depth, K))
    want = numpy_normals_oracle(depth, K)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flat_plane_faces_camera():
    K = geometry.LINEMOD_K
    depth = np.full((32, 32), 500, np.int32)
    n = np.asarray(estimate_normals(depth, K))
    interior = n[6:25, 6:25]
    np.testing.assert_allclose(interior, np.broadcast_to([0, 0, -1.0], interior.shape), atol=1e-6)
    # border region is invalid
    assert (n[:5] == 0).all() and (n[:, :5] == 0).all()
    assert (n[-6:] == 0).all() and (n[:, -6:] == 0).all()


def test_far_pixels_invalid():
    K = geometry.LINEMOD_K
    depth = np.full((32, 32), 2500, np.int32)  # beyond 2000mm gate
    n = np.asarray(estimate_normals(depth, K))
    assert (n == 0).all()


def test_slanted_plane_normal_direction():
    K = geometry.LINEMOD_K
    h, w = 48, 48
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (600 + 4 * xx).astype(np.int32)  # tilted about the y axis
    n = np.asarray(estimate_normals(depth, K))
    mid = n[h // 2, w // 2]
    assert mid[2] < 0  # facing the camera
    assert mid[0] > 0.1  # depth increases with +x -> normal tilts +x
    assert abs(mid[1]) < 1e-3


def test_host_scene_arrays_match_device_path():
    """The numpy host twin used by SceneNN.from_depth must match the jnp
    device functions bit-for-bit (same int accumulators, f32 products)."""
    import jax.numpy as jnp

    from pose_refine import geometry
    from pose_refine.ops.depth_to_cloud import depth_image_to_points
    from pose_refine.ops.normals import estimate_normals
    from pose_refine.scene.nn import _depth_scene_arrays_host

    rng = np.random.default_rng(7)
    depth = (rng.uniform(200, 1000, (48, 64)) *
             (rng.random((48, 64)) > 0.25)).astype(np.int32)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.1

    hp, hn, hm = _depth_scene_arrays_host(depth, K)
    dp, dm = depth_image_to_points(depth, K)
    dn = estimate_normals(depth, K)
    np.testing.assert_array_equal(hm, np.asarray(dm))
    # XLA contracts (u-cx)/fx*z into FMAs (--xla_allow_excess_precision);
    # numpy cannot - agreement is one ULP, i.e. sub-nanometer at meter scale
    np.testing.assert_allclose(hp, np.asarray(dp), rtol=5e-7, atol=1e-9)
    np.testing.assert_allclose(hn, np.asarray(dn), rtol=2e-6, atol=2e-7)
