"""Property-based tests (hypothesis): invariants over random inputs,
the systematic version of the reference's spot-check test style."""

import numpy as np
from hypothesis import given, settings, strategies as st

from pose_refine import geometry
from pose_refine.scene.kdtree import build_kdtree
from pose_refine.scene.nn import SceneNN

finite_angle = st.floats(-3.0, 3.0, allow_nan=False, width=32)


@settings(max_examples=25, deadline=None)
@given(st.tuples(finite_angle, finite_angle, finite_angle))
def test_euler_rotation_is_orthonormal(theta):
    R = np.asarray(geometry.euler_to_rotation(np.array(theta, np.float32)))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1.0) < 1e-5


@settings(max_examples=15, deadline=None)
@given(
    st.integers(min_value=11, max_value=400),
    st.integers(min_value=0, max_value=2**31 - 1),
)
def test_kdtree_nn_always_exact(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    nrm = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=100.0)
    q = rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32)
    q[:, 2] += 0.5
    dst, _, valid = scene.query(q)
    assert bool(np.asarray(valid).all())
    got = ((np.asarray(dst) - q) ** 2).sum(-1)
    want = ((q[:, None, :] - pts[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=2, max_value=500), st.integers(min_value=0, max_value=2**31 - 1))
def test_kdtree_build_partitions(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    tree = build_kdtree(pts, pts.copy(), leaf_size=10)
    leaf = tree.child[:, 0] < 0
    sizes = tree.bounds[leaf, 1] - tree.bounds[leaf, 0]
    assert sizes.sum() == n
    assert (sizes >= 1).all() and (sizes <= 10).all()


@settings(max_examples=20, deadline=None)
@given(
    st.integers(min_value=0, max_value=639),
    st.integers(min_value=0, max_value=479),
    st.integers(min_value=1, max_value=5000),
)
def test_pixel_point_roundtrip(x, y, d):
    K = geometry.LINEMOD_K
    pt = geometry.dep2pcd(x, y, d, K)
    xyd = np.asarray(geometry.pcd2dep(pt, K))
    assert xyd[0] == x and xyd[1] == y and xyd[2] == d


def test_viz_helpers(tmp_path):
    from pose_refine.utils import viz

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    viz.save_point_cloud(str(tmp_path / "c.ply"), pts, nrm)
    from pose_refine.mesh import load_ply

    v, f = load_ply(str(tmp_path / "c.ply"))
    np.testing.assert_allclose(v, pts, atol=1e-4)

    depth = np.zeros((48, 64), np.int32)
    depth[10:30, 20:50] = 300
    viz.save_depth_ppm(str(tmp_path / "d.ppm"), depth)
    assert (tmp_path / "d.ppm").stat().st_size > 100
    art = viz.ascii_depth(depth)
    assert "#" in art or "o" in art


def test_grid_morton_perm_is_permutation_and_local():
    from pose_refine.scene.nn import _grid_morton_perm

    h, w = 37, 53  # non-power-of-two dims
    perm = _grid_morton_perm(h, w)
    assert sorted(perm.tolist()) == list(range(h * w))
    # locality: consecutive entries stay within a small pixel neighborhood
    yy, xx = np.divmod(perm, w)
    d = np.abs(np.diff(yy)) + np.abs(np.diff(xx))
    assert np.median(d) <= 2


def test_scene_from_depth_device_matches_host_build():
    """The fully-on-device NN scene (grid table + far-parked invalid
    pixels + static Morton order) must answer Scene.query identically to
    the host build (compacted cloud + kd reorder) for every query: same
    dst point, same normal, same validity."""
    import jax.numpy as jnp

    from pose_refine import geometry, mesh
    from pose_refine.ops import rasterize as rz
    from pose_refine.scene.nn import SceneNN

    W, H = 160, 120
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    proj = geometry.compute_proj(K, W, H)
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    tris = jnp.asarray(m.tris[mesh.morton_order(m.tris)])
    pose = np.asarray(
        geometry.pose_from_Rt(np.eye(3, dtype=np.float32),
                              np.array([0, 0, 300], np.float32))
    )
    depth = np.asarray(
        rz.rasterize_scatter(tris, jnp.asarray(pose)[None], W, H, proj, window=32)
    )[0]

    host = SceneNN.from_depth(depth, K, backend="bruteforce")
    dev = SceneNN.from_depth_device(depth, K)
    assert dev.backend == "bruteforce"

    rng = np.random.default_rng(3)
    q_near = np.asarray(host.points) + rng.normal(
        0, 0.004, host.points.shape).astype(np.float32)
    q_far = q_near + np.float32([0.5, 0, 0])
    for q in (jnp.asarray(q_near[:800]), jnp.asarray(q_far[:200])):
        dh, nh, vh = map(np.asarray, host.query(q))
        dd, nd, vd = map(np.asarray, dev.query(q))
        np.testing.assert_array_equal(vh, vd)
        np.testing.assert_allclose(dh[vh], dd[vd], atol=1e-7)
        np.testing.assert_allclose(nh[vh], nd[vd], atol=1e-7)


def test_scene_from_depth_device_stride():
    """stride=2 subsamples the scene grid (the device analog of voxel
    downsampling): queries at kept pixels still associate exactly."""
    import jax.numpy as jnp

    from pose_refine import geometry
    from pose_refine.scene.nn import SceneNN

    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    rng = np.random.default_rng(5)
    depth = (rng.uniform(250, 350, (64, 96)) *
             (rng.random((64, 96)) > 0.3)).astype(np.int32)
    full = SceneNN.from_depth_device(depth, K)
    half = SceneNN.from_depth_device(depth, K, stride=2)
    assert half.points.shape[0] * 4 == full.points.shape[0]
    # a query exactly AT a kept scene point must hit it
    kept = np.asarray(half.points)
    kept = kept[kept[:, 0] < 1e5][:100]  # valid entries only
    _, _, v = half.query(jnp.asarray(kept))
    assert np.asarray(v).all()
