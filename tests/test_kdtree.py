import numpy as np
import pytest

from pose_refine.scene.kdtree import build_kdtree
from pose_refine.scene.nn import SceneNN, _nn_bruteforce


def random_cloud(rng, n=3000):
    pts = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def brute_nn_numpy(queries, pts):
    d = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return d.argmin(axis=1), d.min(axis=1)


def test_tree_invariants(rng):
    pts, nrm = random_cloud(rng, 2500)
    tree = build_kdtree(pts, nrm, leaf_size=10)

    leaf = tree.child[:, 0] < 0
    sizes = tree.bounds[leaf, 1] - tree.bounds[leaf, 0]
    assert (sizes >= 1).all() and (sizes <= 10).all()

    # leaf ranges partition [0, n)
    order = np.argsort(tree.bounds[leaf, 0])
    lb = tree.bounds[leaf][order]
    assert lb[0, 0] == 0 and lb[-1, 1] == len(pts)
    assert (lb[1:, 0] == lb[:-1, 1]).all()

    # reordered points are a permutation of the input, normals follow points
    got = np.sort(tree.points.view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)
    want = np.sort(pts.view([("x", "f4"), ("y", "f4"), ("z", "f4")]), axis=0)
    np.testing.assert_array_equal(got, want)
    lookup = {tuple(p): tuple(n) for p, n in zip(pts, nrm)}
    for i in range(0, len(pts), 97):
        assert lookup[tuple(tree.points[i])] == tuple(tree.normals[i])

    # children bboxes nest inside the parent's split bbox
    for node in np.nonzero(~leaf)[0][:50]:
        l, r = tree.bounds[node]
        seg = tree.points[l:r]
        np.testing.assert_allclose(tree.bbox[node, 0::2], seg.min(0), rtol=1e-6)
        np.testing.assert_allclose(tree.bbox[node, 1::2], seg.max(0), rtol=1e-6)


def test_kdtree_nn_matches_bruteforce(rng):
    pts, nrm = random_cloud(rng, 3000)
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=10.0)
    queries = rng.uniform(-0.3, 0.3, size=(500, 3)).astype(np.float32)
    queries[:, 2] += 0.5

    dst, dnrm, valid = scene.query(queries)
    assert bool(np.asarray(valid).all())
    _, want_d = brute_nn_numpy(queries, np.asarray(scene.points))
    got_d = ((np.asarray(dst) - queries) ** 2).sum(-1)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-12)


def test_bruteforce_backend_matches_kdtree(rng):
    pts, nrm = random_cloud(rng, 2048 + 123)  # force padding in the chunked scan
    queries = rng.uniform(-0.3, 0.3, size=(300, 3)).astype(np.float32)
    queries[:, 2] += 0.5

    kd = SceneNN.from_cloud(pts, nrm, max_dist_diff=10.0, backend="kdtree")
    bf = SceneNN.from_cloud(pts, nrm, max_dist_diff=10.0, backend="bruteforce")
    d1, n1, v1 = kd.query(queries)
    d2, n2, v2 = bf.query(queries)
    # equal distances (indices may differ on exact ties)
    g1 = ((np.asarray(d1) - queries) ** 2).sum(-1)
    g2 = ((np.asarray(d2) - queries) ** 2).sum(-1)
    np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_max_dist_gate(rng):
    pts, nrm = random_cloud(rng, 500)
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=0.01)
    far = np.array([[10.0, 10.0, 10.0]], np.float32)
    _, _, valid = scene.query(far)
    assert not bool(np.asarray(valid)[0])


def test_duplicate_points_build(rng):
    # degenerate input: many identical points must still build (tie-alternation
    # balancing, pcd_scene.cpp:118-133) and query correctly
    pts = np.tile(np.array([[0.1, 0.2, 0.5]], np.float32), (64, 1))
    nrm = np.tile(np.array([[0, 0, -1.0]], np.float32), (64, 1))
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=1.0)
    dst, _, valid = scene.query(np.array([[0.1, 0.2, 0.49]], np.float32))
    assert bool(np.asarray(valid)[0])
    np.testing.assert_allclose(np.asarray(dst)[0], [0.1, 0.2, 0.5], rtol=1e-6)


def test_one_ulp_extent_builds_as_leaf(rng):
    """f32-degenerate node: when the widest extent is 1 ULP, the bbox
    midpoint rounds onto the boundary and one partition side comes out
    empty - before the guard this built an empty child and crashed the
    next level's bbox reduction (zero-size min). Such nodes must stay
    (oversized) leaves, and queries must stay exact."""
    x_lo = np.float32(1.0)
    x_hi = np.nextafter(x_lo, np.float32(2.0), dtype=np.float32)
    pts = np.full((12, 3), 0.5, np.float32)
    pts[:, 0] = x_hi
    pts[0, 0] = x_lo  # single point at the low boundary -> empty 'less' side
    nrm = np.tile(np.array([[0, 0, -1.0]], np.float32), (12, 1))
    tree = build_kdtree(pts, nrm, leaf_size=10)  # must not raise
    # root cannot split a 1-ULP extent: stays one oversized leaf
    assert tree.child[0, 0] == -1 and tuple(tree.bounds[0]) == (0, 12)

    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=1.0)
    q = np.array([[x_lo, 0.5, 0.49]], np.float32)
    dst, _, valid = scene.query(q)
    assert bool(np.asarray(valid)[0])
    np.testing.assert_allclose(np.asarray(dst)[0], [x_lo, 0.5, 0.5], rtol=0)

    from pose_refine import native

    if native.native_available():
        t_cc = build_kdtree(pts, nrm, leaf_size=10, backend="native")
        np.testing.assert_array_equal(t_cc.points, tree.points)
        np.testing.assert_array_equal(t_cc.child, tree.child)
        np.testing.assert_array_equal(t_cc.bounds, tree.bounds)


def test_single_leaf_tree(rng):
    pts, nrm = random_cloud(rng, 5)  # below leaf_size: root is a leaf
    scene = SceneNN.from_cloud(pts, nrm, max_dist_diff=10.0)
    q = rng.uniform(-0.1, 0.1, (20, 3)).astype(np.float32)
    dst, _, valid = scene.query(q)
    _, want_d = brute_nn_numpy(q, pts)
    got_d = ((np.asarray(dst) - q) ** 2).sum(-1)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def test_native_builder_matches_numpy(rng):
    from pose_refine import native

    if not native.native_available():
        pytest.skip("g++ unavailable")
    pts, nrm = random_cloud(rng, 4000)
    t_np = build_kdtree(pts, nrm, leaf_size=10, backend="numpy")
    t_cc = build_kdtree(pts, nrm, leaf_size=10, backend="native")
    np.testing.assert_array_equal(t_cc.points, t_np.points)
    np.testing.assert_array_equal(t_cc.normals, t_np.normals)
    np.testing.assert_array_equal(t_cc.parent, t_np.parent)
    np.testing.assert_array_equal(t_cc.child, t_np.child)
    np.testing.assert_array_equal(t_cc.split_dim, t_np.split_dim)
    np.testing.assert_array_equal(t_cc.split_v, t_np.split_v)
    np.testing.assert_array_equal(t_cc.bbox, t_np.bbox)
    np.testing.assert_array_equal(t_cc.bounds, t_np.bounds)


def test_native_builder_duplicates(rng):
    from pose_refine import native

    if not native.native_available():
        pytest.skip("g++ unavailable")
    pts = np.tile(np.array([[0.1, 0.2, 0.5]], np.float32), (64, 1))
    nrm = np.tile(np.array([[0, 0, -1.0]], np.float32), (64, 1))
    t_np = build_kdtree(pts, nrm, backend="numpy")
    t_cc = build_kdtree(pts, nrm, backend="native")
    np.testing.assert_array_equal(t_cc.bounds, t_np.bounds)
    np.testing.assert_array_equal(t_cc.child, t_np.child)


@pytest.mark.parametrize("n_scene,n_query", [
    (1, 7), (100, 64), (2047, 300), (2048, 300), (2049, 300), (4096 + 77, 513),
])
def test_nn_backends_match_numpy(n_scene, n_query):
    """_nn_kdtree and _nn_bruteforce against numpy brute force, over scene
    sizes that pad the brute-force scan's last chunk (and one that needs no
    padding): same distances; indices agree up to exact distance ties."""
    import jax.numpy as jnp

    from pose_refine.scene.nn import _nn_kdtree

    rng = np.random.default_rng(n_scene * 7919 + n_query)
    pts, nrm = random_cloud(rng, n_scene)
    q = rng.uniform(-0.3, 0.3, size=(n_query, 3)).astype(np.float32)
    q[:, 2] += 0.5
    kd = SceneNN.from_cloud(pts, nrm, max_dist_diff=10.0)
    ordered = np.asarray(kd.points)  # kd-reordered scene rows
    want_i, want_d = brute_nn_numpy(q, ordered)
    for name, (i, d) in (
        ("kdtree", _nn_kdtree(jnp.asarray(q), kd)),
        ("bruteforce", _nn_bruteforce(jnp.asarray(q), jnp.asarray(ordered))),
    ):
        i, d = np.asarray(i), np.asarray(d)
        np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-12,
                                   err_msg=name)
        mism = i != want_i
        got = ((q[mism] - ordered[i[mism]]) ** 2).sum(-1)
        np.testing.assert_allclose(got, want_d[mism], rtol=1e-5, atol=1e-12,
                                   err_msg=name)


def test_flash_backend_rejected(rng):
    """Only the kd traversal and the brute-force scan exist: any other
    backend name fails at build time instead of running another search."""
    pts, nrm = random_cloud(rng, 50)
    with pytest.raises(ValueError, match="unknown SceneNN backend"):
        SceneNN.from_cloud(pts, nrm, backend="flash")


def test_cpu_baseline_matches_jax_pipeline(rng):
    """The native C++ baseline (renderer + projective ICP) must agree with
    the JAX pipeline on the golden scenario - it is the measured 'reference
    CPU' bench.py compares against, so its correctness matters."""
    from pose_refine import native, geometry, mesh
    import pose_refine.ops.rasterize as R
    from pose_refine.ops.depth_to_cloud import depth_to_cloud
    from pose_refine.scene.projective import SceneProjective
    from pose_refine import icp as icp_mod
    from tests.test_icp import reference_demo_poses

    if not native.native_available():
        pytest.skip("g++ unavailable")
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.5
    proj = np.asarray(geometry.compute_proj(K, 320, 240))
    pose1, pose2, ang = reference_demo_poses()

    depth_cc = native.cpu_render_baseline(m.tris, np.stack([pose1, pose2]), proj, 320, 240)
    depth_jx = np.asarray(R.rasterize_dense(m.tris, np.stack([pose1, pose2]), 320, 240, proj))
    assert (depth_cc != depth_jx).mean() < 1e-4  # near-bit-exact

    cloud, valid, _ = depth_to_cloud(depth_jx[0], K, max_points=16384)
    scene = SceneProjective.from_depth(depth_jx[1], K)
    T, fit, rmse = native.cpu_icp_baseline(
        np.asarray(cloud)[None], np.asarray(valid)[None],
        np.asarray(scene.pcd), np.asarray(scene.normal), K,
    )
    res, _ = icp_mod.icp_point_to_plane(cloud, valid, scene.query)
    np.testing.assert_allclose(np.asarray(res.transformation), T[0], atol=5e-3)
    assert abs(float(res.fitness) - fit[0]) < 5e-3
    assert abs(float(res.inlier_rmse) - rmse[0]) < 1e-4


def test_voxel_downsample(rng):
    from pose_refine.scene.nn import voxel_downsample

    # two tight clusters far apart -> exactly two voxels, centroid points,
    # renormalized mean normals
    a = rng.normal(size=(40, 3)).astype(np.float32) * 0.001
    b = a + 10.5  # .5 offset keeps both clusters off voxel-grid lines
    pts = np.concatenate([a, b])
    nrm = np.tile(np.float32([[0, 0, 1]]), (80, 1))
    p, n = voxel_downsample(pts, nrm, voxel_m=1.0)
    assert p.shape == (2, 3) and n.shape == (2, 3)
    got = p[np.argsort(p[:, 0])]
    np.testing.assert_allclose(got[0], a.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(got[1], b.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)

    # voxel smaller than any point spacing -> identity (up to reorder)
    sparse = (rng.uniform(0, 1, (30, 3)) * 100).astype(np.float32)
    p2, _ = voxel_downsample(sparse, nrm[:30], voxel_m=1e-4)
    assert p2.shape == (30, 3)
    assert np.allclose(np.sort(p2, axis=0), np.sort(sparse, axis=0), atol=1e-5)


def test_scene_voxel_downsample_recovers(rng):
    """NN scene built with voxel_mm downsampling must still recover the
    golden perturbation through the full pipeline."""
    import pose_refine as prt
    from pose_refine import geometry, mesh
    from tests.test_icp import reference_demo_poses

    W, H = 160, 120
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    pose1, pose2, _ = reference_demo_poses()
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    scene_depth = np.asarray(r.render_depth(pose2))[0].astype(np.int32)

    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1, scene="nn_bruteforce", scene_voxel_mm=4.0,
    )
    refiner.set_scene_depth(scene_depth)
    full = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=64, stride=1, scene="nn_bruteforce",
    )
    full.set_scene_depth(scene_depth)
    assert refiner.scene.points.shape[0] < full.scene.points.shape[0]
    refined, results = refiner.refine(pose1)
    R_err = np.asarray(refined)[:3, :3] @ pose2[:3, :3].T
    ang_err = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang_err < 4.0, f"voxel-downsampled NN scene off by {ang_err} deg"
    assert float(results.fitness) > 0.7


def test_far_child_pruning_exact_and_tighter():
    """prune='far' (the default) gates on the descend-target's bbox:
    identical NN distances to the reference-parity prune='node' traversal,
    with strictly fewer traversal steps (measured ~70% fewer on the obj_06
    scene, scripts/kd_pruning_study.py)."""
    import jax
    import jax.numpy as jnp

    from pose_refine.scene.nn import SceneNN, _nn_kdtree

    rng = np.random.default_rng(12)
    pts = rng.uniform(0, 0.3, (3000, 3)).astype(np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (3000, 1))
    scene = SceneNN.from_cloud(pts, nrm)
    # leaves carry their bboxes now (required for far-child pruning)
    leaf = np.asarray(scene.child)[:, 0] < 0
    bb = np.asarray(scene.bbox)[leaf]
    assert (bb[:, 1] >= bb[:, 0]).all() and (bb[:, 1] > 0).any()

    q = jnp.asarray(pts[:512] + rng.normal(0, 0.01, (512, 3)).astype(np.float32))
    i_f, d_f, s_f = jax.jit(
        lambda s: _nn_kdtree(s, scene, prune="far", return_steps=True))(q)
    i_n, d_n, s_n = jax.jit(
        lambda s: _nn_kdtree(s, scene, prune="node", return_steps=True))(q)
    np.testing.assert_array_equal(np.asarray(d_f), np.asarray(d_n))
    assert float(np.mean(np.asarray(s_f))) < 0.7 * float(np.mean(np.asarray(s_n)))


def test_nn_matches_scipy_ckdtree():
    """Authorship-independent NN anchor: every backend against
    scipy.spatial.cKDTree on the same cloud (distances must match exactly
    up to f32 evaluation; scipy computes in f64, so compare squared
    distances with a tight tolerance)."""
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from pose_refine.scene.nn import SceneNN, _nn_bruteforce, _nn_kdtree

    rng = np.random.default_rng(21)
    pts = rng.uniform(-0.2, 0.2, (4000, 3)).astype(np.float32)
    nrm = np.tile(np.float32([[0, 0, 1]]), (4000, 1))
    scene = SceneNN.from_cloud(pts, nrm)
    q = rng.uniform(-0.25, 0.25, (1000, 3)).astype(np.float32)

    d_ref, i_ref = cKDTree(np.asarray(scene.points, np.float64)).query(
        q.astype(np.float64))

    for name, fn in (
        ("kdtree", lambda: _nn_kdtree(jnp.asarray(q), scene)),
        ("bruteforce", lambda: _nn_bruteforce(jnp.asarray(q), scene.points)),
    ):
        idx, dsq = map(np.asarray, fn())
        # distances agree to f32 evaluation error (the bruteforce
        # |p|^2-2pq+|q|^2 form carries ~1e-8 absolute cancellation noise)
        np.testing.assert_allclose(
            dsq, d_ref**2, rtol=2e-3, atol=3e-8, err_msg=name
        )
        # and >99% of indices should be the literal same point
        assert (idx == i_ref).mean() > 0.99, name


def test_build_inputs_fail_loudly(rng):
    """Degenerate inputs raise specific ValueErrors at the entry point -
    not an argmax-of-empty (all-dropout sensor frame) or an unterminating
    split loop (leaf_size=0), and not a silent kd fallback for a typo'd
    backend."""
    pts, nrm = random_cloud(rng, n=32)
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError, match="empty cloud"):
        build_kdtree(empty, empty)
    with pytest.raises(ValueError, match="normals"):
        build_kdtree(pts, nrm[:-1])
    with pytest.raises(ValueError, match="leaf_size"):
        build_kdtree(pts, nrm, leaf_size=0)
    with pytest.raises(ValueError, match="backend"):
        SceneNN.from_cloud(pts, nrm, backend="brute")
