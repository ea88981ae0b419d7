import numpy as np

from pose_refine import geometry
from pose_refine.ops import depth_to_cloud as d2c


def make_depth(rng, h=60, w=80):
    depth = np.zeros((h, w), np.int32)
    depth[10:40, 20:60] = rng.integers(250, 400, size=(30, 40))
    return depth


def test_point_image_matches_dep2pcd(rng):
    K = geometry.LINEMOD_K
    depth = make_depth(rng)
    pts, mask = d2c.depth_image_to_points(depth, K)
    assert pts.shape == (60, 80, 3) and mask.shape == (60, 80)
    np.testing.assert_array_equal(np.asarray(mask), depth > 0)
    ys, xs = np.nonzero(depth)
    expected = np.asarray(geometry.dep2pcd(xs, ys, depth[ys, xs], K))
    np.testing.assert_allclose(np.asarray(pts)[ys, xs], expected, rtol=1e-6)
    # invalid pixels are zeroed
    assert (np.asarray(pts)[~np.asarray(mask)] == 0).all()


def test_compaction_matches_reference_order(rng):
    # reference compaction is row-major over valid pixels (icp.cpp:100-115)
    K = geometry.LINEMOD_K
    depth = make_depth(rng)
    pts_img, mask = d2c.depth_image_to_points(depth, K)
    cloud, valid, n = d2c.compact_points(pts_img, mask, max_points=2048)
    n = int(n)
    assert n == (depth > 0).sum()
    assert valid[:n].all() and not valid[n:].any()
    ys, xs = np.nonzero(depth)  # row-major like the reference scan
    expected = np.asarray(geometry.dep2pcd(xs, ys, depth[ys, xs], K))
    np.testing.assert_allclose(np.asarray(cloud)[:n], expected, rtol=1e-6)
    assert (np.asarray(cloud)[n:] == 0).all()


def test_compaction_overflow_drops(rng):
    K = geometry.LINEMOD_K
    depth = make_depth(rng)
    cloud, valid, n = d2c.depth_to_cloud(depth, K, max_points=100)
    assert int(n) == (depth > 0).sum()  # true count still reported
    assert valid.sum() == 100  # but only the budget is kept


def test_stride(rng):
    K = geometry.LINEMOD_K
    depth = make_depth(rng)
    pts, mask = d2c.depth_image_to_points(depth, K, stride=2)
    assert pts.shape == (30, 40, 3)
    # strided points must use true pixel coordinates (proper semantics; the
    # reference's stride path is buggy and never used - SURVEY.md quirks)
    full, _ = d2c.depth_image_to_points(depth, K)
    np.testing.assert_allclose(np.asarray(pts), np.asarray(full)[::2, ::2], rtol=1e-6)


def test_window_cloud(rng):
    from pose_refine.ops.depth_to_cloud import window_cloud

    K = geometry.LINEMOD_K
    depth = np.zeros((120, 160), np.int32)
    depth[40:80, 60:120] = rng.integers(250, 400, size=(40, 60))
    pts, valid, n = window_cloud(depth, K, window=96, stride=2)
    assert pts.shape == (48 * 48, 3) and valid.shape == (48 * 48,)
    # every valid point equals the full dep2pcd at its (strided) pixel
    pv = np.asarray(pts)[np.asarray(valid)]
    assert int(n) == np.asarray(valid).sum()
    full, _ = d2c.depth_image_to_points(depth, K)
    full = np.asarray(full)
    # reconstruct pixel coords from projection and check round-trip
    xyd = np.asarray(geometry.pcd2dep(pv, K))
    for i in range(0, len(pv), 50):
        x, y = xyd[i, 0], xyd[i, 1]
        np.testing.assert_allclose(pv[i], full[y, x], atol=1e-6)
    # window centered on the object: all object pixels inside (object is
    # 40x60 px, window 96) at stride 2 -> about a quarter of them sampled
    expect = (depth[::1, ::1] > 0).sum() / 4
    assert abs(int(n) - expect) < expect * 0.3


def test_window_cloud_empty_depth():
    from pose_refine.ops.depth_to_cloud import window_cloud

    K = geometry.LINEMOD_K
    depth = np.zeros((120, 160), np.int32)
    pts, valid, n = window_cloud(depth, K, window=64, stride=1)
    assert int(n) == 0 and not np.asarray(valid).any()


def test_compact_topk_keeps_all_when_fits(rng):
    from pose_refine.ops.depth_to_cloud import compact_topk

    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    valid = rng.random(1000) > 0.5
    out, v, n = compact_topk(pts, valid, k=600)
    assert int(n) == valid.sum()
    got = set(map(tuple, np.asarray(out)[np.asarray(v)]))
    want = set(map(tuple, pts[valid]))
    assert got == want  # no point lost or invented


def test_compact_topk_overflow_is_spatially_spread(rng):
    from pose_refine.ops.depth_to_cloud import compact_topk

    # valid points fill the whole array; keep half
    p = 4096
    pts = np.stack([np.arange(p), np.zeros(p), np.zeros(p)], axis=1).astype(np.float32)
    valid = np.ones(p, bool)
    out, v, n = compact_topk(pts, valid, k=2048, spread=True)
    kept = np.sort(np.asarray(out)[np.asarray(v)][:, 0])
    # spread selection: kept indices cover the full range, not just the head
    assert kept.min() < p * 0.05 and kept.max() > p * 0.95
    assert np.median(kept) > p * 0.25 and np.median(kept) < p * 0.75
    # non-spread keeps exactly the head (compact_points semantics)
    out2, v2, _ = compact_topk(pts, valid, k=2048, spread=False)
    kept2 = np.sort(np.asarray(out2)[np.asarray(v2)][:, 0])
    np.testing.assert_array_equal(kept2, np.arange(2048).astype(np.float32))


def test_window_cloud_batched_matches_vmap():
    """The batched-gather window lift must equal vmap(window_cloud)."""
    import jax

    from pose_refine.ops.depth_to_cloud import window_cloud, window_cloud_batched

    rng = np.random.default_rng(5)
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    depth = np.zeros((4, 120, 160), np.int32)
    for i in range(4):
        y, x = rng.integers(10, 60), rng.integers(10, 80)
        depth[i, y : y + 40, x : x + 50] = rng.integers(250, 400, (40, 50))
    import jax.numpy as jnp

    p0, v0, n0 = jax.vmap(
        lambda d: window_cloud(d, K, window=64, stride=2, tl_x=3, tl_y=7)
    )(jnp.asarray(depth))
    p1, v1, n1 = window_cloud_batched(depth, K, window=64, stride=2, tl_x=3, tl_y=7)
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_array_equal(np.asarray(n0), np.asarray(n1))
    # ulp-level tolerance: XLA rewrites the mm->m division to a
    # reciprocal multiply under vmap but not in the batched layout
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p1), atol=1e-6)


def test_compact_topk_morton_order_same_set_tighter_tiles(rng):
    """order_shape emits the kept rows in Morton order of their window
    slot: identical kept SET (pure permutation), valid rows first, and
    consecutive-row locality strictly better than the hash order (the
    property the NN pipeline asks for)."""
    import jax.numpy as jnp

    from pose_refine.ops.depth_to_cloud import compact_topk

    sh, sw = 32, 32
    pts = rng.uniform(-0.1, 0.1, (sh * sw, 3)).astype(np.float32)
    # embed grid geometry so spatial locality is measurable: x, y follow
    # the slot's (row, col)
    yy, xx = np.divmod(np.arange(sh * sw), sw)
    pts[:, 0] = xx * 0.01
    pts[:, 1] = yy * 0.01
    valid = rng.random(sh * sw) < 0.7
    k = 512

    oh, vh, nh = compact_topk(jnp.asarray(pts), jnp.asarray(valid), k)
    om, vm, nm = compact_topk(jnp.asarray(pts), jnp.asarray(valid), k,
                              order_shape=(sh, sw))
    oh, vh, om, vm = map(np.asarray, (oh, vh, om, vm))
    assert int(nh) == int(nm)
    # same kept set of valid points
    set_h = {tuple(p) for p in oh[vh]}
    set_m = {tuple(p) for p in om[vm]}
    assert set_h == set_m and len(set_m) == min(k, valid.sum())
    # valid rows first
    assert vm[: vm.sum()].all() and not vm[vm.sum():].any()
    # locality: mean consecutive-row distance in Morton order far below hash
    def mean_step(o, v):
        q = o[v]
        return np.linalg.norm(np.diff(q, axis=0), axis=1).mean()

    assert mean_step(om, vm) < 0.5 * mean_step(oh, vh), (
        mean_step(om, vm), mean_step(oh, vh))

    # validation: wrong grid size errors
    import pytest

    with pytest.raises(ValueError, match="order_shape"):
        compact_topk(jnp.asarray(pts), jnp.asarray(valid), k,
                     order_shape=(3, 5))


def test_morton_key_matches_permutation_table_order():
    """morton_key (in-program bit spreading - nothing baked into the trace)
    must sort row-major slots exactly as scene.nn._grid_morton_perm's rank
    table does: compact_topk orders by these keys instead of baking a (p,)
    table into the trace."""
    import jax.numpy as jnp
    import pytest

    from pose_refine.ops.depth_to_cloud import morton_key
    from pose_refine.scene.nn import _grid_morton_perm

    for sh, sw in [(4, 4), (7, 5), (48, 64), (1, 3), (33, 1)]:
        p = sh * sw
        perm = _grid_morton_perm(sh, sw)
        mrank = np.empty(p, np.int64)
        mrank[perm] = np.arange(p)
        code = np.asarray(morton_key(jnp.arange(p, dtype=jnp.int32), sh, sw))
        assert code.min() >= 0 and code.max() < (1 << 28)
        np.testing.assert_array_equal(
            np.argsort(code, kind="stable"), np.argsort(mrank, kind="stable")
        )
    with pytest.raises(ValueError, match="morton"):
        morton_key(jnp.arange(4, dtype=jnp.int32), (1 << 14) + 1, 1)
