"""Depth image -> point cloud.

The reference compacts valid pixels into a dense variable-length array via
mask -> exclusive-scan -> scatter (icp.cpp:73-117, icp.cu:228-291). Dynamic
sizes are XLA-hostile, so here the canonical form is a dense (H, W, 3) point
image + validity mask, with an optional compaction into a *static*
``max_points`` buffer (cumsum + scatter, one pass, jit-friendly).

The reference's stride>1 path has a known mask-indexing bug and also projects
with strided pixel indices against the unstrided K (icp.cpp:82,110 - never
exercised upstream since stride is always 1). We implement striding properly:
the true pixel coordinate x*stride + tl_x enters the projection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("stride", "tl_x", "tl_y"))
def depth_image_to_points(depth, K, stride: int = 1, tl_x: int = 0, tl_y: int = 0):
    """(H, W) int depth in mm -> ((H/s, W/s, 3) float32 points in m, (H/s, W/s) bool mask).

    Point math matches dep2pcd (common.h:47-61): z = dep/1000,
    x = (u - cx)/fx * z, y = (v - cy)/fy * z; dep == 0 -> invalid.
    """
    depth = jnp.asarray(depth)
    if stride != 1:
        depth = depth[::stride, ::stride]
    h, w = depth.shape
    K = jnp.asarray(K, jnp.float32)
    u = jnp.arange(w, dtype=jnp.float32)[None, :] * stride + tl_x
    v = jnp.arange(h, dtype=jnp.float32)[:, None] * stride + tl_y
    z = depth.astype(jnp.float32) / 1000.0
    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    mask = depth > 0
    pts = jnp.stack([x, y, z], axis=-1)
    pts = jnp.where(mask[..., None], pts, 0.0)
    return pts, mask


@functools.partial(jax.jit, static_argnames=("max_points",))
def compact_points(point_image, mask, max_points: int):
    """Compact valid points into a static (max_points, 3) buffer.

    The static-shape analog of the reference's exclusive-scan compaction
    (icp.cpp:61-96): indices = cumsum(mask) - 1, scatter valid points to their
    slot, slots beyond the valid count stay zero/invalid. Points past
    ``max_points`` are dropped (choose the budget from the workload; the
    renderer's object coverage bounds it).

    Returns (points (max_points, 3), valid (max_points,), n_valid ()).
    """
    flat_pts = point_image.reshape(-1, 3)
    flat_mask = mask.reshape(-1)
    idx = jnp.cumsum(flat_mask) - 1  # slot for each valid pixel
    n_valid = jnp.sum(flat_mask)
    dest = jnp.where(flat_mask & (idx < max_points), idx, max_points)  # dropped -> OOB
    out = jnp.zeros((max_points, 3), jnp.float32).at[dest].set(flat_pts, mode="drop")
    slot_valid = jnp.arange(max_points) < jnp.minimum(n_valid, max_points)
    return out, slot_valid, n_valid


def depth_to_cloud(depth, K, max_points: int, stride: int = 1, tl_x: int = 0, tl_y: int = 0):
    """depth2cloud equivalent (icp.h:102-110) with a static point budget."""
    pts, mask = depth_image_to_points(depth, K, stride=stride, tl_x=tl_x, tl_y=tl_y)
    return compact_points(pts, mask, max_points)


# morton codes of a 14-bit (row, col) grid occupy bits 0..27; adding the
# cap keeps invalid-row keys above every valid one without int32 overflow
_MORTON_CODE_CAP = jnp.int32(1 << 28)


def morton_key(idx, sh: int, sw: int):
    """Morton (Z-curve) code of row-major slot indices over an (sh, sw)
    grid, computed in-program (uint32 bit spreading - no host permutation
    table enters the trace). Monotone in morton rank: sorting
    by this key IS sorting by scene/nn._grid_morton_perm's rank."""
    if max(sh, sw) > (1 << 14):
        raise ValueError(
            f"grid ({sh}, {sw}) exceeds 14-bit morton key range")
    r = (idx // sw).astype(jnp.uint32)
    c = (idx % sw).astype(jnp.uint32)

    def spread(v):  # interleave 16 bits with 1-bit gaps
        v = (v | (v << 8)) & jnp.uint32(0x00FF00FF)
        v = (v | (v << 4)) & jnp.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & jnp.uint32(0x33333333)
        v = (v | (v << 1)) & jnp.uint32(0x55555555)
        return v

    return (spread(c) | (spread(r) << jnp.uint32(1))).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "spread", "order_shape"))
def compact_topk(pts, valid, k: int, spread: bool = True, order_shape=None):
    """Scatter-free compaction: keep k valid points via top_k over a rank
    key + one gather, with no scatter - this replaces compact_points on hot
    paths.

    When more than k points are valid, ``spread=True`` ranks valid points by
    a deterministic pseudo-random permutation (multiplicative hash) so the
    kept subset is spatially uniform; the first-k-in-scan-order alternative
    (spread=False, compact_points semantics) would keep only the TOP of the
    object and bias the ICP normal equations. When nothing overflows, both
    keep the identical (complete) valid set.

    order_shape=(sh, sw): the input rows are a raster of that grid - emit
    the kept rows in MORTON order of their grid slot instead of hash-rank
    order. Which points are kept is unchanged (pure output permutation;
    every downstream reduction is order-invariant), but consecutive rows
    become spatially LOCAL, so the NN search's gathers for neighbouring
    queries touch nearby scene rows. Costs one (k,)-key argsort per pose;
    only the NN pipeline asks for it."""
    p = pts.shape[0]
    r = jnp.arange(p, dtype=jnp.int32)
    if spread:
        rank = (r * jnp.int32(2654435761 & 0x7FFFFFFF)) % jnp.int32(p)
    else:
        rank = r
    key = jnp.where(valid, -rank, -(p + r))  # all valid outrank all invalid
    _, idx = jax.lax.top_k(key, k)
    if order_shape is not None:
        sh, sw = order_shape
        if sh * sw != p:
            raise ValueError(f"order_shape {order_shape} != {p} input rows")
        # Sorting by the morton CODE of each kept slot equals sorting by its
        # morton rank (codes are unique, argsort is stable) - and the code
        # is a handful of in-program bitwise ops on the kept indices, not a
        # (p,) host table baked into the trace.
        mkey = morton_key(idx, sh, sw)
        # invalid kept rows sort AFTER every valid one (their slots are
        # arbitrary; interleaved they would break the locality)
        v_pre = jnp.take(valid, idx)
        order = jnp.argsort(jnp.where(v_pre, mkey, _MORTON_CODE_CAP + mkey))
        idx = jnp.take(idx, order)
    out = jnp.take(pts, idx, axis=0)
    v = jnp.take(valid, idx, axis=0)
    return jnp.where(v[:, None], out, 0.0), v, jnp.sum(valid)


@functools.partial(jax.jit, static_argnames=("window", "stride", "tl_x", "tl_y"))
def window_cloud(depth, K, window: int = 256, stride: int = 2,
                 tl_x: int = 0, tl_y: int = 0):
    """Scatter-free cloud extraction: crop a static window around the object
    and stride it to a fixed point budget.

    A scatter-free replacement for stream compaction (compact_points) in the
    render->ICP pipeline:
    locate the rendered object's bbox with cheap reductions, dynamic-slice a
    (window, window) region centered on it, subsample by ``stride``. Yields
    exactly (window/stride)^2 points + validity mask - the reference's ROI +
    down-sample concepts (renderer.h:199-202, pose_renderer.h:25-27) fused
    into the cloud lift.

    Returns (points ((window/stride)^2, 3) float32 m, valid mask, n_valid).
    """
    depth = jnp.asarray(depth)
    h, w = depth.shape
    K = jnp.asarray(K, jnp.float32)
    mask = depth > 0

    rows = jnp.any(mask, axis=1)
    cols = jnp.any(mask, axis=0)
    ridx = jnp.arange(h)
    cidx = jnp.arange(w)
    r0 = jnp.min(jnp.where(rows, ridx, h))
    r1 = jnp.max(jnp.where(rows, ridx, -1))
    c0 = jnp.min(jnp.where(cols, cidx, w))
    c1 = jnp.max(jnp.where(cols, cidx, -1))
    cy = jnp.clip((r0 + r1) // 2 - window // 2, 0, max(h - window, 0))
    cx = jnp.clip((c0 + c1) // 2 - window // 2, 0, max(w - window, 0))

    sub = jax.lax.dynamic_slice(depth, (cy, cx), (min(window, h), min(window, w)))
    sub = sub[::stride, ::stride]
    sh, sw = sub.shape
    # tl_x/tl_y: origin of `depth` within the full camera frame (ROI renders)
    u = (tl_x + cx + jnp.arange(sw) * stride).astype(jnp.float32)[None, :]
    v = (tl_y + cy + jnp.arange(sh) * stride).astype(jnp.float32)[:, None]
    z = sub.astype(jnp.float32) / 1000.0
    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    valid = (sub > 0).reshape(-1)
    pts = jnp.stack(
        [jnp.where(sub > 0, x, 0.0), jnp.where(sub > 0, y, 0.0), jnp.where(sub > 0, z, 0.0)],
        axis=-1,
    ).reshape(-1, 3)
    return pts, valid, jnp.sum(valid)


def window_cloud_batched(depth, K, window: int = 256, stride: int = 2,
                         tl_x: int = 0, tl_y: int = 0):
    """window_cloud over a (N, H, W) depth batch as ONE batched gather.

    Identical semantics to vmap(window_cloud) but the per-pose
    dynamic-slice + stride extraction becomes a single
    take_along_axis of (window/stride)^2 pixels per pose instead of N
    dynamic slices.

    Returns (points (N, (window/stride)^2, 3), valid (N, P), n_valid (N,)).
    """
    depth = jnp.asarray(depth)
    n, h, w = depth.shape
    K = jnp.asarray(K, jnp.float32)
    win_h, win_w = min(window, h), min(window, w)
    mask = depth > 0

    rows = jnp.any(mask, axis=2)  # (N, H)
    cols = jnp.any(mask, axis=1)  # (N, W)
    ridx = jnp.arange(h)[None, :]
    cidx = jnp.arange(w)[None, :]
    r0 = jnp.min(jnp.where(rows, ridx, h), axis=1)
    r1 = jnp.max(jnp.where(rows, ridx, -1), axis=1)
    c0 = jnp.min(jnp.where(cols, cidx, w), axis=1)
    c1 = jnp.max(jnp.where(cols, cidx, -1), axis=1)
    cy = jnp.clip((r0 + r1) // 2 - window // 2, 0, max(h - window, 0))  # (N,)
    cx = jnp.clip((c0 + c1) // 2 - window // 2, 0, max(w - window, 0))

    dy = jnp.arange(0, win_h, stride)
    dx = jnp.arange(0, win_w, stride)
    yy = cy[:, None] + dy[None, :]              # (N, sh)
    xx = cx[:, None] + dx[None, :]              # (N, sw)
    lin = (yy[:, :, None] * w + xx[:, None, :]).reshape(n, -1)  # (N, sh*sw)
    sub = jnp.take_along_axis(depth.reshape(n, -1), lin, axis=1)  # (N, P)

    u = (tl_x + xx).astype(jnp.float32)          # (N, sw)
    v = (tl_y + yy).astype(jnp.float32)          # (N, sh)
    sh, sw = len(dy), len(dx)
    uu = jnp.broadcast_to(u[:, None, :], (n, sh, sw)).reshape(n, -1)
    vv = jnp.broadcast_to(v[:, :, None], (n, sh, sw)).reshape(n, -1)
    z = sub.astype(jnp.float32) / 1000.0
    x = (uu - K[0, 2]) / K[0, 0] * z
    y = (vv - K[1, 2]) / K[1, 1] * z
    valid = sub > 0
    pts = jnp.stack(
        [jnp.where(valid, x, 0.0), jnp.where(valid, y, 0.0), jnp.where(valid, z, 0.0)],
        axis=-1,
    )
    return pts, valid, jnp.sum(valid, axis=1)
