"""Batch triangle depth rasterization (jax.numpy formulations).

The reference renders N poses of one mesh into N int32-mm z-buffers with a
scatter-atomicMin CUDA kernel (renderer.cu:83-187). These are its plain XLA
formulations, with static shapes. Semantics are kept bit-comparable to the
reference:

  * screen mapping: x/w_clip * W/2 + W/2 with w_clip = camera z
    (renderer.cu:91-98, proj last row [0,0,1,0])
  * barycentric coverage with alpha,beta,gamma in [0, 1] (renderer.cu:126-129)
  * perspective depth frag = (a+b+g) / (a/z0 + b/z1 + g/z2) (renderer.cu:138-139)
  * int32 mm depth = trunc(frag + 0.5); empty pixels = 0 via INT_MAX init
    (renderer.cu:144, renderer.cu:71-80)
  * ROI crop-while-rendering with flipped-y clamps (renderer.cu:107-113)
  * back-face culling disabled, matching renderer.cu:175

Three paths:
  * ``rasterize_dense``   - exact gather over all (tri, pixel) pairs; O(T*H*W),
                            used for tests and small images.
  * ``rasterize_scatter`` - per-triangle KxK windows + XLA scatter-min; a
                            chunk whose largest bbox exceeds one window walks
                            as many windows as it needs, so it is exact for
                            any triangle size.
  * ``render``            - dispatcher; the GPU kernel (rasterize_pallas.py)
                            or the scatter path, as pose_refine.platform says.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

INT32_MAX = jnp.iinfo(jnp.int32).max

ROI = Tuple[int, int, int, int]  # (x, y, width, height), 0-size = full frame


def roi_shape(width: int, height: int, roi: ROI) -> Tuple[int, int]:
    """Output (out_w, out_h) for a render, honoring 0-size = full frame."""
    x, y, w, h = roi
    if w > 0 and h > 0:
        if x + w > width or y + h > height:  # user input: never assert
            raise ValueError(
                f"roi {roi} exceeds the {width}x{height} image"
            )
        return w, h
    return width, height


def screen_triangles(tris, poses, proj, width: int, height: int):
    """Transform model triangles into screen space for every pose.

    Args:
      tris:  (T, 3, 3) model-space triangle vertices shared by all poses,
             or (N, T, 3, 3) per-pose triangles (multi-model batches: each
             hypothesis may rasterize a DIFFERENT mesh - the downstream
             math is per-(pose, triangle) either way).
      poses: (N, 4, 4) model->camera transforms.
      proj:  (4, 4) projection from geometry.compute_proj.

    Returns:
      pts2: (N, T, 3, 2) float32 screen xy per vertex.
      zcam: (N, T, 3)   float32 camera-space z per vertex (the w_clip).
    """
    tris = jnp.asarray(tris, jnp.float32)
    poses = jnp.asarray(poses, jnp.float32)
    proj = jnp.asarray(proj, jnp.float32)
    f32 = jax.lax.Precision.HIGHEST  # tiny contractions; TF32/bf16 would cost parity
    spec = "nij,ntvj->ntvi" if tris.ndim == 4 else "nij,tvj->ntvi"
    cam = (
        jnp.einsum(spec, poses[:, :3, :3], tris, precision=f32)
        + poses[:, None, None, :3, 3]
    )
    zcam = cam[..., 2]
    # the rasterizer only consumes the projected x, y (renderer.cu:91-98)
    pxy = jnp.einsum("ij,ntvj->ntvi", proj[:2, :3], cam, precision=f32) + proj[:2, 3]
    sx = pxy[..., 0] / zcam * (width / 2.0) + (width / 2.0)
    sy = pxy[..., 1] / zcam * (height / 2.0) + (height / 2.0)
    return jnp.stack([sx, sy], axis=-1), zcam


def screen_fields(tris, poses, proj, width: int, height: int):
    """screen_triangles in lane-major field layout: nine (N, T) arrays
    (ax, ay, bx, by, cx, cy, z0, z1, z2) instead of (N, T, 3, 2)+(N, T, 3).

    Same arithmetic as screen_triangles (same 3-term contractions, same add
    and divide order) - only the memory layout differs: the triangle axis
    stays last, so the kernel's per-lane loads are contiguous.

    tris may be (T, 3, 3) shared or (N, T, 3, 3) per-pose (multi-model).
    """
    tris = jnp.asarray(tris, jnp.float32)
    poses = jnp.asarray(poses, jnp.float32)
    proj = jnp.asarray(proj, jnp.float32)
    f32 = jax.lax.Precision.HIGHEST
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    half_w, half_h = width / 2.0, height / 2.0
    per_pose = tris.ndim == 4

    out = []
    for v in range(3):
        tv = tris[:, :, v, :] if per_pose else tris[:, v, :]  # (N, T, 3)|(T, 3)
        spec = "nij,ntj->nit" if per_pose else "nij,tj->nit"
        cam = jnp.einsum(spec, R, tv, precision=f32) + t[:, :, None]
        z = cam[:, 2]  # (N, T)
        px = (
            jnp.einsum("j,njt->nt", proj[0, :3], cam, precision=f32) + proj[0, 3]
        )
        py = (
            jnp.einsum("j,njt->nt", proj[1, :3], cam, precision=f32) + proj[1, 3]
        )
        sx = px / z * half_w + half_w
        sy = py / z * half_h + half_h
        out.append((sx, sy, z))
    (ax, ay, z0), (bx, by, z1), (cx, cy, z2) = out
    return ax, ay, bx, by, cx, cy, z0, z1, z2


def _clamp_bounds(width: int, height: int, roi: ROI):
    """Pixel clamp window in the flipped-y P coordinate space
    (renderer.cu:103-113)."""
    x, y, w, h = roi
    if w > 0 and h > 0:
        cmin = (float(x), float(height - 1 - (y + h - 1)))
        cmax = (float(x + w - 1), float(height - 1 - y))
    else:
        cmin = (0.0, 0.0)
        cmax = (float(width - 1), float(height - 1))
    return cmin, cmax


def triangle_bbox(pts2, width: int, height: int, roi: ROI = (0, 0, 0, 0)):
    """Clamped per-triangle screen bbox, reference clamp semantics
    (renderer.cu:100-121). Returns (bbmin, bbmax) float32 (..., 2)."""
    cmin, cmax = _clamp_bounds(width, height, roi)
    vmin = jnp.min(pts2, axis=-2)
    vmax = jnp.max(pts2, axis=-2)
    bbmin = jnp.maximum(vmin, jnp.asarray(cmin, jnp.float32))
    bbmax = jnp.minimum(vmax, jnp.asarray(cmax, jnp.float32))
    return bbmin, bbmax


def fragment_depths(pts2, zcam, px, py):
    """Coverage + int32-mm depth for triangles x pixel positions.

    pts2 (..., 3, 2) and zcam (..., 3) broadcast against pixel coordinates
    px, py (...,) in the flipped-y P space. Returns int32 depths with
    INT32_MAX where the pixel is not covered.
    """
    ax, ay = pts2[..., 0, 0], pts2[..., 0, 1]
    bx, by = pts2[..., 1, 0], pts2[..., 1, 1]
    cx, cy = pts2[..., 2, 0], pts2[..., 2, 1]
    # signed areas (renderer.h:315-317): area(A,B,C) = .5*((C-A)x(B-A))
    area = 0.5 * ((cx - ax) * (by - ay) - (bx - ax) * (cy - ay))
    base_inv = 1.0 / area
    beta = 0.5 * ((cx - ax) * (py - ay) - (px - ax) * (cy - ay)) * base_inv
    gamma = 0.5 * ((px - ax) * (by - ay) - (bx - ax) * (py - ay)) * base_inv
    alpha = 1.0 - beta - gamma

    inside = (
        (alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
        & (alpha <= 1.0) & (beta <= 1.0) & (gamma <= 1.0)
    )
    z0, z1, z2 = zcam[..., 0], zcam[..., 1], zcam[..., 2]
    denom = alpha / z0 + beta / z1 + gamma / z2
    frag = (alpha + beta + gamma) / denom
    depth = jnp.trunc(frag + 0.5).astype(jnp.int32)
    return jnp.where(inside, depth, INT32_MAX)


def _bbox_pixel_mask(bbmin, bbmax, px, py):
    """Reference pixel-loop membership: P in [trunc(bbmin+.5), bbmax]
    (renderer.cu:124-125)."""
    x0 = jnp.trunc(bbmin[..., 0] + 0.5)
    y0 = jnp.trunc(bbmin[..., 1] + 0.5)
    return (
        (px >= x0) & (px <= bbmax[..., 0]) & (py >= y0) & (py <= bbmax[..., 1])
    )


def finalize_depth(fb):
    """INT_MAX (= empty) -> 0, as renderer.cu:71-80."""
    return jnp.where(fb == INT32_MAX, 0, fb)


def _pad_tris(pts2, zcam, chunk: int):
    """Pad the triangle axis to a multiple of ``chunk`` with degenerate
    (zero-area -> never covering) triangles."""
    t = pts2.shape[-3]
    pad = (-t) % chunk
    if pad:
        pts2 = jnp.concatenate(
            [pts2, jnp.zeros(pts2.shape[:-3] + (pad, 3, 2), pts2.dtype)], axis=-3
        )
        zcam = jnp.concatenate(
            [zcam, jnp.ones(zcam.shape[:-2] + (pad, 3), zcam.dtype)], axis=-2
        )
    return pts2, zcam


@functools.partial(
    jax.jit, static_argnames=("width", "height", "roi", "tri_chunk")
)
def rasterize_dense(
    tris,
    poses,
    width: int,
    height: int,
    proj,
    roi: ROI = (0, 0, 0, 0),
    tri_chunk: int = 256,
):
    """Exact gather formulation: every pixel tests every triangle.

    O(T * H * W) work - the correctness oracle for the fast paths, and the
    right choice for small crops. Returns (N, out_h, out_w) int32 mm.
    """
    out_w, out_h = roi_shape(width, height, roi)
    rx, ry = roi[0], roi[1]
    pts2, zcam = screen_triangles(tris, poses, proj, width, height)
    pts2, zcam = _pad_tris(pts2, zcam, tri_chunk)
    n_chunks = pts2.shape[1] // tri_chunk

    # flipped-y P coordinates of each output pixel (renderer.cu:141-142)
    col = jnp.arange(out_w, dtype=jnp.float32)
    row = jnp.arange(out_h, dtype=jnp.float32)
    px = jnp.tile(col[None, :] + rx, (out_h, 1)).reshape(-1)  # row-major (out_h, out_w)
    py = jnp.repeat(height - 1 - ry - row, out_w)

    def per_pose(pts2_p, zcam_p):
        pts2_c = pts2_p.reshape(n_chunks, tri_chunk, 3, 2)
        zcam_c = zcam_p.reshape(n_chunks, tri_chunk, 3)

        def body(fb, chunk):
            p2, zc = chunk
            bbmin, bbmax = triangle_bbox(p2, width, height, roi)
            d = fragment_depths(
                p2[:, None], zc[:, None], px[None, :], py[None, :]
            )
            m = _bbox_pixel_mask(bbmin[:, None], bbmax[:, None], px[None, :], py[None, :])
            d = jnp.where(m, d, INT32_MAX)
            return jnp.minimum(fb, d.min(axis=0)), None

        fb0 = jnp.full((out_h * out_w,), INT32_MAX, jnp.int32)
        fb, _ = jax.lax.scan(body, fb0, (pts2_c, zcam_c))
        return fb.reshape(out_h, out_w)

    fb = jax.vmap(per_pose)(pts2, zcam)
    return finalize_depth(fb)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "roi", "window", "tri_chunk")
)
def rasterize_scatter(
    tris,
    poses,
    width: int,
    height: int,
    proj,
    roi: ROI = (0, 0, 0, 0),
    window: int = 32,
    tri_chunk: int = 1024,
):
    """Per-triangle KxK windows + XLA scatter-min. Returns (N, out_h, out_w)
    int32 mm.

    Each chunk of triangles walks ceil(E / window)^2 window offsets, E being
    the largest clamped bbox extent in the chunk - one pass when every bbox
    fits the window (the common case), more for large triangles, so no
    triangle is ever clipped."""
    out_w, out_h = roi_shape(width, height, roi)
    rx, ry = roi[0], roi[1]
    pts2, zcam = screen_triangles(tris, poses, proj, width, height)
    pts2, zcam = _pad_tris(pts2, zcam, tri_chunk)
    n_chunks = pts2.shape[1] // tri_chunk

    dxy = jnp.arange(window, dtype=jnp.float32)

    def per_pose(pts2_p, zcam_p):
        pts2_c = pts2_p.reshape(n_chunks, tri_chunk, 3, 2)
        zcam_c = zcam_p.reshape(n_chunks, tri_chunk, 3)

        def body(fb, chunk):
            p2, zc = chunk  # (C,3,2), (C,3)
            bbmin, bbmax = triangle_bbox(p2, width, height, roi)
            x0 = jnp.trunc(bbmin[:, 0] + 0.5)
            y0 = jnp.trunc(bbmin[:, 1] + 0.5)
            ext = jnp.floor(bbmax) - jnp.trunc(bbmin + 0.5) + 1.0
            ext = jnp.max(jnp.where(jnp.isfinite(ext), ext, 0.0))
            n_win = jnp.maximum(-(-ext.astype(jnp.int32) // window), 1)

            def one_window(t, fb):
                ox = (t % n_win * window).astype(jnp.float32)
                oy = (t // n_win * window).astype(jnp.float32)
                px = x0[:, None, None] + ox + dxy[None, None, :]  # (C,1,K)
                py = y0[:, None, None] + oy + dxy[None, :, None]  # (C,K,1)
                px, py = (
                    jnp.broadcast_to(px, (p2.shape[0], window, window)),
                    jnp.broadcast_to(py, (p2.shape[0], window, window)),
                )
                d = fragment_depths(p2[:, None, None], zc[:, None, None], px, py)
                m = (px <= bbmax[:, 0, None, None]) & (py <= bbmax[:, 1, None, None])
                d = jnp.where(m, d, INT32_MAX)
                rows = (height - 1 - ry - py).astype(jnp.int32)
                cols = (px - rx).astype(jnp.int32)
                # push non-writes out of bounds; scatter drops them
                rows = jnp.where(d == INT32_MAX, -1, rows)
                return fb.at[rows.reshape(-1), cols.reshape(-1)].min(
                    d.reshape(-1), mode="drop"
                )

            return jax.lax.fori_loop(0, n_win * n_win, one_window, fb), None

        fb0 = jnp.full((out_h, out_w), INT32_MAX, jnp.int32)
        fb, _ = jax.lax.scan(body, fb0, (pts2_c, zcam_c))
        return fb

    fb = jax.vmap(per_pose)(pts2, zcam)
    return finalize_depth(fb)


def max_bbox_extent(tris, poses, width: int, height: int, proj, roi: ROI = (0, 0, 0, 0)):
    """Largest clamped triangle-bbox extent (pixels) across all poses - the
    number of pixels a ``rasterize_scatter`` window must span for one pass
    per chunk."""
    pts2, _ = screen_triangles(tris, poses, proj, width, height)
    bbmin, bbmax = triangle_bbox(pts2, width, height, roi)
    x0 = jnp.trunc(bbmin + 0.5)
    ext = jnp.maximum(jnp.floor(bbmax) - x0 + 1.0, 0.0)
    return int(jnp.max(ext))


def render(
    tris,
    poses,
    width: int,
    height: int,
    proj,
    roi: ROI = (0, 0, 0, 0),
    backend: Optional[str] = None,
    **kwargs,
):
    """Render N poses -> (N, out_h, out_w) int32 depth (mm), 0 = empty.

    backend: 'pallas' (the GPU kernel), 'scatter', 'dense', or None for the
    platform's choice (pose_refine.platform.raster_kernel).
    """
    if backend is None:
        from pose_refine import platform

        backend = "pallas" if platform.raster_kernel() else "scatter"
    if backend == "dense":
        return rasterize_dense(tris, poses, width, height, proj, roi, **kwargs)
    if backend == "scatter":
        return rasterize_scatter(tris, poses, width, height, proj, roi, **kwargs)
    if backend == "pallas":
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        return rasterize_pallas(tris, poses, width, height, proj, roi, **kwargs)
    raise ValueError(f"unknown rasterize backend {backend!r}")
