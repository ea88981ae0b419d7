"""Production batch depth rasterizer: a Pallas kernel for the GPU (Triton).

The reference's design (renderer.cu:152-187), not a tile gather: one lane
per (pose, triangle) walks that triangle's clamped screen bbox and
``atomic_min``s the fragment depth into an int32 framebuffer initialised to
INT32_MAX. A program owns BLOCK consecutive triangles of one pose; with the
triangles in Morton order (mesh.morton_order) the lanes of a block have
similar small bboxes, so few lanes idle while the largest one finishes.

Lane i visits pixel k of its bbox as (x0 + k % w, y0 + k // w) for
k < w * h. The program's loop runs to the largest bbox area among its lanes.
There is no size cap: a triangle as large as the frame is walked pixel by
pixel like any other, and costs its own area once, in its own program.

Each fragment is evaluated with the reference's own arithmetic, operation
for operation as rasterize.fragment_depths: barycentrics from the signed
areas (renderer.cu:126-129, with the per-triangle edge vectors and 1/area
computed once by XLA in _triangle_setup) and the perspective depth
(a+b+g) / (a/z0 + b/z1 + g/z2) (renderer.cu:138-139). Output semantics
match rasterize.py: int32 mm, trunc(frag + 0.5), empty pixel = 0
(INT32_MAX is mapped to 0 by one XLA op after the kernel), flipped y, ROI
crop-while-rendering. The results agree with rasterize_dense except where
the compiler's fused multiply-adds move a pixel centre that lies on an
edge (to within an ulp) across it, or a depth across a .5 mm rounding
boundary.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pose_refine.ops import rasterize as rz

BLOCK = 128      # (pose, triangle) lanes per program: one per thread
NUM_WARPS = 4    # 4 warps x 32 threads = BLOCK
N_COEF = 16      # per-triangle f32 rows (10 used, padded to a power of two)
N_BOX = 4        # int rows: x0, y0, bbox width, bbox area


def _triangle_setup(tris, poses, proj, width: int, height: int, roi):
    """Per-(pose, triangle) fragment constants and pixel-loop bounds.

    coef (N, 16, Tpad) f32 rows: ax, ay, the edge vectors cx-ax, cy-ay,
      bx-ax, by-ay, the vertex depths z0, z1, z2 and 1/area (the terms of
      rasterize.fragment_depths).
    box (N, 4, Tpad) int32 rows: x0, y0 (= trunc(clamped bbmin + 0.5),
    renderer.cu:124-125), the bbox width w and its pixel count w*h; a
    degenerate, padded or off-screen triangle has area 0.
    """
    fields = rz.screen_fields(tris, poses, proj, width, height)
    n, t = fields[0].shape
    pad = (-t) % BLOCK
    if pad:
        # degenerate padding: coords 0 (zero area), z 1 (no div-by-zero)
        fields = tuple(
            jnp.concatenate(
                [a, jnp.full((n, pad), 1.0 if i >= 6 else 0.0, a.dtype)], axis=1
            )
            for i, a in enumerate(fields)
        )
    ax, ay, bx, by, cx, cy, z0, z1, z2 = fields
    ecx, ecy, ebx, eby = cx - ax, cy - ay, bx - ax, by - ay
    area = 0.5 * (ecx * eby - ebx * ecy)  # signed area (renderer.h:315-317)
    inv = 1.0 / area

    # clamped per-triangle screen bbox (triangle_bbox semantics,
    # renderer.cu:100-121, on the field layout); the clamp keeps every
    # visited pixel inside the frame / ROI
    cmin, cmax = rz._clamp_bounds(width, height, roi)
    x0 = jnp.trunc(jnp.maximum(jnp.minimum(jnp.minimum(ax, bx), cx), cmin[0]) + 0.5)
    y0 = jnp.trunc(jnp.maximum(jnp.minimum(jnp.minimum(ay, by), cy), cmin[1]) + 0.5)
    x1 = jnp.floor(jnp.minimum(jnp.maximum(jnp.maximum(ax, bx), cx), cmax[0]))
    y1 = jnp.floor(jnp.minimum(jnp.maximum(jnp.maximum(ay, by), cy), cmax[1]))
    w = jnp.maximum(x1 - x0 + 1.0, 0.0)
    h = jnp.maximum(y1 - y0 + 1.0, 0.0)
    ok = jnp.isfinite(inv) & (area != 0.0) & jnp.isfinite(w * h)
    w = jnp.where(ok, w, 0.0)
    h = jnp.where(ok, h, 0.0)
    x0 = jnp.where(ok, x0, 0.0)
    y0 = jnp.where(ok, y0, 0.0)

    zero = jnp.zeros_like(ax)
    coef = jnp.stack(
        [ax, ay, ecx, ecy, ebx, eby, z0, z1, z2, inv] + [zero] * (N_COEF - 10),
        axis=1,
    )  # (N, 16, Tpad)
    # lanes with area 0 write nothing; keep their constants finite anyway
    coef = jnp.nan_to_num(coef, nan=0.0, posinf=0.0, neginf=0.0)
    box = jnp.stack([x0, y0, w, w * h], axis=1).astype(jnp.int32)  # (N, 4, Tpad)
    return coef, box


def _kernel(coef_ref, box_ref, fb_in_ref, fb_ref, *, out_w, frame, row0, rx,
            interpret):
    """One program: BLOCK triangles of pose program_id(0)."""
    del fb_in_ref  # aliased to fb_ref
    ax, ay = coef_ref[0, :], coef_ref[1, :]
    ecx, ecy, ebx, eby = coef_ref[2, :], coef_ref[3, :], coef_ref[4, :], coef_ref[5, :]
    z0, z1, z2, inv = coef_ref[6, :], coef_ref[7, :], coef_ref[8, :], coef_ref[9, :]
    x0, y0 = box_ref[0, :], box_ref[1, :]
    w, area = box_ref[2, :], box_ref[3, :]
    w_div = jnp.maximum(w, 1)
    base = pl.program_id(0) * frame

    def body(k, carry):
        dy = k // w_div
        px_i = x0 + (k - dy * w_div)
        py_i = y0 + dy
        px = px_i.astype(jnp.float32)
        py = py_i.astype(jnp.float32)
        # rasterize.fragment_depths, term for term
        beta = 0.5 * (ecx * (py - ay) - (px - ax) * ecy) * inv
        gamma = 0.5 * ((px - ax) * eby - ebx * (py - ay)) * inv
        alpha = 1.0 - beta - gamma
        cov = (
            (k < area)
            & (alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
            & (alpha <= 1.0) & (beta <= 1.0) & (gamma <= 1.0)
        )
        denom = alpha / z0 + beta / z1 + gamma / z2
        frag = jnp.where(cov, (alpha + beta + gamma) / denom, 0.0)
        depth = jnp.trunc(frag + 0.5).astype(jnp.int32)
        # flipped y (renderer.cu:141-142): P row py is image row
        # height-1-py, offset by the ROI origin
        idx = base + (row0 - py_i) * out_w + (px_i - rx)
        if interpret:
            # the interpreter applies a vector atomic as one scatter, which
            # drops all but one of two lanes hitting the same pixel: apply
            # the lanes one at a time there (the card serializes them)
            idx = jnp.where(cov, idx, 0)
            val = jnp.where(cov, depth, rz.INT32_MAX)

            def lane(i, c):
                plgpu.atomic_min(fb_ref, (idx[i],), val[i])
                return c

            jax.lax.fori_loop(0, BLOCK, lane, 0)
        else:
            plgpu.atomic_min(fb_ref, (idx,), depth, mask=cov)
        return carry

    jax.lax.fori_loop(0, jnp.max(area), body, 0)


@functools.partial(jax.jit, static_argnames=("width", "height", "roi", "interpret"))
def rasterize_pallas(
    tris,
    poses,
    width: int,
    height: int,
    proj,
    roi: Tuple[int, int, int, int] = (0, 0, 0, 0),
    interpret: bool = False,
):
    """Render N poses -> (N, out_h, out_w) int32 depth mm with the GPU
    kernel. ``interpret=True`` runs it in the Pallas interpreter (tests on
    the CPU)."""
    out_w, out_h = rz.roi_shape(width, height, roi)
    poses = jnp.asarray(poses, jnp.float32)
    n = poses.shape[0]
    frame = out_h * out_w
    if n * frame >= 2**31:
        raise ValueError(
            f"{n} poses x {out_w}x{out_h} px overflow the kernel's int32 "
            "pixel index; split the batch"
        )

    coef, box = _triangle_setup(tris, poses, proj, width, height, roi)
    nb = coef.shape[2] // BLOCK
    fb = jnp.full((n * frame,), rz.INT32_MAX, jnp.int32)
    kernel = functools.partial(
        _kernel, out_w=out_w, frame=frame, row0=height - 1 - roi[1], rx=roi[0],
        interpret=interpret,
    )
    out = pl.pallas_call(
        kernel,
        grid=(n, nb),
        in_specs=[
            pl.BlockSpec((None, N_COEF, BLOCK), lambda i, b: (i, 0, b)),
            pl.BlockSpec((None, N_BOX, BLOCK), lambda i, b: (i, 0, b)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(fb.shape, jnp.int32),
        input_output_aliases={2: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="rasterize_atomic_min",
    )(coef, box, fb)
    return rz.finalize_depth(out.reshape(n, out_h, out_w))
