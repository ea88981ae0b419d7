"""User-facing renderer API, mirroring the reference ``PoseRenderer``
(pose_renderer.h:9-32, pose_renderer.cpp:3-76) with numpy/JAX types instead
of cv::Mat.

The reference computes its projection once from the full-resolution K and
re-uses it for down-sampled renders (pose_renderer.cpp:25-36) - NDC is
resolution-independent - and we keep that behavior.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

from pose_refine import geometry
from pose_refine.mesh import Model, morton_order
from pose_refine.ops import convert
from pose_refine.ops import rasterize as rz


class PoseRenderer:
    """Batch depth/mask renderer for one model.

    Example:
        r = PoseRenderer("obj_06.ply", K=LINEMOD_K, width=640, height=480)
        depths = r.render_depth(poses)           # (N, H, W) uint16 mm
        masks  = r.render_mask(poses, down_sample=2)
    """

    def __init__(
        self,
        model: Union[str, Model],
        K=None,
        width: int = 640,
        height: int = 480,
        backend: Optional[str] = None,
    ):
        self.model = Model.load(model) if isinstance(model, str) else model
        # spatially-coherent triangle order for the Pallas kernel's block culling
        self.tris = jnp.asarray(self.model.tris[morton_order(self.model.tris)])
        self.backend = backend
        self.K = None
        # constructor dims are remembered even without K: they become the
        # defaults for a later set_K_width_height(K) (before this they were
        # silently discarded and the caller had to re-pass them)
        self.width = int(width)
        self.height = int(height)
        self.proj_mat = None
        if K is not None:
            self.set_K_width_height(K, width, height)

    def set_K_width_height(self, K, width: Optional[int] = None,
                           height: Optional[int] = None):
        self.K = np.asarray(K, np.float32)
        self.width = int(self.width if width is None else width)
        self.height = int(self.height if height is None else height)
        self.proj_mat = geometry.compute_proj(self.K, self.width, self.height)

    def _render_raw(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)):
        if self.proj_mat is None:  # usage error: must survive python -O
            raise RuntimeError("call set_K_width_height first")
        w = int(self.width / down_sample)
        h = int(self.height / down_sample)
        poses = jnp.asarray(poses, jnp.float32)
        if poses.ndim == 2:
            poses = poses[None]
        return rz.render(
            self.tris, poses, w, h, self.proj_mat, roi=roi, backend=self.backend
        )

    def render_depth(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)):
        """(N, 4, 4) poses -> (N, H, W) uint16 depth in mm."""
        return convert.raw_to_depth_u16(self._render_raw(poses, down_sample, roi))

    def render_mask(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)):
        """(N, 4, 4) poses -> (N, H, W) uint8 mask (255 = rendered)."""
        return convert.raw_to_mask_u8(self._render_raw(poses, down_sample, roi))

    def render_depth_mask(self, poses, down_sample: float = 1.0, roi=(0, 0, 0, 0)):
        return convert.raw_to_depth_mask(self._render_raw(poses, down_sample, roi))

    @staticmethod
    def view_dep(dep) -> np.ndarray:
        """Depth -> false-color uint8 RGB for eyeballing (helper.h:126-136)."""
        d = np.asarray(dep, np.float64)
        lo, hi = d.min(), d.max()
        t = np.zeros_like(d) if hi == lo else (d - lo) / (hi - lo)
        # compact "hot" colormap: black -> red -> yellow -> white
        r = np.clip(3.0 * t, 0, 1)
        g = np.clip(3.0 * t - 1.0, 0, 1)
        b = np.clip(3.0 * t - 2.0, 0, 1)
        return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def get_bbox(depth) -> Tuple[int, int, int, int]:
    """(x, y, w, h) bbox of nonzero depth (helper::get_bbox, helper.h:13-18)."""
    d = np.asarray(depth)
    ys, xs = np.nonzero(d > 0)
    if len(xs) == 0:
        return (0, 0, 0, 0)
    return (
        int(xs.min()),
        int(ys.min()),
        int(xs.max() - xs.min() + 1),
        int(ys.max() - ys.min() + 1),
    )
