"""Projective data association: look the source point up in the scene depth
image via the camera intrinsics.

A re-expression of Scene_projective (depth_scene.h:7-49): the scene is a
pytree holding one packed (H*W, 8) float32 table of
[point xyz | normal xyz | pad pad] rows, so the per-point query is a single
row gather (one 8-wide gather instead of two 3-wide ones). ``query`` is a pure project->gather->gate; because the
scene is a pytree with a pure method, the whole ICP loop jits and vmaps with
the scene captured as an operand.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pose_refine import geometry
from pose_refine.ops.depth_to_cloud import depth_image_to_points
from pose_refine.ops.normals import estimate_normals


@jax.jit
def _build_projective_table(depth, K):
    """points + normals + packed (H*W, 8) table in one program (recompiles
    once per frame resolution; the shape is static per camera)."""
    pts, _mask = depth_image_to_points(depth, K)
    nrm = estimate_normals(depth, K)
    h, w = pts.shape[:2]
    return jnp.concatenate(
        [
            pts.reshape(-1, 3),
            nrm.reshape(-1, 3),
            jnp.zeros((h * w, 2), jnp.float32),
        ],
        axis=1,
    )


@jax.jit
def _build_projective_table_stack(depths, K):
    """K stacked frames' tables in one program (SceneProjectiveStack)."""
    tables = jax.vmap(lambda d: _build_projective_table(d, K))(depths)
    return tables.reshape(-1, 8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneProjective:
    """Scene = packed point+normal table + intrinsics.

    query semantics (depth_scene.h:29-48): project the source point with
    pcd2dep rounding, bounds-check the pixel, gate on scene z > 0 and
    |src.z - dst.z| <= max_dist_diff (0.1 m default, depth_scene.h:9).
    """

    table: jnp.ndarray          # (H*W, 8) float32: [pcd xyz, normal xyz, 0, 0]
    K: jnp.ndarray              # (3, 3) float32
    max_dist_diff: jnp.ndarray  # () float32
    height: int = dataclasses.field(metadata=dict(static=True), default=480)
    width: int = dataclasses.field(metadata=dict(static=True), default=640)

    @classmethod
    def from_depth(cls, depth, K, max_dist_diff: float = 0.1) -> "SceneProjective":
        """Build from an (H, W) mm depth image: per-pixel dep2pcd + LINEMOD
        normals (init_Scene_projective_cpu behavior). ONE jitted program:
        eager jnp ops in a per-frame set_scene_depth loop would each pay a
        dispatch."""
        depth = jnp.asarray(depth)
        h, w = depth.shape
        table = _build_projective_table(depth, jnp.asarray(K, jnp.float32))
        return cls(
            table=table,
            K=jnp.asarray(K, jnp.float32),
            max_dist_diff=jnp.float32(max_dist_diff),
            height=int(h),
            width=int(w),
        )

    @property
    def pcd(self):
        """(H, W, 3) point image view (tests / visualization)."""
        return self.table[:, 0:3].reshape(self.height, self.width, 3)

    @property
    def normal(self):
        """(H, W, 3) normal image view."""
        return self.table[:, 3:6].reshape(self.height, self.width, 3)

    def query(self, src):
        """(..., 3) source points -> (dst (...,3), normal (...,3), valid (...))."""
        return _project_gate(
            self.table, self.K, self.max_dist_diff,
            self.height, self.width, src,
        )


def _project_gate(table, K, max_dist_diff, h: int, w: int, src, base=0):
    """The projective query core (depth_scene.h:29-48): pcd2dep rounding,
    pixel bounds check, one packed row gather (offset by ``base`` rows for
    stacked multi-frame tables), scene z > 0 and |dz| <= gate."""
    xyd = geometry.pcd2dep(src, K)
    x, y = xyd[..., 0], xyd[..., 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    lin = jnp.clip(y, 0, h - 1) * w + jnp.clip(x, 0, w - 1)
    rows = jnp.take(table, base + lin, axis=0)
    dst = rows[..., 0:3]
    nrm = rows[..., 3:6]
    valid = inb & (dst[..., 2] > 0) & (
        jnp.abs(src[..., 2] - dst[..., 2]) <= max_dist_diff
    )
    return dst, nrm, valid


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneProjectiveStack:
    """K same-shape projective scene frames in ONE flat table, addressed
    per pose by a scene id.

    The reference runs concurrent ICPs against *different* scene frames via
    per-thread CUDA streams (README.md:15, cuda_icp/icp.cu:170). Here it
    is not K dispatches but ONE program: a gather's cost follows its row
    count, not the table size, so stacking K (H*W, 8) tables into a
    (K*H*W, 8) table and adding sid*H*W to each pose's row index costs
    nothing per query - while saving (K-1) program dispatches. Same-resolution
    frames mean no padding: every lane gathers the same row count.
    """

    table: jnp.ndarray          # (K*H*W, 8) float32: [pcd xyz, normal xyz, 0, 0]
    K: jnp.ndarray              # (3, 3) float32 (shared camera)
    max_dist_diff: jnp.ndarray  # () float32
    height: int = dataclasses.field(metadata=dict(static=True), default=480)
    width: int = dataclasses.field(metadata=dict(static=True), default=640)
    n_scenes: int = dataclasses.field(metadata=dict(static=True), default=1)

    @classmethod
    def from_depths(
        cls, depths, K, max_dist_diff: float = 0.1
    ) -> "SceneProjectiveStack":
        """Build from (K, H, W) mm depth frames (one vmapped program: the
        per-frame dep2pcd + LINEMOD normal stencil of
        SceneProjective.from_depth)."""
        depths = jnp.asarray(depths)
        if depths.ndim != 3:
            raise ValueError(
                f"from_depths wants (K, H, W) frames, got {depths.shape}"
            )
        k, h, w = depths.shape
        Kj = jnp.asarray(K, jnp.float32)
        table = _build_projective_table_stack(depths, Kj)
        return cls(
            table=table,
            K=Kj,
            max_dist_diff=jnp.float32(max_dist_diff),
            height=int(h),
            width=int(w),
            n_scenes=int(k),
        )

    def lane(self, i: int) -> SceneProjective:
        """Frame ``i`` (static python int) as a standalone SceneProjective -
        the parity anchor: refine(scene_ids=ids) must equal refining each
        pose against its lane."""
        hw = self.height * self.width
        return SceneProjective(
            table=self.table[i * hw : (i + 1) * hw],
            K=self.K,
            max_dist_diff=self.max_dist_diff,
            height=self.height,
            width=self.width,
        )

    def query_at(self, sid):
        """The query closure bound to scene ``sid`` (a traced int32
        scalar) - vmapped over poses so each lane associates against its
        own frame with the SAME gather count as a single-scene query.

        ``sid`` is clamped to [0, n_scenes) here: device-resident ids are
        validated by shape only (pipeline.refine docstring), and without
        the clamp an out-of-range id would push ``base`` past the table,
        where jnp.take's fill mode poisons every association with NaN
        instead of the documented nearest-valid-frame behavior."""
        sid = jnp.clip(jnp.asarray(sid, jnp.int32), 0, self.n_scenes - 1)
        base = sid * jnp.int32(self.height * self.width)

        def query(src):
            return _project_gate(
                self.table, self.K, self.max_dist_diff,
                self.height, self.width, src, base=base,
            )

        return query
