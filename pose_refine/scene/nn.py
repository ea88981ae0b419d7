"""Nearest-neighbor data association (Scene_nn equivalent, pcd_scene.h:48-137).

Two interchangeable device-side query backends behind one Scene interface:

  * ``kdtree``     - the reference's stackless descend-then-backtrack
                     traversal (pcd_scene.h:61-136) re-expressed as a vmapped
                     ``lax.while_loop``: no recursion, no stack, parent
                     pointers + last-visited tracking, bbox min-distance
                     pruning. Exact NN.
  * ``bruteforce`` - exact NN by exhaustive distance minimization over scene
                     chunks, fused by XLA into one reduction per chunk.

``scene='nn'`` takes whichever pose_refine.platform names for the device.
Both backends accept an NN iff dist^2 < max_dist_diff^2 (pcd_scene.h:127)
and return (dst_point, dst_normal, valid) via one packed-table gather.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from pose_refine.scene.kdtree import build_kdtree

FLT_MAX = jnp.float32(3.4028235e38)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneNN:
    """NN scene pytree. Build with :func:`SceneNN.from_depth` or
    :func:`SceneNN.from_cloud`."""

    points: jnp.ndarray      # (P, 3) float32, kd-reordered
    normals: jnp.ndarray     # (P, 3) float32
    table: jnp.ndarray       # (P, 8) float32 [pcd xyz, normal xyz, 0, 0] - one-gather result lookup
    parent: jnp.ndarray      # (M,) int32
    child: jnp.ndarray       # (M, 2) int32
    split_dim: jnp.ndarray   # (M,) int32
    split_v: jnp.ndarray     # (M,) float32
    bbox: jnp.ndarray        # (M, 6) float32
    bounds: jnp.ndarray      # (M, 2) int32
    max_dist_diff: jnp.ndarray  # () float32
    leaf_cap: int = dataclasses.field(metadata=dict(static=True), default=16)
    backend: str = dataclasses.field(metadata=dict(static=True), default="kdtree")
    max_steps: int = dataclasses.field(metadata=dict(static=True), default=512)

    @classmethod
    def from_cloud(
        cls,
        points,
        normals,
        max_dist_diff: float = 0.1,
        leaf_size: int = 10,
        backend: str = "kdtree",
    ) -> "SceneNN":
        if backend not in ("kdtree", "bruteforce"):
            # query()'s dispatch falls through to the kd traversal - a
            # typo'd backend must fail here, not silently run another one
            raise ValueError(
                f"unknown SceneNN backend {backend!r}; "
                "use 'kdtree' or 'bruteforce'"
            )
        tree = build_kdtree(np.asarray(points), np.asarray(normals), leaf_size)
        # provably sufficient traversal bound: the descend+backtrack walk is a
        # pruned DFS in which each node is `cur` at most 3 times (first entry,
        # backtrack from each child), so 3*n_nodes+2 can never truncate - the
        # while_loop exits on cur<0 long before this in practice, and the cap
        # costs nothing (while_loop work is data-dependent, not bound-bound)
        max_steps = 3 * tree.n_nodes + 2
        packed = np.concatenate(
            [tree.points, tree.normals,
             np.zeros((len(tree.points), 2), np.float32)],
            axis=1,
        )
        return cls(
            points=jnp.asarray(tree.points),
            normals=jnp.asarray(tree.normals),
            table=jnp.asarray(packed),
            parent=jnp.asarray(tree.parent),
            child=jnp.asarray(tree.child),
            split_dim=jnp.asarray(tree.split_dim),
            split_v=jnp.asarray(tree.split_v),
            bbox=jnp.asarray(tree.bbox),
            bounds=jnp.asarray(tree.bounds),
            max_dist_diff=jnp.float32(max_dist_diff),
            leaf_cap=int(2 ** int(np.ceil(np.log2(max(tree.max_leaf_points(), 1))))),
            backend=backend,
            max_steps=int(max_steps),
        )

    @classmethod
    def from_depth(
        cls, depth, K, max_dist_diff: float = 0.1, leaf_size: int = 10,
        backend: str = "kdtree", voxel_mm: float = 0.0,
    ) -> "SceneNN":
        """init_Scene_nn_cpu equivalent (pcd_scene.cpp:4-37): valid pixels ->
        points + LINEMOD normals -> kd-tree.

        voxel_mm > 0 voxel-downsamples the scene cloud first (centroid point
        + renormalized mean normal per voxel) - standard ICP practice the
        reference leaves to the user; exact-NN cost is O(queries x scene), so
        scene size is the honest throughput lever for the NN backends. Pick
        well under the gate (e.g. 4 mm against 0.1 m); see
        scripts/nn_voxel_study.py for measured accuracy/speed trade-offs."""
        from pose_refine import platform

        if isinstance(depth, jax.Array) and platform.is_accelerator():
            # device-resident depth: one fused program + one transfer
            pts, nrm, mask = jax.device_get(
                _depth_scene_arrays(depth, jnp.asarray(K, jnp.float32))
            )
        else:
            # sensor depth starts on the host: build there, upload once
            pts, nrm, mask = _depth_scene_arrays_host(depth, K)
        m = mask.reshape(-1)
        p = pts.reshape(-1, 3)[m]
        n = nrm.reshape(-1, 3)[m]
        if voxel_mm > 0.0:
            p, n = voxel_downsample(p, n, voxel_mm / 1000.0)
        return cls.from_cloud(p, n, max_dist_diff, leaf_size, backend)

    @classmethod
    def from_depth_device(
        cls, depth, K, max_dist_diff=0.1, stride: int = 1,
        tl_x: int = 0, tl_y: int = 0, perm=None,
        pool: int = 1, pool_depth_tol: float = 0.005,
    ) -> "SceneNN":
        """Brute-force NN scene built ENTIRELY ON DEVICE - jit-traceable,
        so a tracking loop fuses the per-frame scene build into the
        refinement program (the reference rebuilds Scene_nn on the host
        every frame, pcd_scene.cpp:4-37; the projective twin of this fusion
        is pipeline.track_poses_jit).

        No compaction, no kd-tree: the strided pixel grid IS the scene
        table (static shape), and invalid pixels are parked 1e6 m away,
        where they can never win a min inside the gate. A static Morton
        permutation of the (row, col) grid keeps the table in the same
        spatial order as the host build's kd reorder.

        Exact: for every query whose true neighbor is a valid pixel within
        the gate, the result equals the host-built scene's. stride > 1
        subsamples the scene grid (the device analog of voxel_mm); pool > 1
        is the on-device analog of CENTROID voxel downsampling
        (_pool_scene_grid) - it keeps voxel_mm's measured denoising benefit
        (voxel centroids average away the 1 mm depth quantization,
        scripts/nn_voxel_study.py) where stride just drops points.
        """
        from pose_refine.ops.depth_to_cloud import depth_image_to_points
        from pose_refine.ops.normals import estimate_normals

        if stride > 1 and pool > 1:
            raise ValueError("stride and pool are alternative downsamplers; "
                             "set only one > 1")
        depth = jnp.asarray(depth)
        nrm = estimate_normals(depth, K)  # full-res stencil (reference res)
        pts, mask = depth_image_to_points(depth, K, tl_x=tl_x, tl_y=tl_y)
        if stride != 1:
            pts = pts[::stride, ::stride]
            nrm = nrm[::stride, ::stride]
            mask = mask[::stride, ::stride]
        if pool > 1:
            pts, nrm, mask = _pool_scene_grid(
                pts, nrm, mask, int(pool), float(pool_depth_tol))
        h, w = mask.shape
        if perm is None:
            # standalone use: bake the static permutation into the trace;
            # hot loops (track_poses_nn_jit) pass it as an argument
            perm = jnp.asarray(_grid_morton_perm(h, w))
        m = mask.reshape(-1)[perm]
        far = jnp.float32(1.0e6)  # meters; beyond any gate
        p_tab = jnp.where(m[:, None], pts.reshape(-1, 3)[perm], far)
        n_tab = jnp.where(m[:, None], nrm.reshape(-1, 3)[perm], 0.0)
        nr = p_tab.shape[0]
        packed = jnp.concatenate(
            [p_tab, n_tab, jnp.zeros((nr, 2), jnp.float32)], axis=1
        )
        one_i = jnp.zeros((1,), jnp.int32)
        return cls(
            points=p_tab,
            normals=n_tab,
            table=packed,
            # kd arrays stubbed: this scene serves the bruteforce backend
            # only (the kd build is host work)
            parent=one_i - 1,
            child=jnp.full((1, 2), -1, jnp.int32),
            split_dim=one_i,
            split_v=jnp.zeros((1,), jnp.float32),
            bbox=jnp.zeros((1, 6), jnp.float32),
            bounds=jnp.stack([one_i, one_i + nr], axis=1),
            max_dist_diff=jnp.float32(max_dist_diff)
            if not isinstance(max_dist_diff, jnp.ndarray) else max_dist_diff,
            leaf_cap=1,
            backend="bruteforce",
            max_steps=1,
        )

    # ------------------------------------------------------------------ query

    def query(self, src):
        if self.backend == "bruteforce":
            idx, dist_sq = _nn_bruteforce(src, self.points)
        else:
            idx, dist_sq = _nn_kdtree(src, self)
        valid = dist_sq < self.max_dist_diff * self.max_dist_diff
        rows = jnp.take(self.table, idx, axis=0)  # single packed gather
        return rows[..., 0:3], rows[..., 3:6], valid


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneNNStack:
    """K NN scene frames stacked into ONE set of flat tables, addressed per
    pose by a scene id - the NN twin of
    :class:`~pose_refine.scene.projective.SceneProjectiveStack`.

    The reference serves mixed scenes with one CUDA stream per frame
    (README.md:15); here K frames share one fused program. Every frame's
    kd-reordered point table is padded to the widest frame (pad rows parked
    far away), so the stack is K equal-height regions and each pose's
    brute-force scan covers ONE frame's region, not the stack - results
    match the per-frame scene exactly (same kd reorder -> same rows -> same
    in-gate NN, ties included).

    Brute-force backend only: the kd traversal binds per-scene tree arrays.
    """

    table: jnp.ndarray        # (K*P_pad, 8) [pcd xyz, normal xyz, 0, 0]
    points: jnp.ndarray       # (K*P_pad, 3) pad rows parked FAR
    max_dist_diff: jnp.ndarray  # () float32
    frame_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_scenes: int = dataclasses.field(metadata=dict(static=True), default=1)
    backend: str = dataclasses.field(
        metadata=dict(static=True), default="bruteforce")

    @classmethod
    def from_clouds(
        cls, clouds, normals, max_dist_diff: float = 0.1,
        leaf_size: int = 10, backend: str = "bruteforce",
    ) -> "SceneNNStack":
        """Build from K (point, normal) cloud pairs (lists of (P_k, 3)
        arrays). Each frame is kd-REORDERED (build_kdtree - the same order
        its standalone SceneNN would use) then padded to the widest frame."""
        if backend != "bruteforce":
            raise ValueError(
                f"SceneNNStack supports the 'bruteforce' backend, not "
                f"{backend!r} (the kd traversal binds per-scene trees)"
            )
        if len(clouds) != len(normals) or not clouds:
            raise ValueError("from_clouds wants equal-length non-empty lists")
        ordered = []
        for p, n in zip(clouds, normals):
            tree = build_kdtree(np.asarray(p), np.asarray(n), leaf_size)
            ordered.append((tree.points, tree.normals))
        rows = max(len(p) for p, _ in ordered)
        packed, far_pts = [], []
        for p, n in ordered:
            pad = rows - len(p)
            packed.append(np.concatenate([
                np.concatenate([p, n, np.zeros((len(p), 2), np.float32)], 1),
                np.zeros((pad, 8), np.float32)], 0))
            far_pts.append(np.concatenate([
                p, np.full((pad, 3), 1.0e6, np.float32)], 0))
        return cls(
            table=jnp.asarray(np.concatenate(packed, axis=0)),
            points=jnp.asarray(np.concatenate(far_pts, axis=0)),
            max_dist_diff=jnp.float32(max_dist_diff),
            frame_rows=int(rows),
            n_scenes=len(ordered),
            backend=backend,
        )

    @classmethod
    def from_depths(
        cls, depths, K, max_dist_diff: float = 0.1, leaf_size: int = 10,
        backend: str = "bruteforce", voxel_mm: float = 0.0,
    ) -> "SceneNNStack":
        """Build from (K, H, W) mm depth frames: the host numpy pipeline of
        SceneNN.from_depth per frame (points + LINEMOD normals + optional
        voxel downsample), stacked."""
        frames = np.asarray(depths)
        if frames.ndim != 3 or frames.shape[0] < 1:
            raise ValueError(
                f"from_depths wants (K, H, W) frames, got {frames.shape}"
            )
        clouds, nrms = [], []
        for d in frames:
            pts, nrm, mask = _depth_scene_arrays_host(d, K)
            m = mask.reshape(-1)
            p = pts.reshape(-1, 3)[m]
            n = nrm.reshape(-1, 3)[m]
            if voxel_mm > 0.0:
                p, n = voxel_downsample(p, n, voxel_mm / 1000.0)
            if not len(p):
                raise ValueError(
                    "a scene frame has no valid depth pixels - cannot "
                    "stack an empty NN scene"
                )
            clouds.append(p)
            nrms.append(n)
        return cls.from_clouds(
            clouds, nrms, max_dist_diff, leaf_size, backend)

    def query_at(self, sid):
        """The NN query closure bound to frame ``sid`` (a traced int32
        scalar) - vmapped over poses so each lane associates against its
        own frame with ONE frame's scan cost.

        ``sid`` is clamped to [0, n_scenes): device-resident ids skip the
        host range check (metadata-only validation, pipeline.refine
        docstring), and an unclamped out-of-range id would read past the
        stacked table."""
        sid = jnp.clip(jnp.asarray(sid, jnp.int32), 0, self.n_scenes - 1)
        base = sid * jnp.int32(self.frame_rows)

        def query(src):
            # slice the frame's rows (static size, traced start - batches
            # cleanly under vmap), then lift the frame-local argmin back to
            # stacked-table rows
            pts = jax.lax.dynamic_slice(
                self.points, (base, jnp.int32(0)), (self.frame_rows, 3))
            idx, dist_sq = _nn_bruteforce(src, pts)
            idx = idx + base
            valid = dist_sq < self.max_dist_diff * self.max_dist_diff
            rows = jnp.take(self.table, idx, axis=0)
            return rows[..., 0:3], rows[..., 3:6], valid

        return query


def _pool_scene_grid(pts, nrm, mask, pool: int, depth_tol: float):
    """On-device voxel-equivalent downsampling of a depth-grid scene:
    depth-aware centroid pooling over pool x pool pixel blocks.

    The scene cloud comes from a pixel GRID, so voxel-centroid
    downsampling (the host path's scene_voxel_mm, nn.voxel_downsample) maps
    to average-pooling valid pixels per block - pure lax.reduce_window,
    no scatter, so it fuses into the track() program. One refinement over
    plain pooling: a block that straddles a
    depth EDGE would average foreground with background into a ghost point
    between the surfaces (a real 3D voxel grid separates them by z).
    Depth-aware pooling keeps each block's FOREGROUND sheet: only pixels
    within depth_tol (meters) of the block's min depth enter the centroid -
    background points in edge blocks are dropped (benign for association
    density), never fabricated. depth_tol must cover in-surface depth
    variation across the block (default 5 mm handles ~45 deg slopes at
    typical LINEMOD scales); the pooled normal is the renormalized mean of
    the same pixels' full-res stencil normals, matching voxel_downsample.
    """
    h, w = mask.shape
    ph, pw = (-h) % pool, (-w) % pool
    if ph or pw:
        pts = jnp.pad(pts, ((0, ph), (0, pw), (0, 0)))
        nrm = jnp.pad(nrm, ((0, ph), (0, pw), (0, 0)))
        mask = jnp.pad(mask, ((0, ph), (0, pw)))

    def pool_sum(img):
        return jax.lax.reduce_window(
            img, 0.0, jax.lax.add,
            (pool, pool) + (1,) * (img.ndim - 2),
            (pool, pool) + (1,) * (img.ndim - 2), "VALID")

    z = jnp.where(mask, pts[..., 2], jnp.inf)
    zmin = jax.lax.reduce_window(
        z, jnp.inf, jax.lax.min, (pool, pool), (pool, pool), "VALID")
    zmin_up = jnp.repeat(jnp.repeat(zmin, pool, axis=0), pool, axis=1)
    keep = mask & (pts[..., 2] <= zmin_up + depth_tol)
    v = keep.astype(jnp.float32)
    cnt = pool_sum(v)
    denom = jnp.maximum(cnt, 1.0)[..., None]
    pts_c = pool_sum(pts * v[..., None]) / denom
    n_sum = pool_sum(nrm * v[..., None])
    n_len = jnp.linalg.norm(n_sum, axis=-1, keepdims=True)
    nrm_c = n_sum / jnp.maximum(n_len, 1e-12)
    return pts_c, nrm_c, cnt > 0.0


@jax.jit
def _depth_scene_arrays(depth, K):
    """Fused depth -> (point image, normals, mask) for the host scene build:
    one program, one device->host transfer."""
    from pose_refine.ops.depth_to_cloud import depth_image_to_points
    from pose_refine.ops.normals import estimate_normals

    pts, mask = depth_image_to_points(depth, K)
    nrm = estimate_normals(depth, K)
    return pts, nrm, mask


def _depth_scene_arrays_host(depth, K, radius: int = 5,
                             difference_threshold: int = 50,
                             distance_threshold: int = 2000):
    """Numpy twin of _depth_scene_arrays for the HOST scene build: the
    sensor depth starts on the host, so the build stays there and uploads
    once. Same arithmetic (int stencil accumulators, f32 products) as
    ops/normals.py and ops/depth_to_cloud.py; equality is pinned in tests."""
    from pose_refine.ops.normals import _OFFSETS

    d = np.asarray(depth).astype(np.int32)
    h, w = d.shape
    Kf = np.asarray(K, np.float32)
    r = radius
    pad = np.pad(d, r)

    a0 = np.zeros((h, w), np.int32)
    a1 = np.zeros((h, w), np.int32)
    a3 = np.zeros((h, w), np.int32)
    b0 = np.zeros((h, w), np.int32)
    b1 = np.zeros((h, w), np.int32)
    for ox, oy in _OFFSETS:
        dx, dy = ox * r, oy * r
        neighbor = pad[r + dy: r + dy + h, r + dx: r + dx + w]
        delta = neighbor - d
        f = (np.abs(delta) < difference_threshold).astype(np.int32)
        a0 += f * (dx * dx)
        a1 += f * (dx * dy)
        a3 += f * (dy * dy)
        b0 += f * dx * delta
        b1 += f * dy * delta
    det = a0 * a3 - a1 * a1
    ddx = a3 * b0 - a1 * b1
    ddy = -a1 * b0 + a0 * b1
    nx = Kf[0, 0] * ddx.astype(np.float32)
    ny = Kf[1, 1] * ddy.astype(np.float32)
    nz = -det.astype(np.float32) * d.astype(np.float32)
    norm = np.sqrt(nx * nx + ny * ny + nz * nz)
    row = np.arange(h)[:, None]
    col = np.arange(w)[None, :]
    interior = (row >= r) & (row < h - r - 1) & (col >= r) & (col < w - r - 1)
    ok = (d < distance_threshold) & (norm > 0) & interior
    inv = np.where(ok, np.float32(1.0) / np.where(norm > 0, norm, np.float32(1.0)),
                   np.float32(0.0)).astype(np.float32)
    nrm = np.stack([nx * inv, ny * inv, nz * inv], axis=-1)

    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    z = (d.astype(np.float32) / np.float32(1000.0))
    x = (u - Kf[0, 2]) / Kf[0, 0] * z
    y = (v - Kf[1, 2]) / Kf[1, 1] * z
    mask = d > 0
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    pts = np.where(mask[..., None], pts, np.float32(0.0))
    return pts, nrm.astype(np.float32), mask


@functools.lru_cache(maxsize=64)
def _grid_morton_perm(h: int, w: int) -> np.ndarray:
    """Morton (Z-curve) permutation of the row-major (h, w) pixel grid.

    Static per grid shape (cached, computed in numpy at trace time): applied
    as one gather it orders scene entries so consecutive rows cover compact
    pixel squares, as the host build's kd reorder does."""
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.uint32), np.arange(w, dtype=np.uint32), indexing="ij"
    )

    def spread(v):  # interleave 16 bits with 1-bit gaps
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    code = spread(xx) | (spread(yy) << np.uint32(1))
    return np.argsort(code.reshape(-1), kind="stable")


def voxel_downsample(points, normals, voxel_m: float):
    """Centroid-average points (and renormalize mean normals) per uniform
    voxel of edge ``voxel_m`` meters. Host-side numpy, like the rest of the
    scene build (SURVEY 3.3: scene init is host work in the reference too).
    """
    p = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    if p.shape[0] == 0:
        return p.astype(np.float32), n.astype(np.float32)
    lo = p.min(axis=0)
    cell = np.floor((p - lo) / float(voxel_m)).astype(np.int64)
    if cell.max() >= (1 << 21):  # 21 bits per axis in the packed key below
        raise ValueError(
            f"cloud spans {cell.max() + 1} voxels on one axis (> 2^21): "
            f"voxel {voxel_m} m is too small for this extent/unit"
        )
    key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
    uniq, inverse = np.unique(key, return_inverse=True)
    cnt = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    ps = np.zeros((len(uniq), 3))
    ns = np.zeros((len(uniq), 3))
    np.add.at(ps, inverse, p)
    np.add.at(ns, inverse, n)
    ps /= cnt[:, None]
    norm = np.linalg.norm(ns, axis=1, keepdims=True)
    ns = np.where(norm > 1e-12, ns / np.maximum(norm, 1e-12), ns)
    return ps.astype(np.float32), ns.astype(np.float32)


def _nn_kdtree(src, scene: SceneNN, prune: str = "far", return_steps: bool = False):
    """Stackless kd-tree NN for a batch of query points.

    One lax.while_loop per point (vmapped): descend toward the query; at a
    leaf, scan its <= leaf_cap points; backtrack via parent pointers,
    visiting the far child only when a bbox says it could still beat the
    best distance (pcd_scene.h:84-124). A step cap bounds the loop
    statically.

    prune: which bbox gates the far-child descent.
      "far"  - the FAR CHILD's own subtree bbox (default): strictly tighter
               than the reference while still exact - the current node's
               bbox also spans the already-visited child, so its
               min-possible distance is never larger. Requires leaf bboxes
               (kdtree.py fills every node's bbox).
      "node" - the current node's bbox, bit-matching the reference
               traversal (pcd_scene.h:104-118); kept for the measured
               step-count comparison (scripts/kd_pruning_study.py).
    """
    leaf_cap = scene.leaf_cap
    max_steps = scene.max_steps

    def one(p):
        def cond(s):
            cur, last, back, bi, bd, steps = s
            return (cur >= 0) & (steps < max_steps)

        def body(s):
            cur, last, back, bi, bd, steps = s
            sd = scene.split_dim[cur]
            sv = scene.split_v[cur]
            c1 = scene.child[cur, 0]
            c2 = scene.child[cur, 1]
            par = scene.parent[cur]
            diff = p[sd] - sv
            best_child = jnp.where(diff < 0, c1, c2)
            other = jnp.where(diff < 0, c2, c1)
            is_leaf = (c1 < 0) | (c2 < 0)

            # --- leaf scan (bounded unrolled gather) ---
            left = scene.bounds[cur, 0]
            right = scene.bounds[cur, 1]
            offs = jnp.arange(leaf_cap)
            lidx = left + offs
            lval = jnp.take(scene.points, jnp.clip(lidx, 0, scene.points.shape[0] - 1), axis=0)
            d2 = jnp.sum((lval - p) ** 2, axis=-1)
            d2 = jnp.where(lidx < right, d2, FLT_MAX)
            j = jnp.argmin(d2)
            leaf_bd = d2[j]
            leaf_bi = lidx[j]
            upd = is_leaf & ~back & (leaf_bd < bd)
            bd2 = jnp.where(upd, leaf_bd, bd)
            bi2 = jnp.where(upd, leaf_bi, bi)

            # --- bbox min-possible-distance pruning (pcd_scene.h:104-111).
            # prune="far" tests the far child's own subtree box (other is a
            # real node whenever the gate is consulted: backtrack mode only
            # reaches interior nodes, which always have both children) ---
            bb = scene.bbox[other] if prune == "far" else scene.bbox[cur]
            lo = bb[0::2]
            hi = bb[1::2]
            delta = jnp.maximum(lo - p, 0.0) + jnp.maximum(p - hi, 0.0)
            min_poss = jnp.sum(delta * delta)

            # --- transitions ---
            # descend, non-leaf: go to near child
            # descend, leaf:     scan done -> backtrack to parent
            # backtrack: if far child unvisited and bbox can beat best -> far
            #            child (descend mode), else continue to parent
            go_far = back & (last == best_child) & (min_poss <= bd2)
            nxt = jnp.where(
                back,
                jnp.where(go_far, other, par),
                jnp.where(is_leaf, par, best_child),
            )
            nback = jnp.where(back, ~go_far, is_leaf)
            return (nxt, cur, nback, bi2, bd2, steps + 1)

        init = (jnp.int32(0), jnp.int32(-1), jnp.asarray(False), jnp.int32(0), FLT_MAX, jnp.int32(0))
        cur, last, back, bi, bd, steps = jax.lax.while_loop(cond, body, init)
        return bi, bd, steps

    flat = src.reshape(-1, 3)
    idx, dist, steps = jax.vmap(one)(flat)
    shape = src.shape[:-1]
    if return_steps:
        return idx.reshape(shape), dist.reshape(shape), steps.reshape(shape)
    return idx.reshape(shape), dist.reshape(shape)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _nn_bruteforce(src, scene_pts, chunk: int = 2048):
    """Exact NN by exhaustive search, one scene chunk per scan step.

    Each step's (P, chunk) squared distances are plain coordinate
    differences reduced together with their column index in ONE variadic
    reduction, which XLA fuses: the distance block is never written to
    memory, and no matrix product (so no reduced-precision TF32 path) is
    involved. A running (dist, idx) min is carried through the scan; ties
    keep the lowest scene row, as argmin does.
    """
    src = jnp.asarray(src, jnp.float32)
    flat = src.reshape(-1, 3)
    n_scene = scene_pts.shape[0]
    chunk = min(chunk, n_scene)
    pad = (-n_scene) % chunk
    pts = jnp.concatenate(
        [scene_pts, jnp.full((pad, 3), 1e6, scene_pts.dtype)], axis=0
    ) if pad else scene_pts
    n_chunks = pts.shape[0] // chunk
    chunks = pts.reshape(n_chunks, chunk, 3)

    def body(carry, sc):
        best_d, best_i, base = carry
        d = (
            (flat[:, None, 0] - sc[None, :, 0]) ** 2
            + (flat[:, None, 1] - sc[None, :, 1]) ** 2
            + (flat[:, None, 2] - sc[None, :, 2]) ** 2
        )
        dmin, j = _min_and_argmin(d)
        better = dmin < best_d
        best_d = jnp.where(better, dmin, best_d)
        best_i = jnp.where(better, base + j, best_i)
        return (best_d, best_i, base + chunk), None

    init = (jnp.full(flat.shape[0], FLT_MAX), jnp.zeros(flat.shape[0], jnp.int32), jnp.int32(0))
    (best_d, best_i, _), _ = jax.lax.scan(body, init, chunks)
    return best_i.reshape(src.shape[:-1]), best_d.reshape(src.shape[:-1])


def _min_and_argmin(d):
    """(min, first argmin) over the last axis of a 2-D array in one
    variadic reduction."""
    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)

    def pick(a, b):
        (av, ai), (bv, bi) = a, b
        take_a = (av < bv) | ((av == bv) & (ai < bi))
        return jnp.where(take_a, av, bv), jnp.where(take_a, ai, bi)

    return jax.lax.reduce(
        (d, col), (jnp.float32(jnp.inf), jnp.int32(0)), pick, (1,)
    )
