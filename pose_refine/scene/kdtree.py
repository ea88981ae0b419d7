"""Host-side kd-tree construction into flat SoA arrays.

The reference builds its kd-tree on the CPU even for the CUDA path
(pcd_scene.cu:5-6, README note "tree ALWAYS built on CPU"), level by level
without recursion (pcd_scene.cpp:45-184). We keep that split of labor - build
on host, query on device - but emit structure-of-arrays int32/float32 buffers
that device code can gather from, instead of an array-of-structs.

Build semantics preserved (so NN results match the reference exactly):
  * split along the widest bbox dimension at the bbox midpoint
  * stable partition with tie-alternation for balance (pcd_scene.cpp:118-133)
  * split value re-centered to the midpoint of the gap between the two sides
    (pcd_scene.cpp:135)
  * leaves hold <= leaf_size points (default 10, pcd_scene.cpp:45)
  * points/normals reordered so leaf ranges are contiguous and queries never
    indirect through an index array (pcd_scene.cpp:173-183)

A native C++ builder with identical output is available via
pose_refine.native (used automatically when compiled); this numpy
implementation is the portable fallback and the parity oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KDTree:
    """Flat kd-tree. Node i is a leaf iff child[i, 0] < 0.

    Arrays:
      points:  (P, 3) float32 - reordered scene points
      normals: (P, 3) float32 - reordered normals
      parent:  (M,) int32
      child:   (M, 2) int32, -1 for leaves
      split_dim: (M,) int32
      split_v:  (M,) float32
      bbox:    (M, 6) float32 [xmin xmax ymin ymax zmin zmax]
      bounds:  (M, 2) int32 leaf point range [left, right)
    """

    points: np.ndarray
    normals: np.ndarray
    parent: np.ndarray
    child: np.ndarray
    split_dim: np.ndarray
    split_v: np.ndarray
    bbox: np.ndarray
    bounds: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.parent)

    def max_leaf_points(self) -> int:
        leaf = self.child[:, 0] < 0
        if not leaf.any():
            return 0
        return int((self.bounds[leaf, 1] - self.bounds[leaf, 0]).max())


def ensure_leaf_bboxes(points, child, bounds, bbox):
    """Fill missing (all-zero) LEAF bbox rows from the reordered points.

    Trees serialized before round 3 carry bboxes only for interior nodes;
    the far-child pruning the traversal now defaults to reads the descend
    TARGET's bbox, and a zero leaf box would prune correct descents -
    silently wrong neighbors. Returns bbox (possibly updated, numpy)."""
    bbox = np.array(bbox, np.float32, copy=True)
    pts = np.asarray(points)
    leaf = np.asarray(child)[:, 0] < 0
    stale = leaf & (np.abs(bbox).sum(axis=1) == 0.0)
    for i in np.nonzero(stale)[0]:
        left, right = np.asarray(bounds)[i]
        if right > left:
            seg = pts[left:right]
            lo, hi = seg.min(axis=0), seg.max(axis=0)
            bbox[i] = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])
    return bbox


def build_kdtree(points, normals, leaf_size: int = 10, backend: str = "auto") -> KDTree:
    """Build a kd-tree. backend: 'auto' (native C++ when compiled, else
    numpy), 'native', or 'numpy'."""
    points = np.ascontiguousarray(points, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    n = len(points)
    if n == 0:
        # a sensor-dropout frame (all-zero depth / everything gated) must
        # fail loudly here, not as an argmax-of-empty deep in the split loop
        raise ValueError(
            "build_kdtree: empty cloud - the depth frame produced no valid "
            "scene points (sensor dropout?); projective scenes tolerate "
            "such frames, NN scenes cannot be built from them"
        )
    if len(normals) != n:
        raise ValueError(
            f"build_kdtree: {n} points but {len(normals)} normals"
        )
    if leaf_size < 1:
        # leaf_size=0 never terminates a 1-point node (the single point
        # ties at the bbox midpoint and re-splits forever)
        raise ValueError(f"build_kdtree: leaf_size must be >= 1, got {leaf_size}")

    if backend in ("auto", "native"):
        from pose_refine import native

        out = native.build_kdtree_native(points, leaf_size)
        if out is not None:
            order, parent, child, split_dim, split_v, bbox, bounds, _m = out
            return KDTree(
                points=points[order],
                normals=normals[order],
                parent=parent,
                child=child,
                split_dim=split_dim,
                split_v=split_v,
                bbox=bbox,
                bounds=bounds,
            )
        if backend == "native":
            raise RuntimeError("native kd-tree builder unavailable (no g++?)")

    # worst case node count: every split peels off >= 1 point per side
    cap = max(2 * n, 16)
    parent = np.full(cap, -1, np.int32)
    child = np.full((cap, 2), -1, np.int32)
    split_dim = np.zeros(cap, np.int32)
    split_v = np.zeros(cap, np.float32)
    bbox = np.zeros((cap, 6), np.float32)
    bounds = np.zeros((cap, 2), np.int32)

    index = np.arange(n, dtype=np.int64)
    bounds[0] = (0, n)
    n_nodes = 1
    frontier = [0]  # nodes created last level, to be examined this level

    while frontier:
        next_frontier = []
        for node in frontier:
            left, right = bounds[node]
            seg = index[left:right]
            pts = points[seg]

            lo = pts.min(axis=0)
            hi = pts.max(axis=0)
            # every node (leaves included) carries its subtree bbox: the
            # traversal prunes with the DESCEND TARGET's bbox, which is
            # strictly tighter than the reference's current-node check
            # (pcd_scene.h:104-118 tests node_cur.bbox, whose box includes
            # the already-visited child) while remaining exact
            bbox[node] = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])
            if right - left <= leaf_size:
                continue  # stays a leaf
            dim = int(np.argmax(hi - lo))
            mid = (lo[dim] + hi[dim]) / 2.0

            coord = pts[:, dim]
            less = coord < mid
            eq = coord == mid
            # tie-alternation (pcd_scene.cpp:118-133): the toggle starts True
            # and flips *before* each tie is tested, so ties alternate
            # right, left, right, ... - even-numbered (2nd, 4th, ...) go left.
            tie_rank = np.cumsum(eq)
            go_left = less | (eq & (tie_rank % 2 == 0))

            left_idx = seg[go_left]
            right_idx = seg[~go_left]
            if len(left_idx) == 0 or len(right_idx) == 0:
                # f32-degenerate node: the widest extent is <= 1 ULP, so
                # mid rounded onto the boundary and one side came out
                # empty - an empty child would crash the next level's
                # bbox reduction. Points this node cannot separate at f32
                # resolution stay one (oversized) leaf; traversal scans
                # leaves by bounds, so exactness is unaffected. (The
                # native builder mirrors this guard.)
                continue
            # reference appends right-side elements from the back, reversing
            # their relative order (pcd_scene.cpp:129-130)
            index[left:left + len(left_idx)] = left_idx
            index[left + len(left_idx):right] = right_idx[::-1]

            split_low = coord[go_left].max() if len(left_idx) else -np.inf
            split_high = coord[~go_left].min() if len(right_idx) else np.inf
            sv = (split_low + split_high) / 2.0

            c1, c2 = n_nodes, n_nodes + 1
            child[node] = (c1, c2)
            split_dim[node] = dim
            split_v[node] = sv

            m = left + len(left_idx)
            bounds[c1] = (left, m)
            bounds[c2] = (m, right)
            parent[c1] = node
            parent[c2] = node
            n_nodes += 2
            next_frontier += [c1, c2]
        frontier = next_frontier

    return KDTree(
        points=points[index],
        normals=normals[index],
        parent=parent[:n_nodes].copy(),
        child=child[:n_nodes].copy(),
        split_dim=split_dim[:n_nodes].copy(),
        split_v=split_v[:n_nodes].copy(),
        bbox=bbox[:n_nodes].copy(),
        bounds=bounds[:n_nodes].copy(),
    )
