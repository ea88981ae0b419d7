"""Visualization helpers (headless).

The reference uses Open3D windows for eyeballing clouds (helper.h:37-123);
this environment has no GUI, so clouds/depths export to files any external
viewer opens (PLY for MeshLab/Open3D, PNG-less PPM for depth images).
"""

from __future__ import annotations

import numpy as np

from pose_refine.mesh import save_ply_ascii


def save_point_cloud(path: str, points, normals=None, valid=None):
    """Write a point cloud (optionally masked) to an ASCII PLY."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if valid is not None:
        pts = pts[np.asarray(valid).reshape(-1)]
    if normals is None:
        save_ply_ascii(path, pts, np.zeros((0, 3), np.int32))
        return
    nrm = np.asarray(normals, np.float32).reshape(-1, 3)
    if valid is not None:
        nrm = nrm[np.asarray(valid).reshape(-1)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("element face 0\nproperty list uchar int vertex_indices\nend_header\n")
        for p, n in zip(pts, nrm):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {n[0]:.4f} {n[1]:.4f} {n[2]:.4f}\n")


def save_depth_ppm(path: str, depth):
    """False-color depth image -> binary PPM (no image libs needed)."""
    from pose_refine.api import PoseRenderer

    rgb = PoseRenderer.view_dep(np.asarray(depth))
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(rgb.tobytes())


def ascii_depth(depth, cols: int = 64) -> str:
    """Terminal-friendly depth silhouette (debugging aid)."""
    d = np.asarray(depth)
    step = max(1, d.shape[1] // cols)
    small = d[:: 2 * step, ::step]
    valid = small[small > 0]
    if valid.size == 0:
        return "(empty)"
    mid = valid.mean()
    chars = np.where(small == 0, ".", np.where(small < mid, "#", "o"))
    return "\n".join("".join(r) for r in chars)
