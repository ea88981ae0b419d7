"""Pose / projection / pixel<->point math for the pose-refinement pipeline.

All functions are pure jax.numpy and jit-friendly; poses are (..., 4, 4) float32
row-major matrices, intrinsics K are (3, 3), depths are int mm, points float m.

Semantics follow the reference library (cited per function) so that depth images
and refined poses are numerically comparable:
  * projection matrix construction: /root/reference/cuda_renderer/renderer.cpp:161-185
  * pixel<->point conversions:      /root/reference/cuda_icp/scene/common.h:47-73
  * Euler conventions (Rz@Ry@Rx):   /root/reference/helper.h:187-209 and
                                    /root/reference/cuda_icp/icp.cpp:7-17
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# All matmuls in this library contract tiny axes (3 or 6); a reduced default
# precision (TF32 on the GPU's tensor cores) costs real accuracy and buys
# nothing (these ops are memory-bound), so pin full f32.
F32 = jax.lax.Precision.HIGHEST

Array = jnp.ndarray

# LINEMOD ("hinter") camera intrinsics used by the reference test suite
# (/root/reference/test.cpp:26).
LINEMOD_K = np.array(
    [[572.4114, 0.0, 325.2611],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]],
    dtype=np.float32,
)


def compute_proj(K, width: int, height: int, near: float = 10.0, far: float = 10000.0):
    """OpenGL-style projection matrix from a pinhole K.

    Mirrors the reference construction (renderer.cpp:161-185) including its
    double-negation "yz flip": row 1 carries -2*fy/h so that +y in camera space
    maps downward in NDC; the rasterizer flips y again at framebuffer write.
    The last row is [0, 0, 1, 0], i.e. w_clip = +z_camera.

    Units are whatever the mesh uses (mm for LINEMOD meshes); near/far defaults
    10/10000 mm as in renderer.h:196.
    """
    K = np.asarray(K, dtype=np.float32)
    fx, s, cx = K[0, 0], K[0, 1], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    w, h = float(width), float(height)
    proj = np.array(
        [
            [2.0 * fx / w, 2.0 * s / w, 2.0 * cx / w - 1.0, 0.0],
            [0.0, -2.0 * fy / h, 1.0 - 2.0 * cy / h, 0.0],
            [0.0, 0.0, (far + near) / (far - near), -2.0 * far * near / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=np.float32,
    )
    return jnp.asarray(proj)


def pose_from_Rt(R, t):
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) pose."""
    R = jnp.asarray(R, dtype=jnp.float32)
    t = jnp.asarray(t, dtype=jnp.float32)
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0, 0, 0, 1], dtype=jnp.float32), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def euler_to_rotation(theta):
    """(..., 3) [x, y, z] angles -> Rz @ Ry @ Rx (helper.h:187-209 convention)."""
    theta = jnp.asarray(theta, dtype=jnp.float32)
    x, y, z = theta[..., 0], theta[..., 1], theta[..., 2]
    cx, sx = jnp.cos(x), jnp.sin(x)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cz, sz = jnp.cos(z), jnp.sin(z)
    # Rz @ Ry @ Rx, written out
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotation_to_euler(R):
    """Inverse of euler_to_rotation (helper.h:165-185), non-singular branch safe."""
    R = jnp.asarray(R)
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = jnp.where(
        singular,
        jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
        jnp.arctan2(R[..., 2, 1], R[..., 2, 2]),
    )
    y = jnp.arctan2(-R[..., 2, 0], sy)
    z = jnp.where(singular, 0.0, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return jnp.stack([x, y, z], axis=-1)


def twist_to_mat4(v6):
    """6-vector ICP update [rx, ry, rz, tx, ty, tz] -> 4x4 transform.

    The reference composes Euler rotations Rz(rz) @ Ry(ry) @ Rx(rx) (via
    AngleAxis products, icp.cpp:7-17) and sets translation to v6[3:6].
    Batched over leading axes.
    """
    v6 = jnp.asarray(v6, dtype=jnp.float32)
    R = euler_to_rotation(v6[..., 0:3])
    return pose_from_Rt(R, v6[..., 3:6])


def transform_points(T, pts):
    """Apply (..., 4, 4) affine transforms to (..., P, 3) points."""
    T = jnp.asarray(T, dtype=jnp.float32)
    pts = jnp.asarray(pts, dtype=jnp.float32)
    return (
        jnp.einsum("...ij,...pj->...pi", T[..., :3, :3], pts, precision=F32)
        + T[..., None, :3, 3]
    )


def _trunc_int(x):
    """C-style int() cast: truncation toward zero."""
    return jnp.trunc(x).astype(jnp.int32)


def dep2pcd(x, y, dep_mm, K, tl_x: int = 0, tl_y: int = 0):
    """Pixel (x, y) + depth in mm -> 3D point in meters (common.h:47-61).

    dep_mm == 0 maps to the zero point. x/y may be arrays; K is (3, 3).
    """
    dep_mm = jnp.asarray(dep_mm)
    z = dep_mm.astype(jnp.float32) / 1000.0
    px = (jnp.asarray(x, jnp.float32) + tl_x - K[0, 2]) / K[0, 0] * z
    py = (jnp.asarray(y, jnp.float32) + tl_y - K[1, 2]) / K[1, 1] * z
    pt = jnp.stack([px, py, z], axis=-1)
    return jnp.where((dep_mm == 0)[..., None], 0.0, pt)


def pcd2dep(pcd, K, tl_x: int = 0, tl_y: int = 0):
    """3D point in meters -> (x, y, dep_mm) int32 with the reference's
    trunc(v + 0.5) rounding (common.h:63-73)."""
    pcd = jnp.asarray(pcd)
    dep = _trunc_int(pcd[..., 2] * 1000.0 + 0.5)
    x = _trunc_int(pcd[..., 0] / pcd[..., 2] * K[0, 0] + K[0, 2] - tl_x + 0.5)
    y = _trunc_int(pcd[..., 1] / pcd[..., 2] * K[1, 1] + K[1, 2] - tl_y + 0.5)
    return jnp.stack([x, y, dep], axis=-1)


def _euler_to_rotation_np(theta):
    """Numpy twin of euler_to_rotation (Rz @ Ry @ Rx, helper.h:187-209).

    sample_hypotheses must stay pure host work: the jnp version would
    dispatch ~20 eager device ops per call from inside serving loops."""
    t = np.asarray(theta, np.float32)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    R = np.empty(t.shape[:-1] + (3, 3), np.float32)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def sample_hypotheses(center_pose, n: int, rot_deg: float = 10.0,
                      trans_mm: float = 20.0, rng=None, include_center=False):
    """Draw n pose hypotheses around a detection: uniform per-axis Euler
    jitter of +-rot_deg degrees left-composed onto the rotation, uniform
    +-trans_mm translation jitter (the reference acceptance recipe,
    test.cpp:29-44, generalized). Pure host-side numpy - zero device
    dispatches, safe inside serving/tracking loops. Returns (n, 4, 4) f32.

    include_center makes hypothesis 0 the unperturbed center pose (useful
    in tracking loops where the prior is already good).
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    center = np.asarray(center_pose, np.float32)
    ang = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) * np.float32(
        np.radians(rot_deg))
    d_rot = _euler_to_rotation_np(ang)
    d_t = rng.uniform(-trans_mm, trans_mm, (n, 3)).astype(np.float32)
    if include_center and n > 0:
        d_rot[0] = np.eye(3, dtype=np.float32)
        d_t[0] = 0.0
    out = np.zeros((n, 4, 4), np.float32)
    out[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, center[:3, :3])
    out[:, :3, 3] = center[:3, 3] + d_t
    out[:, 3, 3] = 1.0
    return out
