"""Multi-device scaling: data-parallel pose batches over a device mesh.

The reference's entire concurrency story is one GPU (grid-parallel kernels +
per-thread streams, SURVEY.md section 5). The scaling axis is the
pose-hypothesis batch: shard it over a flat 1-D mesh of devices with
jax.sharding + jit and let XLA place the (trivially parallel) per-pose work;
the model triangles and the scene are replicated, per-pose results come back
sharded (gather them only if the host needs all of them). The per-pose work
needs no collectives, so the mesh follows the batch alone: a 1-D mesh suits
cards joined all to all (NVLink) as well as any other interconnect.

No other parallelism axes exist in this workload - there are no weight
tensors to TP-shard, no pipeline stages, no sequences, no experts
(SURVEY.md section 2, parallelism inventory).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pose_refine import icp


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1D mesh over the pose-batch (data-parallel) axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_to_devices(n_devices: int, init_poses, tris=None):
    """Pad an (N, 4, 4) pose batch (and an optional per-pose (N, T, 3, 3)
    triangle table) to a multiple of n_devices so the batch shards evenly.

    Padding replicates the FIRST row: a guaranteed-renderable pose (identity
    padding would put the mesh at the camera origin), whose results are
    simply dropped by the caller (slice back to N). Returns
    (poses_padded, tris_padded_or_None, n_orig)."""
    poses = jnp.asarray(init_poses, jnp.float32)
    n = poses.shape[0]
    pad = (-n) % n_devices
    if pad:
        poses = jnp.concatenate(
            [poses, jnp.broadcast_to(poses[:1], (pad, 4, 4))], axis=0
        )
        if tris is not None and tris.ndim == 4:
            tris = jnp.concatenate(
                [tris, jnp.broadcast_to(tris[:1], (pad,) + tris.shape[1:])],
                axis=0,
            )
    return poses, tris, n


def unpad_results(n: int, refined, *rest):
    """Drop padded rows appended by pad_to_devices (no-op when unpadded).
    Accepts any number of batched result pytrees (RegistrationResult,
    PoseUncertainty, ...) after the refined poses."""
    if refined.shape[0] == n:
        return (refined,) + rest
    return (refined[:n],) + tuple(
        jax.tree.map(lambda x: x[:n], r) for r in rest
    )


def shard_pose_batch(mesh: Mesh, init_poses, axis: str = "dp"):
    """Place (N, 4, 4) poses sharded over the mesh. N must be a multiple of
    the mesh size - use pad_to_devices first for arbitrary batch sizes (the
    production PoseRefiner path does this automatically)."""
    sharding = NamedSharding(mesh, P(axis, None, None))
    return jax.device_put(jnp.asarray(init_poses, jnp.float32), sharding)


def refine_poses_sharded(
    tris,
    init_poses,
    scene,
    proj,
    K,
    width: int,
    height: int,
    max_points: int = 16384,
    criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
    use_pallas: Optional[bool] = None,
    **pipeline_kwargs,
):
    """Data-parallel refine: the fused render->cloud->ICP program with the
    pose axis sharded over the mesh. Returns (refined poses, results), both
    sharded over the pose axis.

    pipeline_kwargs (lift/window/stride/roi/chunk_iters) pass through to
    refine_poses_jit so the sharded program runs the SAME configuration as
    the single-device path (bench parity across device counts)."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    if use_pallas is None:
        from pose_refine import platform

        use_pallas = platform.raster_kernel()

    tris = jnp.asarray(tris, jnp.float32)
    fn = _sharded_fn(
        "refine",
        mesh,
        axis,
        width,
        height,
        max_points,
        criteria,
        use_pallas,
        jax.tree.structure(scene),
        tuple(sorted(pipeline_kwargs.items())),
        tris_per_pose=tris.ndim == 4,
    )
    poses_p, tris_p, n = pad_to_devices(mesh.size, init_poses, tris)
    poses_sharded = shard_pose_batch(mesh, poses_p, axis)
    out = fn(
        tris_p, poses_sharded, scene, jnp.asarray(proj), jnp.asarray(K, jnp.float32)
    )
    # 2-tuple (refined, results), or 3 with with_information=True
    return unpad_results(n, *out)


@functools.lru_cache(maxsize=32)
def _sharded_fn(
    kind, mesh, axis, width, height, max_points, criteria, use_pallas,
    scene_treedef=None, pipeline_items=(), tris_per_pose=False,
    has_scene_ids=False,
):
    """Build (and cache) the jitted sharded program for the fused refine
    (kind='refine') or the fused per-frame scene-build+refine
    (kind='track' projective / 'track_nn' device-built NN scene). Cached on
    the static configuration so repeated calls reuse one jit wrapper - a
    fresh jax.jit object per call would re-trace every time."""
    from pose_refine.pipeline import (
        refine_poses_jit,
        track_poses_jit,
        track_poses_nn_jit,
    )

    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P(axis))
    pose_sh = NamedSharding(mesh, P(axis, None, None))
    # shared (T, 3, 3) triangles replicate; per-pose (N, T, 3, 3) tables
    # (multi-model batches) shard with their poses
    tris_sharding = (
        NamedSharding(mesh, P(axis, None, None, None)) if tris_per_pose else repl
    )
    if kind == "refine":
        fn = refine_poses_jit
        in_shardings = (
            tris_sharding,                               # tris
            pose_sh,                                     # poses
            jax.tree.unflatten(
                scene_treedef, [repl] * scene_treedef.num_leaves
            ),                                           # scene pytree
            repl,                                        # proj
            repl,                                        # K
        )
        if has_scene_ids:
            # per-pose frame index into a stacked multi-frame scene table:
            # shards with its poses (the table itself replicates)
            in_shardings = in_shardings + (shard,)
    else:  # track: scene built in-program from the replicated frame depth
        fn = track_poses_jit if kind == "track" else track_poses_nn_jit
        in_shardings = (
            tris_sharding,                               # tris
            pose_sh,                                     # poses
            repl,                                        # frame_depth
            repl,                                        # proj
            repl,                                        # K_render
            repl,                                        # K_full
            repl,                                        # max_dist
        )
        if kind == "track_nn":
            in_shardings = in_shardings + (repl,)        # scene Morton perm

    out_shardings = (
        pose_sh,
        icp.RegistrationResult(
            transformation=pose_sh,
            fitness=shard,
            inlier_rmse=shard,
            n_points=shard,
        ),
    )
    if dict(pipeline_items).get("with_information"):
        # the appended PoseUncertainty batch shards with its poses
        out_shardings = out_shardings + (
            icp.PoseUncertainty(
                information=pose_sh, sigma2=shard, count=shard,
                covariance=pose_sh,
            ),
        )
    if dict(pipeline_items).get("pack_outputs"):
        # session loops: the program returns ONE (N, 71) packed buffer
        # (pipeline._pack_track_outputs), row-sharded with its poses
        out_shardings = NamedSharding(mesh, P(axis, None))
    return jax.jit(
        functools.partial(
            fn,
            width=width,
            height=height,
            max_points=max_points,
            criteria=criteria,
            use_pallas=use_pallas,
            **dict(pipeline_items),
        ),
        in_shardings=in_shardings,
        out_shardings=out_shardings,
    )
