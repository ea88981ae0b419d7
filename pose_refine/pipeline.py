"""End-to-end batched pose refinement: render -> cloud -> associate -> solve.

This is the production pipeline the reference assembles by hand in its demo
(test.cpp:143-173: render_cuda_keep_in_gpu -> depth2cloud_cuda ->
init_Scene_*_cuda -> ICP_Point2Plane_cuda), re-designed as ONE jitted XLA
program over the whole pose batch: the depth images, clouds, associations,
normal equations and 6x6 solves for all N hypotheses stay on device for the
entire refinement - zero host round-trips (the reference syncs 29 floats to
the host per ICP iteration per pose, SURVEY.md 3.2).

Where the reference runs concurrent ICPs via per-thread CUDA streams
(README.md:15), here the hypothesis axis is simply a vmapped batch dimension,
and scales further across chips by sharding that axis over a device mesh
(pose_refine.parallel).
"""

from __future__ import annotations

import functools
import logging
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from pose_refine import geometry, icp, platform
from pose_refine.mesh import Model, morton_order
from pose_refine.ops import rasterize as rz
from pose_refine.ops.depth_to_cloud import compact_points, depth_image_to_points
from pose_refine.scene.nn import SceneNN, SceneNNStack
from pose_refine.scene.projective import SceneProjective

logger = logging.getLogger("pose_refine")


def _scene_with_gate(scene, max_dist: float):
    """Scene with a different association gate (same structure; scenes are
    frozen pytree dataclasses)."""
    import dataclasses

    return dataclasses.replace(scene, max_dist_diff=jnp.float32(max_dist))


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_points", "criteria", "use_pallas",
        "lift", "window", "stride", "roi", "chunk_iters", "robust_delta",
        "coarse_iters", "coarse_stride", "estimation",
        "with_information",
    ),
)
def refine_poses_jit(
    tris,
    init_poses,
    scene,
    proj,
    K,
    scene_ids=None,
    *,
    width: int,
    height: int,
    max_points: int,
    criteria: icp.ICPConvergenceCriteria,
    use_pallas: bool = True,
    lift: str = "window",
    window: int = 256,
    stride: int = 2,
    roi=(0, 0, 0, 0),
    chunk_iters: int = 8,
    robust_delta: float = 0.0,
    coarse_iters: int = 0,
    coarse_stride: int = 2,
    estimation: str = "point_to_plane",
    with_information: bool = False,
):
    """The fused program: render N poses, lift to clouds, run batched ICP.

    Returns (refined_poses (N,4,4), RegistrationResult batch), where
    refined = T_icp @ init (the ICP transform acts on camera-space points,
    so it left-composes onto the model->camera pose; its translation is
    rescaled from meters to the pose's millimeters).

    with_information=True appends an icp.PoseUncertainty batch computed at
    the FINAL clouds inside the same program (one extra association pass,
    a small fraction of the ICP cost).

    use_pallas=True renders with the GPU kernel (ops/rasterize_pallas.py),
    False with XLA's scatter rasterizer; PoseRefiner takes the platform's
    choice (pose_refine.platform.raster_kernel).
    """
    if use_pallas:
        from pose_refine.ops.rasterize_pallas import rasterize_pallas

        depth = rasterize_pallas(tris, init_poses, width, height, proj, roi=roi)
    else:
        depth = rz.rasterize_scatter(tris, init_poses, width, height, proj, roi=roi)
    out_h, out_w = depth.shape[1:]

    if lift == "window":
        # scatter-free: per-pose object-centered crop + stride (one batched
        # gather across the pose batch - see window_cloud_batched), then
        # top_k compaction so ICP's per-iteration gathers touch only valid
        # rows
        from pose_refine.ops.depth_to_cloud import compact_topk, window_cloud_batched

        wh = -(-min(window, out_h) // stride)
        ww = -(-min(window, out_w) // stride)
        n_window = wh * ww

        clouds, valids, _n = window_cloud_batched(
            depth, K, window=window, stride=stride, tl_x=roi[0], tl_y=roi[1]
        )
        # NN scenes: emit clouds in MORTON order of the window grid, so
        # neighbouring query rows are spatial neighbours and the NN
        # search's gathers touch nearby scene rows together. Projective
        # association is an image gather: order is irrelevant there, skip
        # the reorder cost. Static decision: the scene TYPE is trace-time.
        nn_order = isinstance(scene, (SceneNN, SceneNNStack))
        if max_points < n_window:
            clouds, valids, _n = jax.vmap(
                lambda p, v: compact_topk(
                    p, v, max_points,
                    order_shape=(wh, ww) if nn_order else None)
            )(clouds, valids)
        elif nn_order:
            # nothing to compact: a pure morton reorder of the full window
            # grid. argsort of the in-program codes (a pure function of
            # iota - XLA folds it at compile time) instead of a baked host
            # permutation table.
            from pose_refine.ops.depth_to_cloud import morton_key

            code = morton_key(jnp.arange(n_window, dtype=jnp.int32), wh, ww)
            perm = jnp.argsort(code)
            clouds = jnp.take(clouds, perm, axis=1)
            valids = jnp.take(valids, perm, axis=1)
    else:
        def one_lift(d):
            # the rendered depth is an ROI crop when roi is set; unproject
            # with the crop origin so pixel (0,0) maps to image (roi_x, roi_y)
            pts, mask = depth_image_to_points(d, K, tl_x=roi[0], tl_y=roi[1])
            return compact_points(pts, mask, max_points)

        clouds, valids, _n = jax.vmap(one_lift)(depth)

    if estimation == "point_to_plane":
        icp_fn = icp.icp_point_to_plane
    elif estimation == "point_to_point":
        # scene normals are ignored by the estimator but still drive the
        # association gate through scene.query - same correspondences,
        # different residual (icp.icp_point_to_point)
        icp_fn = icp.icp_point_to_point
    else:
        raise ValueError(
            f"estimation must be 'point_to_plane' or 'point_to_point', "
            f"got {estimation!r}"
        )

    def one(cloud, valid, sid=None):
        # per-pose scene routing: sid picks the frame in a stacked
        # multi-frame table (scene.query_at adds sid*H*W to the row
        # gather - same gather count as the single-scene query)
        q = scene.query if sid is None else scene.query_at(sid)
        return icp_fn(
            cloud, valid, q, criteria, chunk_iters=chunk_iters,
            robust_delta=robust_delta,
            coarse_iters=coarse_iters, coarse_stride=coarse_stride,
        )

    if scene_ids is None:
        results, _clouds = jax.vmap(one)(clouds, valids)
    else:
        results, _clouds = jax.vmap(one)(
            clouds, valids, jnp.asarray(scene_ids, jnp.int32))
    # ICP acts on camera-space clouds in meters (depth2cloud's mm -> m,
    # common.h:53); poses carry mm translations, so scale t_icp back to mm
    # before left-composing onto the model->camera pose.
    T_mm = results.transformation.at[:, :3, 3].multiply(1000.0)
    refined = jnp.matmul(T_mm, init_poses, precision=jax.lax.Precision.HIGHEST)
    if not with_information:
        return refined, results
    # one extra association pass at the FINAL (already transformed) clouds
    # returned by the ICP loop - the same J rows the last solve used
    def one_info(cloud, valid, sid=None):
        q = scene.query if sid is None else scene.query_at(sid)
        return icp.pose_information(
            cloud, valid, q,
            robust_delta=robust_delta, estimation=estimation,
        )

    if scene_ids is None:
        info, sigma2, count = jax.vmap(one_info)(_clouds, valids)
    else:
        info, sigma2, count = jax.vmap(one_info)(
            _clouds, valids, jnp.asarray(scene_ids, jnp.int32))
    # render-calibrated, not the pure Laplace: rendered-pipeline residuals
    # are quantization-correlated, which the curvature underestimates by
    # ~3x std (NEES 84-384 raw; icp.RENDER_COV_INFLATION rationale +
    # scripts/uncertainty_calibration_study.py). The sigma2 floor covers
    # BOTH quantization sources: depth (integer mm) and the lateral pixel
    # size z/fx at the RENDER intrinsics - render_scale shrinks fx, so
    # coarser renders get an honestly larger floor (measured: without the
    # lateral term, render_scale=2 stays ~8x overconfident in NEES).
    v = valids.astype(jnp.float32)
    mean_z = jnp.sum(jnp.abs(_clouds[..., 2]) * v, axis=-1) / jnp.maximum(
        jnp.sum(v, axis=-1), 1.0)
    lateral = icp.LATERAL_QUANT_COEFF * mean_z / jnp.asarray(K)[0, 0]
    cov = icp.pose_covariance(
        info, sigma2,
        inflation=icp.RENDER_COV_INFLATION,
        sigma2_floor=icp.DEPTH_QUANT_SIGMA_M ** 2 + lateral ** 2,
    )
    return refined, results, icp.PoseUncertainty(info, sigma2, count, cov)


class PendingResult:
    """An in-flight refinement: the arrays are device futures (XLA dispatch
    is asynchronous), so several batches can be enqueued back-to-back and
    the runtime pipelines their execution - the streaming serving pattern
    that hides host-side dispatch behind device work.

    Call :meth:`wait` (or :func:`fence` over many) to synchronize."""

    __slots__ = ("refined", "results", "uncertainty")

    def __init__(self, refined, results, uncertainty=None):
        self.refined = refined
        self.results = results
        self.uncertainty = uncertainty  # PoseUncertainty when requested

    def _tuple(self):
        if self.uncertainty is None:
            return self.refined, self.results
        return self.refined, self.results, self.uncertainty

    def wait(self):
        """Fence this batch; returns (refined_poses, results) plus the
        PoseUncertainty batch when the refinement requested it."""
        return jax.block_until_ready(self._tuple())


def fence(*pending: "PendingResult"):
    """Wait for any number of in-flight batches. Returns a list of
    (refined, results) (plus uncertainty where requested) in argument
    order."""
    return jax.block_until_ready([p._tuple() for p in pending])


class PoseRefiner:
    """Refine batches of pose hypotheses of one model against a scene depth.

    Example:
        refiner = PoseRefiner("obj_06.ply", K=LINEMOD_K)
        refiner.set_scene_depth(observed_depth_mm)     # builds the scene once
        poses, results = refiner.refine(init_poses)    # (N,4,4) -> (N,4,4)
        best = poses[results.fitness.argmax()]

    Streaming (serving) mode - keep several batches in flight:
        pending = [refiner.refine_async(b) for b in batches]
        for refined, results in fence(*pending): ...
    """

    def __init__(
        self,
        model: Union[str, Model],
        K,
        width: int = 640,
        height: int = 480,
        scene: str = "projective",
        max_points: int = 32768,
        max_dist_diff: float = 0.1,
        use_pallas: Optional[bool] = None,
        lift: str = "window",
        window: int = 256,
        stride: int = 2,
        auto_roi: bool = True,
        roi_margin: float = 0.35,
        chunk_iters="auto",
        render_scale: int = 1,
        decimate_mm: float = 0.0,
        scene_voxel_mm: float = 0.0,
        scene_stride: int = 1,
        scene_pool="auto",
        scene_cascade=None,
        robust_delta: float = 0.0,
        coarse_iters: int = 0,
        coarse_stride: int = 2,
        estimation: str = "point_to_plane",
        devices=None,
    ):
        self.model = Model.load(model) if isinstance(model, str) else model
        # decimate_mm: vertex-cluster the HYPOTHESIS render mesh to this cell
        # size (mm) - raster work scales with triangle blocks, and the
        # reference's own loader tells users to simplify >10k-face meshes
        # (renderer.cpp:50-57). The observed scene is sensor data and is
        # untouched; rendered hypothesis points move by <= ~cell/2, far
        # inside the default 0.1 m gate. Measured on obj_06 (31k -> 17k tris
        # at 2 mm): per-case verdicts and ADD identical to the full mesh
        # (scripts/decimation_speed_study.py).
        # self.model keeps the ORIGINAL mesh (metrics like ADD use its
        # vertices); only the render triangles are decimated.
        self.decimate_mm = float(decimate_mm)
        render_model = self.model
        if self.decimate_mm > 0.0:
            from pose_refine.mesh import simplify_vertex_clustering

            render_model = simplify_vertex_clustering(self.model, self.decimate_mm)
            logger.info(
                "render mesh decimated: %d -> %d tris (%.1f mm cells)",
                self.model.tris.shape[0], render_model.tris.shape[0],
                self.decimate_mm,
            )
        self.tris = jnp.asarray(render_model.tris[morton_order(render_model.tris)])
        # scene_voxel_mm: voxel-downsample the NN scene cloud at build time
        # (scene/nn.py:voxel_downsample) - exact-NN cost is O(Q x S), so
        # scene size is the honest NN-throughput lever; no effect on the
        # projective scene (its query is an image-space gather, size-free).
        self.scene_voxel_mm = float(scene_voxel_mm)
        # scene_stride: subsampling of the DEVICE-BUILT NN scene grid used
        # by track() with NN scenes (from_depth_device) - the cheap
        # on-device analog of scene_voxel_mm. No effect on projective
        # scenes or host-built NN scenes.
        self.scene_stride = int(scene_stride)
        # scene_pool: centroid-pooling factor of the device-built NN scene
        # (scene.nn._pool_scene_grid) - the FULL on-device voxel-downsample
        # equivalent incl. the centroid denoising benefit. "auto" (default)
        # derives it once from scene_voxel_mm and the first tracked frame's
        # median object depth, so track() honors the same voxel config as
        # set_scene_depth; an int pins it explicitly.
        # scene_cascade=(coarse_voxel_mm, coarse_iters): NN coarse-to-fine
        # SCENE schedule for refine(). Exact NN cost is O(Q x S), so most
        # early-iteration work on a raw sensor cloud is spent associating
        # against points a voxel filter would merge; the cascade runs
        # coarse_iters against a coarse_voxel_mm-voxelized twin of the
        # scene first, then the caller's criteria against the FULL
        # resolution scene (final associations + fitness/rmse/covariance
        # are all full-res) - the analog of starting on a decimated kd-tree.
        # Quality study: scripts/nn_cascade_study.py.
        if scene_cascade is not None:
            if scene not in ("nn", "nn_kdtree", "nn_bruteforce"):
                raise ValueError(
                    "scene_cascade is an NN-scene feature (exact-NN cost "
                    "scales with scene size; the projective gather is "
                    f"size-free) - scene={scene!r} does not support it"
                )
            cv, ci = scene_cascade
            if float(cv) <= 0.0 or int(ci) < 1:
                raise ValueError(
                    f"scene_cascade wants (coarse_voxel_mm > 0, "
                    f"coarse_iters >= 1), got {scene_cascade!r}")
            if float(scene_voxel_mm) > 0.0 and float(cv) <= float(scene_voxel_mm):
                raise ValueError(
                    f"scene_cascade coarse voxel ({cv} mm) must be coarser "
                    f"than scene_voxel_mm ({scene_voxel_mm} mm) - otherwise "
                    "the coarse pass is the fine pass")
            scene_cascade = (float(cv), int(ci))
        self.scene_cascade = scene_cascade
        self._scene_coarse = None
        if scene_pool != "auto" and int(scene_pool) < 1:
            raise ValueError(f"scene_pool must be >= 1, got {scene_pool}")
        if scene_pool != "auto" and int(scene_pool) > 1 and self.scene_stride > 1:
            # from_depth_device rejects the combination at trace time (the
            # pooled grid and the strided grid disagree on row mapping);
            # fail here, where the other config invariants are checked, not
            # with a confusing error from inside the first track() jit trace
            raise ValueError(
                f"scene_pool ({scene_pool}) and scene_stride "
                f"({self.scene_stride}) are alternative NN-scene "
                "downsamplers - set at most one of them > 1"
            )
        self.scene_pool = scene_pool if scene_pool == "auto" else int(scene_pool)
        self._scene_pool_cache = None  # resolved "auto" value (static/jit)
        self.K = np.asarray(K, np.float32)
        self.width, self.height = int(width), int(height)
        self.proj = geometry.compute_proj(self.K, self.width, self.height)
        # render_scale: render hypotheses at width/s x height/s - the
        # reference's down_sample knob (pose_renderer.cpp:28-29) applied
        # inside the refinement loop. The NDC projection is scale-invariant
        # (compute_proj(K/s, W/s, H/s) == compute_proj(K, W, H), tested), so
        # only the raster size and the lift intrinsics change; the observed
        # scene keeps full sensor resolution. window/stride/roi are in
        # RENDER pixels.
        self.render_scale = int(render_scale)
        self.render_w = self.width // self.render_scale
        self.render_h = self.height // self.render_scale
        self.K_render = self.K.copy()
        self.K_render[:2] /= self.render_scale
        if width % self.render_scale or height % self.render_scale:
            # non-divisible scales (e.g. 3 into 640x480): floor the render
            # dims and build the projection FROM the scaled intrinsics so
            # raster and lift agree exactly; the only approximation is that
            # the right/bottom fringe (width % scale source pixels) falls
            # outside the hypothesis render - no observed-scene data is lost
            # (the scene stays full resolution)
            self.proj = geometry.compute_proj(
                self.K_render, self.render_w, self.render_h
            )
            logger.info(
                "render_scale %d does not divide %dx%d: rendering %dx%d "
                "(right/bottom fringe cropped from hypothesis renders)",
                self.render_scale, width, height, self.render_w, self.render_h,
            )
        # window="auto" / max_points="auto": size the lift geometry from the
        # observed object at set_scene_depth time, reproducing what the
        # hand-tuned bench studies found for obj_06 on ANY object
        # (budget2k_sweep: the right budget keeps every valid point and not
        # more; the right window is the smallest crop the object fits):
        #   window    = extent*1.15 rounded up to 32 (z-perturbed hypotheses
        #               render up to ~10% larger than the scene object)
        #   max_points= 1.3 * the scene object's strided pixel count,
        #               rounded up to 256, capped at the candidate count.
        # Shapes are static per scene: re-tuning recompiles once per object,
        # not per frame (sizes are quantized so small drift changes nothing).
        self._auto_window = window == "auto"
        self._auto_points = max_points == "auto"
        self.max_points = 0 if self._auto_points else int(max_points)
        self.max_dist_diff = float(max_dist_diff)
        if scene not in ("projective", "nn", "nn_kdtree", "nn_bruteforce"):
            # loud at construction: set_scene_depths' NN else-branch would
            # otherwise silently build a bruteforce stack for a typo'd kind
            raise ValueError(
                f"unknown scene kind {scene!r}: expected 'projective', "
                "'nn', 'nn_kdtree' or 'nn_bruteforce'"
            )
        self.scene_kind = scene
        self.scene = None
        if use_pallas is None:
            use_pallas = platform.raster_kernel()
        self.use_pallas = bool(use_pallas)
        if lift not in ("window", "compact"):
            # same rule as the scene-kind check above: a typo'd lift would
            # silently take the compact path (different point budget,
            # window/stride ignored)
            raise ValueError(
                f"unknown lift {lift!r}: expected 'window' or 'compact'")
        self.lift = lift
        self.window = (
            0 if self._auto_window else int(min(window, self.render_w, self.render_h))
        )
        self.stride = int(stride)
        self.auto_roi = bool(auto_roi)
        self._obj_extent_px = 0
        self.roi_margin = float(roi_margin)
        self.roi = (0, 0, 0, 0)
        # robust_delta (m): Huber-IRLS inlier width for the ICP normal
        # equations; 0 = the reference's plain least squares within the gate.
        # Useful against sensor outliers - see scripts/noise_robustness.py.
        self.robust_delta = float(robust_delta)
        # devices: multi-device scaling of the pose batch (pure data
        # parallelism - the only parallel axis this workload has, SURVEY.md
        # section 2).
        #   None  - auto: shard over all attached devices on an accelerator
        #           platform with >1 device; CPU hosts (incl. the
        #           8-virtual-device test mesh) stay single-device unless
        #           devices= is explicit.
        #   1 / False - force single-device.
        #   int n / list of jax devices / jax.sharding.Mesh - explicit mesh.
        # Non-divisible batches are padded (first pose replicated) and the
        # padding is dropped from the results - any batch size works.
        self._devices = devices
        self._mesh_cache = None  # resolved lazily; False = resolved to None
        # coarse_iters/coarse_stride: coarse-to-fine ICP point schedule -
        # the first coarse_iters iterations run on a 1-in-coarse_stride
        # subsample of each cloud (iteration cost is gather-row-bound, so
        # they cost ~1/stride of a full one), then the scored loop finishes
        # on the full cloud; one fused program either way (icp.py).
        # Quality-gated before any production use (scripts/coarse_points_study.py).
        self.coarse_iters = int(coarse_iters)
        self.coarse_stride = int(coarse_stride)
        # estimation: the ICP residual model. 'point_to_plane' = the
        # reference's (icp.h:144-163); 'point_to_point' ignores scene
        # normals (Open3D's other estimator, for unreliable-normal scenes -
        # icp.icp_point_to_point). Association and scoring are identical.
        if estimation not in ("point_to_plane", "point_to_point"):
            raise ValueError(
                f"estimation must be 'point_to_plane' or 'point_to_point', "
                f"got {estimation!r}"
            )
        if estimation == "point_to_point" and scene == "projective":
            # projective association returns the scene point at the same
            # pixel -> ray-aligned residuals; minimizing their 3D length
            # is ill-posed and measured to diverge (icp.icp_point_to_point
            # docstring). Warn loudly rather than refuse: the combination
            # is still selectable for experiments.
            logger.warning(
                "estimation='point_to_point' with scene='projective' is "
                "ill-posed (ray-aligned residuals; diverges on the "
                "standard recovery workload). Use an NN scene "
                "(scene='nn'/'nn_bruteforce'/'nn_kdtree') for "
                "point-to-point, or keep point_to_plane for projective."
            )
        self.estimation = estimation
        # one deferred saturation check per frame (see _warn_if_saturated);
        # _suppress_saturation parks it during async enqueues WITHOUT
        # consuming it (the check fires on the next synchronous call)
        self._check_saturation = False
        self._suppress_saturation = False
        # set once a frame's host planning (ROI/window/extent) has run;
        # device-resident track() frames reuse the standing plan after that
        # instead of paying a full-frame D2H per call (_prepare_frame)
        self._frame_planned = False
        # ICP early-exit granularity; >= max_iteration+1 means one fused
        # program (no host round trip between chunks), small chunks
        # re-check convergence on the host between dispatches. "auto" asks
        # pose_refine.platform.icp_chunk_iters. Explicit ints are honored
        # unchanged.
        self.chunk_iters = chunk_iters if chunk_iters == "auto" else int(chunk_iters)

    def _resolve_scene_pool(self, frame_depth) -> int:
        """scene_pool="auto": derive the centroid-pooling factor that
        matches scene_voxel_mm at this sensor's scale, ONCE from the first
        tracked frame's median object depth (one host numpy pass; the value
        is a STATIC jit arg, so it must not change frame to frame). A 2 mm
        voxel at z=0.3 m / fx=572 maps to pool=4 (pixel pitch z/fx). Capped
        at 8 - beyond that the pooled grid is tiny and the mapping's
        constant-depth assumption has long broken down."""
        if self.scene_pool != "auto":
            return self.scene_pool
        if self._scene_pool_cache is not None:
            return self._scene_pool_cache
        pool = 1
        if self.scene_voxel_mm > 0.0 and self.scene_stride == 1:
            if isinstance(frame_depth, jax.Array):
                # device-resident frame: deriving the median would cost a
                # D2H round trip per session - keep the full-res build and
                # say so ONCE (pass scene_pool=<int> to pin it)
                if not getattr(self, "_scene_pool_warned", False):
                    self._scene_pool_warned = True
                    logger.warning(
                        "track(): scene_voxel_mm=%g set but the frame is "
                        "device-resident - cannot auto-derive the pooling "
                        "factor without a readback; pass scene_pool=<int> "
                        "(e.g. 4 for a 2 mm voxel at 0.3 m) to downsample "
                        "the device-built scene.", self.scene_voxel_mm)
                # do NOT cache: a later HOST frame can still derive the
                # factor (caching 1 here would silently dishonor
                # scene_voxel_mm for the whole session)
                return pool
            else:
                # any host-side input (numpy, list, ...) - not just ndarray
                frame = np.asarray(frame_depth)
                d = frame[frame > 0] if frame.size else frame
                if d.size:
                    z_med = float(np.median(d)) / 1000.0  # depth mm -> m
                    px_pitch = z_med / float(self.K[0, 0])
                    pool = int(round(self.scene_voxel_mm / 1000.0 / px_pitch))
                    pool = max(1, min(pool, 8))
                    logger.info(
                        "track(): scene_voxel_mm=%g mapped to on-device "
                        "centroid pool=%d (median depth %.0f mm)",
                        self.scene_voxel_mm, pool, z_med * 1000.0)
                else:
                    # unrepresentative first frame (occlusion/detector gap):
                    # do NOT cache - derive from the next frame that has
                    # valid depth (one extra compile when pool changes)
                    logger.warning(
                        "track(): frame has no valid depth - scene_pool "
                        "derivation deferred to the next frame with data "
                        "(this frame builds the scene at full resolution)")
                    return pool
        self._scene_pool_cache = pool
        return pool

    def _scene_perm(self, frame_shape, pool: int = 1):
        """Device-resident Morton permutation of the (strided/pooled) scene
        grid, cached per shape - the NN tracking loop passes it every
        frame."""
        fh, fw = frame_shape
        s = self.scene_stride
        key = (-(-fh // s), -(-fw // s))
        if pool > 1:
            key = (-(-key[0] // pool), -(-key[1] // pool))
        cached = getattr(self, "_scene_perm_cache", None)
        if cached is None or cached[0] != key:
            from pose_refine.scene.nn import _grid_morton_perm

            self._scene_perm_cache = (key, jnp.asarray(_grid_morton_perm(*key)))
        return self._scene_perm_cache[1]

    def _device_mesh(self):
        """Resolve devices= (see __init__) to a Mesh, cached. None = run
        single-device."""
        if self._mesh_cache is not None:
            return self._mesh_cache or None
        d = self._devices
        mesh = None
        if d is None:
            if platform.is_accelerator() and len(jax.devices()) > 1:
                from pose_refine.parallel import make_mesh

                mesh = make_mesh()
        elif d is False or (isinstance(d, int) and d <= 1):
            mesh = None
        elif isinstance(d, jax.sharding.Mesh):
            mesh = d
        elif isinstance(d, int):
            from pose_refine.parallel import make_mesh

            mesh = make_mesh(d)
        else:  # sequence of jax devices
            from jax.sharding import Mesh

            mesh = Mesh(np.array(d), ("dp",))
        if mesh is not None and mesh.size <= 1:
            mesh = None
        self._mesh_cache = mesh if mesh is not None else False
        return mesh

    def _pipeline_items(self, criteria):
        """Static pipeline config as the sorted item tuple _sharded_fn
        caches on (matches refine_poses_sharded's key construction)."""
        return (
            ("chunk_iters", self._resolve_chunk_iters(criteria)),
            ("coarse_iters", self.coarse_iters),
            ("coarse_stride", self.coarse_stride),
            ("estimation", self.estimation),
            ("lift", self.lift),
            ("robust_delta", self.robust_delta),
            ("roi", self.roi),
            ("stride", self.stride),
            ("window", self.window),
        )

    def _warn_if_saturated(self, results):
        """No-silent-caps guard on the HYPOTHESIS side: clouds are lifted
        from hypothesis renders, so an initial pose rendering much larger
        than the observed object (e.g. z well under truth) can exceed the
        max_points budget even when the auto sizing fit the scene - the
        compaction then drops boundary points silently. Checked once per
        frame (first refine after _prepare_frame): the readback of the
        per-pose valid counts is a device fence, too dear to pay per call
        in a streaming loop."""
        if (
            self._suppress_saturation
            or not self._check_saturation
            or results.n_points is None
        ):
            return
        self._warn_if_saturated_host(np.asarray(results.n_points))

    def _warn_if_saturated_host(self, n_points_np):
        """Same guard fed HOST-side counts: the packed session buffer
        (_pack_track_outputs) already carries per-pose n_points through its
        one readback, so sessions run the check for free after unpacking
        (in steady pipelined state it inspects the previous frame's counts,
        which is what the once-per-frame guard wants)."""
        if self._suppress_saturation or not self._check_saturation:
            return
        self._check_saturation = False
        peak = int(np.max(n_points_np))
        if self.max_points and peak >= self.max_points:
            logger.warning(
                "lift budget saturated: a hypothesis filled all %d cloud "
                "points - boundary points were likely dropped. Enlarge "
                "max_points (or use max_points='auto' with a margin).",
                self.max_points,
            )

    def _resolve_chunk_iters(self, criteria: icp.ICPConvergenceCriteria) -> int:
        """chunk_iters="auto": the platform's choice
        (pose_refine.platform.icp_chunk_iters)."""
        if self.coarse_iters > 0:
            # the coarse-to-fine point schedule needs the fused loop
            return int(criteria.max_iteration) + 1
        if self.chunk_iters != "auto":
            return self.chunk_iters
        return platform.icp_chunk_iters(criteria.max_iteration)

    def _object_stats(self, scene_depth):
        """ONE host scan of the depth image: (ys, xs, n_valid) of the
        object, shared by ROI planning and auto lift tuning."""
        d = np.asarray(scene_depth)
        ys, xs = np.nonzero(d > 0)
        return ys, xs

    def _compute_roi(self, stats):
        """Crop-while-rendering window around the observed object - the
        reference's ROI mechanism (renderer.h:199-202) made automatic.
        Returned in RENDER pixels, the width rounded up to 128 and the height
        to 8 (few distinct crop shapes -> few compiled programs)."""
        ys, xs = stats
        if len(xs) == 0:
            self._obj_extent_px = 0
            return (0, 0, 0, 0)
        s = self.render_scale
        self._obj_extent_px = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        rw, rh = self.render_w, self.render_h
        mx = int(self.roi_margin * self._obj_extent_px) + 16
        x0 = max(int(xs.min()) // s - mx, 0)
        y0 = max(int(ys.min()) // s - mx, 0)
        x1 = min(int(xs.max()) // s + mx, rw)
        y1 = min(int(ys.max()) // s + mx, rh)
        w = min(-(-(x1 - x0) // 128) * 128, rw)
        h = min(-(-(y1 - y0) // 8) * 8, rh)
        x0 = min(x0, rw - w)
        y0 = min(y0, rh - h)
        return (x0, y0, w, h)

    def _lift_targets(self, stats, window=None):
        """(window, max_points) the auto formulas pick for this frame (see
        __init__); non-auto knobs keep their configured values. ``window``
        overrides the window used for the max_points candidate bound (the
        hysteresis path budgets against the APPLIED window, not the raw
        target)."""
        ys, xs = stats
        s = self.render_scale
        if len(xs) == 0:
            return (
                self.window or min(256, self.render_w, self.render_h),
                self.max_points or 4096,
            )
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        if window is None:
            window = self.window
            if self._auto_window:
                w = -(-int(extent * 1.15) // 32) * 32
                window = int(np.clip(w, 32, min(self.render_w, self.render_h)))
        max_points = self.max_points
        if self._auto_points:
            if self.lift == "window":
                # the window lift strides; budget = strided object pixels
                n_obj = len(xs) // (s * s * self.stride * self.stride)
                cand = (-(-window // self.stride)) ** 2
                mp = min(-(-int(n_obj * 1.3) // 256) * 256, cand)
            else:
                # the compact lift keeps EVERY valid pixel (no window, no
                # stride) - budget must cover the full object
                n_obj = len(xs) // (s * s)
                mp = -(-int(n_obj * 1.3) // 256) * 256
            max_points = int(max(mp, 256))
        return window, max_points

    def _tune_lift(self, stats):
        """Apply the auto lift sizes with PER-KNOB hysteresis: window and
        max_points are static jit arguments, so changing them recompiles
        the fused program - an object extent oscillating across a 32-px
        (or 256-point) quantization boundary must not recompile alternating
        tracking frames (same rationale as _roi_still_fits). Each knob
        grows immediately (an undersized window/budget drops boundary
        points) but shrinks only past one quantum, INDEPENDENTLY - one
        knob's growth must not drag the other through a sub-quantum shrink
        (anti-phase oscillation would recompile every frame)."""
        w_t, _ = self._lift_targets(stats)
        if not self.window or w_t > self.window or w_t < self.window - 32:
            new_w = w_t
        else:
            new_w = self.window
        # budget against the window actually applied
        _, mp_t = self._lift_targets(stats, window=new_w)
        if not self.max_points or mp_t > self.max_points or mp_t < self.max_points - 256:
            new_mp = mp_t
        else:
            new_mp = self.max_points
        if (new_w, new_mp) == (self.window, self.max_points):
            return
        self.window, self.max_points = new_w, new_mp
        logger.info(
            "auto lift: window=%d, max_points=%d", self.window, self.max_points
        )

    def _roi_still_fits(self, stats) -> bool:
        """ROI hysteresis: the roi is a STATIC argument of the fused program
        (it fixes the framebuffer shape), so changing it every frame as the
        object drifts forces a recompile per frame - the difference between
        ~0.1 and ~5 fps in a tracking loop. Keep the previous crop while the
        object still sits a guard margin inside it; _compute_roi's own
        margin (roi_margin*extent) gives it room to drift."""
        if self.roi == (0, 0, 0, 0):
            return False
        ys, xs = stats
        if len(xs) == 0:
            return True
        s = self.render_scale
        x0, y0, w, h = self.roi
        # hypothesis renders extend past the OBSERVED silhouette (z-perturbed
        # starts render up to ~10-15% larger - same rationale as the
        # window=extent*1.15 sizing), so the keep-guard must scale with the
        # margin the ROI was computed with, not a fixed pixel count
        extent = int(max(xs.max() - xs.min(), ys.max() - ys.min())) // s
        guard = max(12, (int(self.roi_margin * extent) + 16) // 2)
        return (
            int(xs.min()) // s - guard >= x0
            and int(ys.min()) // s - guard >= y0
            and int(xs.max()) // s + guard <= x0 + w
            and int(ys.max()) // s + guard <= y0 + h
        )

    def _nn_backend(self) -> str:
        """scene="nn" takes the platform's exact NN backend
        (pose_refine.platform.nn_backend); "nn_kdtree" / "nn_bruteforce"
        force one."""
        if self.scene_kind == "nn_bruteforce":
            return "bruteforce"
        if self.scene_kind == "nn_kdtree":
            return "kdtree"
        return platform.nn_backend()

    def _prepare_frame(self, scene_depth, allow_device_skip: bool = False):
        """Per-frame host-side planning shared by set_scene_depth and
        track(): unit sanity, auto lift sizing, ROI hysteresis/re-crop, and
        the no-silent-caps window warning.

        Host (numpy) frames always plan - the scans below are host-local
        and free of device fences. DEVICE-resident frames on the tracking
        path (allow_device_skip=True) would pay a full-frame D2H *and*
        fence their producer per call - serializing exactly the
        double-buffered loop track_async promises not to block - so after
        the first planned frame they reuse the standing plan (ROI/window/
        extent hysteresis at its strongest); the first device frame pays
        one planning readback, or pass a host frame / call set_scene_depth
        first to avoid even that."""
        if (
            allow_device_skip
            and self._frame_planned
            and isinstance(scene_depth, jax.Array)
            and platform.is_accelerator()
        ):
            self._check_saturation = True
            return
        d_max = float(np.max(np.asarray(scene_depth)))
        if 0.0 < d_max <= 50.0:
            # a depth image whose farthest point is 5 cm is almost certainly
            # in METERS; everything here is mm (depth int mm, points m -
            # common.h:47-73 conventions)
            logger.warning(
                "scene depth max is %.2f - values look like meters; this "
                "pipeline expects millimeters (uint16/int32 mm)", d_max,
            )
        self._check_saturation = True
        stats = self._object_stats(scene_depth)
        ys, xs = stats
        if len(xs):  # extent drives the crop warning, with or without auto_roi
            self._obj_extent_px = int(
                max(xs.max() - xs.min(), ys.max() - ys.min())
            ) // self.render_scale
        if self._auto_window or self._auto_points:
            self._tune_lift(stats)
        if self.auto_roi and not self._roi_still_fits(stats):
            self.roi = self._compute_roi(stats)
            logger.info("auto ROI (x, y, w, h) = %s (render px)", self.roi)
        # no silent caps: the window lift crops a window x window pixel
        # region around the rendered object (stride subsamples INSIDE it -
        # it does not extend coverage); a larger object loses boundary
        # points without this check (applies with or without auto_roi)
        if self.lift == "window" and self._obj_extent_px > self.window:
            logger.warning(
                "object extent ~%d render px exceeds the window lift "
                "crop of %d px: boundary points will be cropped. "
                "Enlarge window= or use lift='compact'.",
                self._obj_extent_px, self.window,
            )
        self._frame_planned = True

    def set_scene_depth(self, scene_depth):
        """Build the association structure from an (H, W) mm depth image.
        Happens once per frame (SURVEY.md 3.3), not per ICP iteration."""
        self._prepare_frame(scene_depth)
        if self.scene_kind == "projective":
            self.scene = SceneProjective.from_depth(
                scene_depth, self.K, self.max_dist_diff
            )
        elif self.scene_kind in ("nn", "nn_kdtree", "nn_bruteforce"):
            self.scene = SceneNN.from_depth(
                scene_depth, self.K, self.max_dist_diff,
                backend=self._nn_backend(), voxel_mm=self.scene_voxel_mm,
            )
            if self.scene_cascade is not None:
                self._scene_coarse = SceneNN.from_depth(
                    scene_depth, self.K, self.max_dist_diff,
                    backend=self._nn_backend(),
                    voxel_mm=self.scene_cascade[0],
                )
        else:
            raise ValueError(f"unknown scene kind {self.scene_kind!r}")
        logger.info(
            "scene built: kind=%s, %s", self.scene_kind, type(self.scene).__name__
        )
        return self

    def set_scene_depths(self, scene_depths):
        """Build ONE stacked scene from (K, H, W) mm depth frames so a
        single refine() dispatch can route each hypothesis to its own frame
        via ``scene_ids`` (heterogeneous-scene serving: the reference needs
        a CUDA stream per scene frame, README.md:15 / cuda_icp/icp.cu:170;
        here the frames share one flat table and each pose's row gather is
        offset by its frame index - no padding, no extra gather cost).

        NN scenes stack too (brute-force backend; each pose scans only its
        frame's region, so per-pose cost is one frame's scan - scene/nn.py
        SceneNNStack). 'nn_kdtree' cannot: the kd traversal binds per-scene
        tree arrays. Frame planning (auto
        ROI/window/points) uses the UNION of the frames' objects via a
        max-projection, so every frame's object stays inside the crop."""
        if self.scene_kind == "nn_kdtree":
            raise ValueError(
                "set_scene_depths (stacked multi-frame scenes) cannot use "
                "scene='nn_kdtree' (per-scene tree arrays); use "
                "'nn'/'nn_bruteforce' or 'projective'"
            )
        if self.scene_cascade is not None and self.scene_kind != "projective":
            raise ValueError(
                "scene_cascade is per-frame (a coarse voxel twin); it does "
                "not compose with stacked NN scenes - drop one of the two"
            )
        frames = np.asarray(scene_depths)
        if frames.ndim != 3 or frames.shape[0] < 1:
            raise ValueError(
                f"set_scene_depths wants (K, H, W) frames, got {frames.shape}"
            )
        # union planning frame: max over frames keeps every object pixel
        self._prepare_frame(frames.max(axis=0))
        if self.scene_kind == "projective":
            from pose_refine.scene.projective import SceneProjectiveStack

            self.scene = SceneProjectiveStack.from_depths(
                frames, self.K, self.max_dist_diff
            )
        else:
            self.scene = SceneNNStack.from_depths(
                frames, self.K, self.max_dist_diff,
                voxel_mm=self.scene_voxel_mm,
            )
        logger.info(
            "scene built: kind=%s x%d frames (stacked)",
            self.scene_kind, self.scene.n_scenes,
        )
        return self

    def set_scene_cloud(self, points, normals):
        """NN scene directly from a point cloud. Backend selection matches
        set_scene_depth (see _nn_backend)."""
        if self._auto_window or self._auto_points:
            # auto lift sizes come from an observed DEPTH image; a bare
            # cloud gives no object extent to tune from - failing loudly
            # beats refining with a zero-sized lift
            raise ValueError(
                "window='auto'/max_points='auto' require set_scene_depth; "
                "pass explicit window/max_points to use set_scene_cloud"
            )
        if self.scene_voxel_mm > 0.0:
            from pose_refine.scene.nn import voxel_downsample

            points, normals = voxel_downsample(
                points, normals, self.scene_voxel_mm / 1000.0
            )
        self.scene = SceneNN.from_cloud(
            points, normals, self.max_dist_diff, backend=self._nn_backend()
        )
        if self.scene_cascade is not None:
            from pose_refine.scene.nn import voxel_downsample

            cp, cn = voxel_downsample(
                points, normals, self.scene_cascade[0] / 1000.0
            )
            self._scene_coarse = SceneNN.from_cloud(
                cp, cn, self.max_dist_diff, backend=self._nn_backend()
            )
        self._check_saturation = True
        return self

    def refine(
        self,
        init_poses,
        criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
        schedule=None,
        with_covariance: bool = False,
        scene_ids=None,
        _scene=None,
        _tris=None,
    ):
        """(N, 4, 4) hypotheses -> (refined (N, 4, 4), RegistrationResult).

        scene_ids: required after :meth:`set_scene_depths` - (N,) int frame
        index per hypothesis, routing each pose to its own scene frame
        inside ONE fused program (the reference needs a CUDA stream per
        scene for this, README.md:15). Host-side ids are range-checked;
        DEVICE-RESIDENT ids are validated by shape only (a min/max readback
        would fence refine_async's dispatch chain), and an out-of-range
        device id clamps to the nearest valid frame row - i.e. it silently
        associates against frame 0 / frame n_scenes-1 rather than failing.
        Keep device ids in [0, n_scenes) at the producer.

        schedule: optional coarse-to-fine association schedule - a list of
        (max_dist_diff_m, max_iteration) levels, e.g. [(0.25, 10), (0.05, 20)].
        Each level re-renders at the current estimates and runs ICP with that
        inlier gate; a loose first gate widens the convergence basin, a tight
        last gate sharpens the result. (Beyond-parity feature; the reference
        has one fixed 0.1 m gate, depth_scene.h:9.)

        with_covariance=True appends an icp.PoseUncertainty batch (Laplace
        covariance per pose, twist order [omega, t] in [rad, m]) computed
        INSIDE the fused program - the input PoseTracker.update expects,
        at a small fraction of an extra ICP's cost. With schedule=, only the
        last level computes it (the uncertainty of the final fit).

        With ``scene_cascade=(coarse_voxel_mm, coarse_iters)`` (NN scenes),
        a coarse pre-pass against a voxelized twin of the scene runs
        first; ``criteria`` then governs the full-resolution pass, so pass
        e.g. ``max_iteration=8`` to harvest the cascade's speedup."""
        scene = _scene if _scene is not None else self.scene
        if scene is None:  # usage error: must survive python -O
            raise RuntimeError("set_scene_depth / set_scene_cloud first")
        # shape-only validation: np.shape reads the .shape attribute, so a
        # device-resident batch is NOT pulled to host (np.asarray here would
        # block on the producing program + pay a D2H copy - breaking
        # refine_async's nothing-blocks contract for chained batches)
        init_shape = np.shape(init_poses)
        if init_shape[-2:] != (4, 4):
            raise ValueError(
                f"init_poses must be (..., 4, 4) model->camera transforms, got {init_shape}"
            )
        if len(init_shape) not in (2, 3):
            raise ValueError(f"init_poses must be (4, 4) or (N, 4, 4), got {init_shape}")
        from pose_refine.scene.projective import SceneProjectiveStack

        if isinstance(scene, (SceneProjectiveStack, SceneNNStack)):
            if scene_ids is None:
                raise ValueError(
                    "the scene is a stacked multi-frame table "
                    "(set_scene_depths): refine() needs scene_ids - one "
                    "frame index per hypothesis"
                )
            n_poses = 1 if len(init_shape) == 2 else init_shape[0]
            if isinstance(scene_ids, jax.Array):
                # device-resident ids (incl. the schedule recursion's own
                # broadcast array): shape checks are metadata-only; skip
                # the min/max readback - np.asarray here would fence the
                # producing program and break refine_async's
                # nothing-blocks contract
                ids_shape = scene_ids.shape
            else:
                scene_ids = np.asarray(scene_ids, np.int32)
                ids_shape = scene_ids.shape
                if scene_ids.size and (
                    scene_ids.min() < 0 or scene_ids.max() >= scene.n_scenes
                ):
                    raise ValueError(
                        f"scene_ids must be in [0, {scene.n_scenes}), got "
                        f"[{scene_ids.min()}, {scene_ids.max()}]"
                    )
            if ids_shape not in ((), (n_poses,)):
                raise ValueError(
                    f"scene_ids shape {ids_shape} does not match the "
                    f"{n_poses}-pose batch"
                )
            scene_ids = jnp.broadcast_to(
                jnp.asarray(scene_ids, jnp.int32), (n_poses,)
            )
        elif scene_ids is not None:
            raise ValueError(
                "scene_ids is only valid with a stacked multi-frame scene "
                "(set_scene_depths); this refiner holds a single scene"
            )
        if self._scene_coarse is not None and _scene is None:
            # scene_cascade pre-pass: coarse_iters against the voxelized
            # twin, then fall through to the normal path (schedule
            # included) against the full-resolution scene at the caller's
            # criteria. Recursions (schedule levels, this pre-pass itself)
            # carry _scene and therefore skip this block. No covariance
            # here - the uncertainty of the final full-res fit is what
            # callers want (same rule as schedule's last level).
            out = PoseRefiner.refine(
                self,
                init_poses,
                criteria=icp.ICPConvergenceCriteria(
                    criteria.relative_fitness,
                    criteria.relative_rmse,
                    self.scene_cascade[1],
                ),
                scene_ids=scene_ids,
                _scene=self._scene_coarse,
                _tris=_tris,
            )
            init_poses = out[0]
        if schedule:
            if self.coarse_iters:
                bad = [int(i) for _, i in schedule if int(i) <= self.coarse_iters]
                if bad:
                    raise ValueError(
                        f"coarse_iters={self.coarse_iters} needs every schedule "
                        f"level to run more iterations than it (each level must "
                        f"finish with at least one full-cloud iteration), but "
                        f"schedule has level(s) with max_iteration={bad}. Raise "
                        f"those levels' iteration counts or drop one of the two "
                        f"coarse-to-fine mechanisms (schedule= gates association "
                        f"distance across re-renders; coarse_iters subsamples "
                        f"the cloud inside each ICP run)."
                    )
            poses = init_poses
            for level, (max_dist, iters) in enumerate(schedule):
                # explicit base-class call: subclass overrides (e.g.
                # MultiModelRefiner's (model_ids, poses) signature) must not
                # capture the recursion - _tris already carries their state
                out = PoseRefiner.refine(
                    self,
                    poses,
                    criteria=icp.ICPConvergenceCriteria(
                        criteria.relative_fitness,
                        criteria.relative_rmse,
                        int(iters),
                    ),
                    with_covariance=(
                        with_covariance and level == len(schedule) - 1
                    ),
                    scene_ids=scene_ids,
                    _scene=_scene_with_gate(scene, max_dist),
                    _tris=_tris,
                )
                poses, results = out[0], out[1]
            return out
        init_poses = jnp.asarray(init_poses, jnp.float32)
        squeeze = init_poses.ndim == 2
        if squeeze:
            init_poses = init_poses[None]
        tris = jnp.asarray(self.tris if _tris is None else _tris)
        items = self._pipeline_items(criteria)
        if with_covariance:
            items = items + (("with_information", True),)
        mesh = self._device_mesh()
        if mesh is not None:
            # multi-chip: the identical fused program with the pose batch
            # (and any per-pose triangle table) sharded over the mesh;
            # non-divisible batches are padded then sliced back
            from pose_refine.parallel import sharding as _sh

            fn = _sh._sharded_fn(
                "refine", mesh, "dp", self.render_w, self.render_h,
                self.max_points, criteria, self.use_pallas,
                jax.tree.structure(scene), items,
                tris_per_pose=tris.ndim == 4,
                has_scene_ids=scene_ids is not None,
            )
            poses_p, tris_p, n = _sh.pad_to_devices(mesh.size, init_poses, tris)
            args = (
                tris_p, _sh.shard_pose_batch(mesh, poses_p), scene,
                jnp.asarray(self.proj), jnp.asarray(self.K_render),
            )
            if scene_ids is not None:
                # scene_ids pad/shard exactly like their poses (first-row
                # replication - pad lanes re-refine a real (pose, frame))
                pad = poses_p.shape[0] - scene_ids.shape[0]
                if pad:
                    scene_ids = jnp.concatenate(
                        [scene_ids,
                         jnp.broadcast_to(scene_ids[:1], (pad,))])
                args = args + (scene_ids,)
            out = fn(*args)
            out = _sh.unpad_results(n, *out)
        else:
            out = refine_poses_jit(
                tris,
                init_poses,
                scene,
                self.proj,
                jnp.asarray(self.K_render),
                scene_ids,
                width=self.render_w,
                height=self.render_h,
                max_points=self.max_points,
                criteria=criteria,
                use_pallas=self.use_pallas,
                # single source of truth with the sharded path (the cached
                # _sharded_fn partials over the same item tuple)
                **dict(items),
            )
        self._warn_if_saturated(out[1])
        if squeeze:
            out = tuple(jax.tree.map(lambda x: x[0], o) for o in out)
        return out if with_covariance else (out[0], out[1])

    def refine_async(
        self,
        init_poses,
        criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
        **kwargs,
    ) -> PendingResult:
        """refine() without any host synchronization: returns a
        :class:`PendingResult` immediately so the caller can enqueue more
        batches while this one executes (the reference's multi-stream
        serving intent, README.md:15, expressed as XLA async dispatch).
        The once-per-frame lift-saturation readback is deferred to the next
        synchronous refine() - nothing on this path blocks."""
        self._suppress_saturation = True
        try:
            out = self.refine(init_poses, criteria, **kwargs)
        finally:
            self._suppress_saturation = False
        return PendingResult(*out)

    def track(
        self,
        frame_depth,
        init_poses,
        criteria: icp.ICPConvergenceCriteria = icp.ICPConvergenceCriteria(),
        with_covariance: bool = False,
        _tris=None,
        _pack_outputs: bool = False,
    ):
        """One tracking step: rebuild the scene from this frame's depth AND
        refine, fused into a single program. Use in per-frame loops where
        set_scene_depth + refine would pay two dispatches. Projective
        scenes fuse via track_poses_jit; NN scenes ('nn'/'nn_bruteforce')
        via track_poses_nn_jit with a fully on-device brute-force scene build
        (scene_stride subsamples the scene grid - set it where you would
        set scene_voxel_mm, e.g. stride 2 ~ the pixel pitch at that depth).
        'nn_kdtree' cannot fuse (kd builds are inherently host work) - use
        set_scene_depth + refine there. Does not touch self.scene.

        Returns (refined (N, 4, 4), RegistrationResult);
        with_covariance=True appends an icp.PoseUncertainty batch computed
        in the same program (see refine) - one fused dispatch per tracked
        frame covers scene build + refine + measurement covariance, the
        full PoseTracker.update input."""
        if self.scene_kind == "nn_kdtree":
            raise ValueError(
                "track() cannot fuse a kd-tree scene build (host work); "
                "use scene='nn' / 'nn_bruteforce' or "
                "set_scene_depth + refine"
            )
        if self.scene_cascade is not None:
            # loud, not silently inert: the fused in-program scene build has
            # no coarse voxel twin, so a cascade configured here would just
            # not run (the user would believe the cascade is active). Coarse-from-the-frame inside track() = scene_stride /
            # scene_pool, which the fused build DOES support.
            raise ValueError(
                "scene_cascade applies to set_scene_depth/set_scene_cloud + "
                "refine (it builds a coarse voxelized twin of a FIXED "
                "scene); track() builds its scene in-program per frame - "
                "use scene_stride or scene_pool for coarse tracking scenes"
            )
        init_shape = np.shape(init_poses)  # no host materialization (see refine)
        if init_shape[-2:] != (4, 4) or len(init_shape) not in (2, 3):
            raise ValueError(
                f"init_poses must be (4, 4) or (N, 4, 4) model->camera "
                f"transforms, got {init_shape}"
            )
        self._prepare_frame(frame_depth, allow_device_skip=True)
        init_poses = jnp.asarray(init_poses, jnp.float32)
        squeeze = init_poses.ndim == 2
        if squeeze:
            init_poses = init_poses[None]
        if _pack_outputs and (not with_covariance or squeeze):
            # the packed (N, 71) session buffer embeds the covariance and
            # is batch-shaped by construction
            raise ValueError(
                "_pack_outputs needs with_covariance=True and a batched "
                "(N, 4, 4) init_poses"
            )
        tris = jnp.asarray(self.tris if _tris is None else _tris)
        projective = self.scene_kind == "projective"
        items = self._pipeline_items(criteria)
        if with_covariance:
            items = items + (("with_information", True),)
        if _pack_outputs:
            items = items + (("pack_outputs", True),)
        if not projective:
            pool = self._resolve_scene_pool(frame_depth)
            items = items + (("scene_stride", self.scene_stride),
                             ("scene_pool", pool))
            # the scene grid's Morton permutation rides along as an
            # ARGUMENT (up to ~1.2 MB at stride 1 - too large to bake into
            # the program), and the DEVICE-RESIDENT array is cached per grid
            # shape so repeated frames do not re-upload it
            perm = self._scene_perm(frame_depth.shape, pool)
        mesh = self._device_mesh()
        if mesh is not None:
            # multi-chip tracking: frame depth replicates (the in-program
            # scene build is per-chip redundant but tiny), poses shard
            from pose_refine.parallel import sharding as _sh

            fn = _sh._sharded_fn(
                "track" if projective else "track_nn", mesh, "dp",
                self.render_w, self.render_h,
                self.max_points, criteria, self.use_pallas, None,
                items, tris_per_pose=tris.ndim == 4,
            )
            poses_p, tris_p, n = _sh.pad_to_devices(mesh.size, init_poses, tris)
            args = (
                tris_p, _sh.shard_pose_batch(mesh, poses_p),
                jnp.asarray(frame_depth), jnp.asarray(self.proj),
                jnp.asarray(self.K_render), jnp.asarray(self.K),
                jnp.float32(self.max_dist_diff),
            )
            if not projective:
                args = args + (perm,)
            out = fn(*args)
            out = (
                _sh.unpad_results(n, out)[0]
                if _pack_outputs
                else _sh.unpad_results(n, *out)
            )
        else:
            fn = track_poses_jit if projective else track_poses_nn_jit
            args = (
                tris,
                init_poses,
                jnp.asarray(frame_depth),
                self.proj,
                jnp.asarray(self.K_render),
                jnp.asarray(self.K),
                jnp.float32(self.max_dist_diff),
            )
            if not projective:
                args = args + (perm,)
            out = fn(
                *args,
                self.render_w,
                self.render_h,
                self.max_points,
                criteria,
                self.use_pallas,
                **dict(items),
            )
        if _pack_outputs:
            # one (N, 71) device array; the session performs the saturation
            # check host-side from the buffer's own n_points column
            # (_warn_if_saturated_host) - no extra readback here
            return out
        self._warn_if_saturated(out[1])
        if squeeze:
            out = tuple(jax.tree.map(lambda x: x[0], o) for o in out)
        return out if with_covariance else (out[0], out[1])

    def track_async(self, *args, **kwargs) -> PendingResult:
        """track() without host synchronization: returns a
        :class:`PendingResult` immediately (the per-frame saturation
        readback is skipped, like refine_async) so a tracking loop can
        enqueue frame k+1's fused program before fencing frame k -
        TrackingSession.step_async builds the double-buffered loop on
        this. Same arguments as :meth:`track` (works through
        MultiModelRefiner's model_ids signature too). The suppress flag
        (not a save/restore of _check_saturation) is essential here:
        track() -> _prepare_frame re-arms the check per frame, and a
        save/restore would let _warn_if_saturated's np.max readback run
        INSIDE the async call - a full device fence per enqueued frame
        that serializes the double-buffered loop."""
        self._suppress_saturation = True
        try:
            out = self.track(*args, **kwargs)
        finally:
            self._suppress_saturation = False
        return PendingResult(*out)

    def track_packed_async(self, *args, **kwargs):
        """track_async for session loops: the fused program ALSO packs
        (refined, results, uncertainty) into the (N, 71) session buffer
        (see _pack_track_outputs), so a pipelined tracking frame enqueues
        ONE program instead of two. Returns the packed device array;
        unpack host-side with tracking._unpack_outputs(buf, has_np=True).
        Implies with_covariance=True. No suppress-flag dance here (unlike
        track_async): the _pack_outputs path returns the packed buffer
        BEFORE track() reaches _warn_if_saturated - the session performs
        the check host-side from the buffer's n_points column."""
        return self.track(
            *args, with_covariance=True, _pack_outputs=True, **kwargs
        )

    @staticmethod
    def rank(results: icp.RegistrationResult):
        """Hypothesis re-ranking: best-first indices by (fitness, -rmse).

        The reference exposes fitness/inlier-rmse exactly for this purpose
        (icp.h:26-36); here they fall out of the batched reduce for free."""
        fit = np.asarray(results.fitness)
        rmse = np.asarray(results.inlier_rmse)
        order = np.lexsort((rmse, -fit))
        return order


def _pack_track_outputs(refined, results, unc):
    """(N, 71) session buffer, traced INTO the fused track program:
    [refined 16 | transformation 16 | fitness | rmse | n_points | cov 36].
    Tracking sessions consume exactly this per frame; packing it inside
    track_poses_*_jit (pack_outputs=True) makes a pipelined tracking frame
    cost ONE enqueued program instead of two (track + the separate packing
    program). Host-side inverse: tracking._unpack_outputs(buf, has_np=True)."""
    if unc is None or results.n_points is None:
        raise ValueError(
            "pack_outputs needs with_information=True and a lift that "
            "reports per-pose point counts"
        )
    n = refined.shape[0]
    return jnp.concatenate([
        refined.reshape(n, 16),
        results.transformation.reshape(n, 16),
        results.fitness[:, None],
        results.inlier_rmse[:, None],
        results.n_points[:, None].astype(jnp.float32),
        unc.covariance.reshape(n, 36),
    ], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_points", "criteria", "use_pallas",
        "lift", "window", "stride", "roi", "chunk_iters", "robust_delta",
        "coarse_iters", "coarse_stride", "estimation",
        "with_information", "pack_outputs",
    ),
)
def track_poses_jit(
    tris, init_poses, frame_depth, proj, K_render, K_full, max_dist,
    width, height, max_points, criteria, use_pallas,
    lift="window", window=256, stride=2, roi=(0, 0, 0, 0), chunk_iters=8,
    robust_delta=0.0, coarse_iters=0, coarse_stride=2,
    estimation="point_to_plane", with_information=False,
    pack_outputs=False,
):
    """Per-frame scene build FUSED with refinement: one program per frame.

    The projective scene build is pure jnp (dep2pcd + the normal stencil),
    so it traces into the same program as render->lift->ICP - a tracking
    loop pays ONE dispatch for compute instead of two (the reference
    rebuilds its scene every frame as a separate host step, SURVEY 3.3).
    pack_outputs=True (sessions) additionally folds the (N, 71) output
    packing into the same program - see _pack_track_outputs."""
    scene = SceneProjective.from_depth(frame_depth, K_full, max_dist)
    out = refine_poses_jit(
        tris, init_poses, scene, proj, K_render,
        width=width, height=height, max_points=max_points, criteria=criteria,
        use_pallas=use_pallas, lift=lift, window=window, stride=stride,
        roi=roi, chunk_iters=chunk_iters, robust_delta=robust_delta,
        coarse_iters=coarse_iters, coarse_stride=coarse_stride,
        estimation=estimation, with_information=with_information,
    )
    return _pack_track_outputs(*out) if pack_outputs else out


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_points", "criteria", "use_pallas",
        "lift", "window", "stride", "roi", "chunk_iters", "robust_delta",
        "scene_stride", "scene_pool", "coarse_iters",
        "coarse_stride", "estimation", "with_information", "pack_outputs",
    ),
)
def track_poses_nn_jit(
    tris, init_poses, frame_depth, proj, K_render, K_full, max_dist, perm,
    width, height, max_points, criteria, use_pallas,
    lift="window", window=256, stride=2, roi=(0, 0, 0, 0), chunk_iters=8,
    robust_delta=0.0, scene_stride=1, scene_pool=1,
    coarse_iters=0, coarse_stride=2, estimation="point_to_plane",
    with_information=False, pack_outputs=False,
):
    """Per-frame NN-scene build FUSED with refinement - the NN twin of
    track_poses_jit. The reference rebuilds Scene_nn on the HOST every
    frame (normals + compaction + kd build + upload, pcd_scene.cpp:4-37);
    here the whole build is device arithmetic (SceneNN.from_depth_device:
    grid table, far-parked invalid pixels, static Morton order) so it
    traces into the same program as render->lift->ICP. scene_stride
    subsamples the scene grid; scene_pool centroid-pools it (the on-device
    voxel-downsample equivalent - see scene.nn._pool_scene_grid)."""
    scene = SceneNN.from_depth_device(
        frame_depth, K_full, max_dist, stride=scene_stride, perm=perm,
        pool=scene_pool,
    )
    out = refine_poses_jit(
        tris, init_poses, scene, proj, K_render,
        width=width, height=height, max_points=max_points, criteria=criteria,
        use_pallas=use_pallas, lift=lift, window=window, stride=stride,
        roi=roi, chunk_iters=chunk_iters, robust_delta=robust_delta,
        coarse_iters=coarse_iters, coarse_stride=coarse_stride,
        estimation=estimation, with_information=with_information,
    )
    return _pack_track_outputs(*out) if pack_outputs else out


class MultiModelRefiner(PoseRefiner):
    """Refine hypotheses of SEVERAL models against one scene in ONE fused
    program (beyond parity: the reference binds one mesh per renderer and
    must run its whole pipeline once per object - pose_renderer.h:15-19).

    The raster setup is per-(pose, triangle) everywhere, so nothing stops
    each hypothesis from rasterizing a different mesh: models are Morton-
    ordered, optionally decimated, padded with zero-area triangles to a
    common count and stacked into an (M, T, 3, 3) device table; refine()
    gathers per-pose triangles by model id and runs the standard pipeline.

    Memory: the per-pose gather materializes N x Tmax x 36 bytes of device
    memory (e.g. 256 hypotheses of an undecimated 31k-tri mesh ~ 290 MB) - cost
    scales with BATCH SIZE x the largest model, not model count. For large
    batches of heavy meshes, set decimate_mm (4 mm cuts obj_06 to 5.2k
    tris ~ 48 MB at batch 256) or split the
    batch; the (M, T, 3, 3) master table itself is shared.

    Example:
        refiner = MultiModelRefiner([model_a, model_b], K=K)
        refiner.set_scene_depth(depth)      # scene may contain either object
        refined, res = refiner.refine([0, 0, 1, 1], poses)   # 2 hyps each
    """

    def __init__(self, models, K, **kwargs):
        models = [Model.load(m) if isinstance(m, str) else m for m in models]
        if not models:
            raise ValueError("MultiModelRefiner needs at least one model")
        super().__init__(models[0], K, **kwargs)
        self.models = models
        tables = []
        for m in models:
            rm = m
            if self.decimate_mm > 0.0:
                from pose_refine.mesh import simplify_vertex_clustering

                rm = simplify_vertex_clustering(m, self.decimate_mm)
            tables.append(rm.tris[morton_order(rm.tris)])
        tmax = max(t.shape[0] for t in tables)
        padded = []
        for t in tables:
            if t.shape[0] < tmax:
                # degenerate pad: zero-area triangles at the model's first
                # vertex - culled by the zero-area test in every raster path
                pad = np.broadcast_to(t[:1, :1, :], (tmax - t.shape[0], 3, 3))
                t = np.concatenate([t, pad], axis=0)
            padded.append(t)
        self.tris_table = jnp.asarray(np.stack(padded))  # (M, T, 3, 3)

    def _per_pose_tris(self, model_ids, init_poses):
        """Validate (model_ids, poses) and gather the per-pose triangle
        tables. Returns (tris (N,T,3,3), poses (N,4,4), squeeze)."""
        ids_np = np.asarray(model_ids, np.int32).reshape(-1)
        if ids_np.size and (ids_np.min() < 0 or ids_np.max() >= len(self.models)):
            # jnp.take would silently clamp/fill out-of-bounds rows and the
            # garbage render then "succeeds" with fitness 0 - fail loudly
            raise ValueError(
                f"model_ids must be in [0, {len(self.models)}), got "
                f"[{ids_np.min()}, {ids_np.max()}]"
            )
        init_poses = jnp.asarray(init_poses, jnp.float32)
        squeeze = init_poses.ndim == 2
        if squeeze:
            init_poses = init_poses[None]
        if init_poses.shape[0] != ids_np.shape[0]:
            raise ValueError(
                f"{ids_np.shape[0]} model ids for {init_poses.shape[0]} poses"
            )
        tris = jnp.take(self.tris_table, jnp.asarray(ids_np), axis=0)
        return tris, init_poses, squeeze

    @staticmethod
    def _maybe_squeeze(squeeze, out):
        """Unbatch a (refined, results[, uncertainty]) tuple."""
        if squeeze:
            out = tuple(jax.tree.map(lambda x: x[0], o) for o in out)
        return out

    def refine(self, model_ids, init_poses=None, **kwargs):
        """(model_ids (N,), init_poses (N, 4, 4)) -> refined + results.
        A single (4, 4) pose with a scalar id returns unbatched results,
        matching PoseRefiner.refine (incl. with_covariance=True's appended
        PoseUncertainty)."""
        if init_poses is None:
            raise TypeError("MultiModelRefiner.refine(model_ids, init_poses)")
        tris, poses, squeeze = self._per_pose_tris(model_ids, init_poses)
        out = super().refine(poses, _tris=tris, **kwargs)
        return self._maybe_squeeze(squeeze, out)

    def track(self, frame_depth, model_ids, init_poses=None, **kwargs):
        """Fused per-frame tracking with per-pose models:
        (frame_depth, model_ids (N,), init_poses (N, 4, 4))."""
        if init_poses is None:
            raise TypeError(
                "MultiModelRefiner.track(frame_depth, model_ids, init_poses)"
            )
        tris, poses, squeeze = self._per_pose_tris(model_ids, init_poses)
        out = super().track(frame_depth, poses, _tris=tris, **kwargs)
        return self._maybe_squeeze(squeeze, out)
