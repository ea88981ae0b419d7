"""Headline benchmark: poses refined per second, batch-256, obj_06 workload.

Runs the full production pipeline on the GPU (and refuses to run without
one):
  render 256 pose hypotheses of the benchmark mesh (the raster kernel at
  the reference's down_sample=2 raster - pose_renderer.cpp:28-29 - from a
  4 mm vertex-clustered render mesh) -> scatter-free window lift + lossless
  top_k to 2048-point clouds -> projective point-to-plane ICP against the
  full-res observed scene, all in ONE jitted program; scene built once per
  frame (its cost is amortized and reported separately).

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "poses/sec", "vs_baseline": N}
Secondary metrics (render-only throughput incl. the reference's ROI case,
NN-scene pipeline, full-res pipeline, warm scene re-init, quality gates) go
to stderr as additional JSON lines prefixed with '# ', each naming the
card and its power limit.

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is the BASELINE.json north-star target of refining 256 hypotheses
at lower wall-clock than the CUDA reference on an RTX-class GPU, estimated
at 1 s for the batch (about 4 ms per render+ICP on such hardware) =>
baseline = 256 poses/sec, vs_baseline = value / 256.
"""

import json
import sys
import time

import numpy as np


CARD = {}


def _emit(obj):
    print("# " + json.dumps({**obj, **CARD}), file=sys.stderr)


def _time_median(fn, sync, iters=3):
    """Compile/warm once, then median wall-clock of `iters` fenced runs."""
    out = fn()
    sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def _stream_median(enqueue_fn, fence_fn, k, iters=3):
    """Median per-batch wall of `iters` streaming rounds (k batches in
    flight, ONE fence per round)."""
    fence_fn([enqueue_fn() for _ in range(k)])  # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fence_fn([enqueue_fn() for _ in range(k)])
        times.append((time.perf_counter() - t0) / k)
    return sorted(times)[len(times) // 2]


def main():
    import jax
    import jax.numpy as jnp

    import pose_refine as prt
    from pose_refine import geometry, mesh, platform
    from pose_refine.utils.metrics import rotation_angle_deg

    platform.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU - JAX found {dev.platform} ({dev.device_kind})")
    CARD.update(device=dev.device_kind, card=platform.gpu_card())
    sync = jax.block_until_ready

    WIDTH, HEIGHT = 640, 480
    N_POSES = 256
    # production config: half-res hypothesis renders (reference's
    # down_sample), window lift 128/stride 2 (4096 candidates), top_k-
    # compacted to 2048 points, hypothesis render mesh vertex-clustered at
    # 4 mm (following the reference's own >10k-face simplification
    # guidance, renderer.cpp:50-57); studies: scripts/budget2k_sweep.py,
    # scripts/decimation_speed_study.py. The full-mesh number is a
    # secondary metric below. chunk_iters stays at "auto"
    # (pose_refine.platform).
    CFG = dict(render_scale=2, max_points=2048, window=128, stride=2,
               decimate_mm=4.0)
    # production criteria: max_iteration=24 (API default stays the
    # reference's 30). The fused loop pays every iteration whether poses
    # converged or not; 24 kept per-case verdicts and ADD identical to the
    # 30-iteration run (scripts/iter_budget_study.py).
    from pose_refine.icp import ICPConvergenceCriteria

    CRIT = ICPConvergenceCriteria(max_iteration=24)

    model = mesh.load_benchmark_model()
    tris = jnp.asarray(model.tris[mesh.morton_order(model.tris)])
    K = geometry.LINEMOD_K
    proj = geometry.compute_proj(K, WIDTH, HEIGHT)

    # ground-truth pose (reference demo viewpoint) + 256 perturbed hypotheses
    R_ren = np.array(
        [
            [0.34768538, 0.93761126, 0.0],
            [0.70540612, -0.26157897, -0.65877056],
            [-0.61767070, 0.22904489, -0.75234390],
        ],
        np.float32,
    )
    truth = np.asarray(geometry.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    rng = np.random.default_rng(0)
    d_ang = rng.uniform(-0.17, 0.17, (N_POSES, 3)).astype(np.float32)  # ~10 deg
    d_rot = np.asarray(geometry.euler_to_rotation(d_ang))
    d_t = rng.uniform(-20, 20, (N_POSES, 3)).astype(np.float32)
    poses = np.asarray(
        geometry.pose_from_Rt(
            np.einsum("nij,jk->nik", d_rot, truth[:3, :3]), truth[:3, 3] + d_t
        )
    )

    def render_fn(poses_arr, roi=(0, 0, 0, 0)):
        # the library's own dispatch - no hand-rolled twin to drift from it
        import pose_refine.ops.rasterize as rz

        return rz.render(tris, poses_arr, WIDTH, HEIGHT, proj, roi=roi)

    # observed scene: the model at the ground-truth pose
    t0 = time.perf_counter()
    scene_depth = np.asarray(sync(render_fn(jnp.asarray(truth)[None])))[0]
    refiner = prt.PoseRefiner(
        model, K=K, width=WIDTH, height=HEIGHT, **CFG
    )
    refiner.set_scene_depth(scene_depth)
    scene_init_s = time.perf_counter() - t0

    # PoseRefiner auto-shards the pose batch over all attached devices
    # (pure data parallelism, devices=None default) - no separate path
    n_dev = len(jax.devices())
    poses_dev = jax.device_put(jnp.asarray(poses))

    def run():
        return refiner.refine(poses_dev, criteria=CRIT)

    # compile + warm
    t0 = time.perf_counter()
    refined, results = run()
    sync((refined, results.fitness))
    compile_s = time.perf_counter() - t0

    dt, (refined, results) = _time_median(
        run, lambda o: sync((o[0], o[1].fitness)), iters=5
    )

    fit = np.asarray(results.fitness)
    rot_err = rotation_angle_deg(np.asarray(refined), truth)
    dev_ok = rot_err < 3.0
    ok = float(dev_ok.mean())

    # ---- secondary metric: render-only throughput (reference workload:
    # cuda_renderer/test.cpp:63-91 batch 100 full frame; :116-157 the
    # ROI {160,80,320,240} repeat) ----
    def time_render(n, roi=(0, 0, 0, 0)):
        batch = jax.device_put(jnp.asarray(np.tile(truth, (n, 1, 1))))
        t, _ = _time_median(lambda: render_fn(batch, roi=roi), sync)
        return t

    for n, roi, tag in (
        (100, (0, 0, 0, 0), "renders_per_sec_batch100_640x480"),
        (256, (0, 0, 0, 0), "renders_per_sec_batch256_640x480"),
        (100, (160, 80, 320, 240), "renders_per_sec_batch100_roi320x240"),
    ):
        t = time_render(n, roi)
        _emit({"metric": tag, "value": round(n / t, 1), "unit": "renders/sec",
               "wall_ms": round(t * 1000, 1)})

    # ---- secondary metric: warm scene re-init (the reference rebuilds the
    # scene EVERY frame, SURVEY 3.3 - steady-state cost matters) ----
    depth2 = np.asarray(sync(render_fn(jnp.asarray(poses[0])[None])))[0]
    t0 = time.perf_counter()
    refiner.set_scene_depth(depth2)
    sync(refiner.scene.table)
    warm_init_s = time.perf_counter() - t0
    refiner.set_scene_depth(scene_depth)  # restore
    _emit({"metric": "scene_reinit_warm_ms", "value": round(warm_init_s * 1000, 1),
           "unit": "ms"})

    # ---- secondary metric: full-res pipeline (render_scale=1, full mesh -
    # the conservative config). stride=3 keeps per-case verdicts and ADD of
    # stride=2 while the top_k compaction sees 7396 keys instead of 16384
    # (scripts/fullres_lift_study.py). ----
    refiner_fr = prt.PoseRefiner(
        model, K=K, width=WIDTH, height=HEIGHT,
        max_points=4096, window=256, stride=3,
    )
    refiner_fr.set_scene_depth(scene_depth)
    poses_dev2 = jax.device_put(jnp.asarray(poses))
    # same 24-iter budget as every other pipeline metric
    t_fr, _ = _time_median(
        lambda: refiner_fr.refine(poses_dev2, criteria=CRIT),
        lambda o: sync((o[0],))
    )
    _emit({"metric": "poses_per_sec_batch256_fullres_render", "value": round(N_POSES / t_fr, 1),
           "unit": "poses/sec", "wall_ms": round(t_fr * 1000, 1)})

    # ---- secondary metric: batch-512 scaling (fixed per-dispatch and
    # setup costs amortize over a larger hypothesis batch) ----
    poses512 = jax.device_put(jnp.asarray(np.concatenate([poses, poses])))
    try:
        t512, _ = _time_median(
            lambda: refiner.refine(poses512, criteria=CRIT), lambda o: sync((o[0], o[1].fitness))
        )
        _emit({"metric": "poses_per_sec_batch512", "value": round(512 / t512, 1),
               "unit": "poses/sec", "wall_ms": round(t512 * 1000, 1)})
    except Exception as e:
        _emit({"metric": "poses_per_sec_batch512", "error": str(e)[:200]})

    # ---- secondary metric: streaming throughput (serving mode) via the
    # public API - refine_async enqueues K batches back-to-back, fence()
    # synchronizes once; the runtime pipelines the dispatches, hiding host
    # dispatch behind device work. Batch 256 (headline config)
    # and plain batch 512 (the README serving number) - both medians ----
    K_STREAM = 4
    try:
        t_stream = _stream_median(
            lambda: refiner.refine_async(poses_dev, criteria=CRIT),
            lambda p: prt.fence(*p), K_STREAM)
        _emit({"metric": "poses_per_sec_batch256_streaming", "value": round(N_POSES / t_stream, 1),
               "unit": "poses/sec", "wall_ms_per_batch": round(t_stream * 1000, 1),
               "batches_in_flight": K_STREAM})
    except Exception as e:
        _emit({"metric": "poses_per_sec_batch256_streaming", "error": str(e)[:200]})
    try:
        t_s512 = _stream_median(
            lambda: refiner.refine_async(poses512, criteria=CRIT),
            lambda p: prt.fence(*p), K_STREAM)
        _emit({"metric": "poses_per_sec_batch512_streaming", "value": round(512 / t_s512, 1),
               "unit": "poses/sec", "wall_ms_per_batch": round(t_s512 * 1000, 1),
               "batches_in_flight": K_STREAM, "batch": 512})
    except Exception as e:
        _emit({"metric": "poses_per_sec_batch512_streaming", "error": str(e)[:200]})

    # ---- secondary metric: fused filter tracking through the production
    # TrackingSession API, PIPELINED (step_async): frame k's fused program
    # (scene rebuild + refine + measurement covariance) executes while
    # frame k-1's readback/fusion and frame k+1's host prep run. Sensor
    # frames are pre-rendered (not part of the tracked cost). ----
    try:
        N_TRACK, N_HYP = 12, 16
        tr_truth = truth.copy()
        trng = np.random.default_rng(9)
        tr_frames, tr_truths = [], []
        for _ in range(N_TRACK):
            drift = np.asarray(geometry.euler_to_rotation(
                trng.uniform(-0.035, 0.035, 3).astype(np.float32)))
            tr_truth = np.asarray(geometry.pose_from_Rt(
                drift @ tr_truth[:3, :3],
                tr_truth[:3, 3] + trng.uniform(-5, 5, 3).astype(np.float32)))
            tr_truths.append(tr_truth.copy())
            tr_frames.append(
                np.asarray(sync(render_fn(jnp.asarray(tr_truth[None]))))[0])
        def _track_loop():
            """One full session over all frames; per-frame wall averaged
            over EVERY dispatch and fence."""
            session = prt.TrackingSession(
                refiner, truth, n_hypotheses=N_HYP,
                process_noise=(np.radians(2.0), 0.005), seed=9)
            t0 = time.perf_counter()
            for f in tr_frames:
                session.step_async(f)
            last = session.flush()
            return (time.perf_counter() - t0) / N_TRACK, session, last

        _track_loop()  # pays the compile
        runs = sorted((_track_loop() for _ in range(3)),
                      key=lambda r: r[0])
        t_frame, session, last = runs[len(runs) // 2]
        err_deg = float(rotation_angle_deg(last.pose, tr_truths[-1]))
        _emit({"metric": "tracking_fps_fused_filter", "value": round(1.0 / t_frame, 1),
               "unit": "frames/sec", "wall_ms_per_frame": round(t_frame * 1000, 1),
               "n_hypotheses": N_HYP, "pipelined": True,
               "n_rejected": int(session.n_rejected),
               "final_rot_err_deg": round(err_deg, 3)})
    except Exception as e:
        _emit({"metric": "tracking_fps_fused_filter", "error": str(e)[:200]})

    # ---- secondary metric: the OPT-IN serving ceiling - streaming batch
    # 512 x 4 in flight with the coarse-to-fine ICP point schedule
    # (coarse_iters=16/coarse_stride=4). Not the headline config: some
    # borderline verdicts flip under the schedule
    # (scripts/coarse_points_study.py), so it stays opt-in ----
    try:
        refiner_c = prt.PoseRefiner(
            model, K=K, width=WIDTH, height=HEIGHT,
            coarse_iters=16, coarse_stride=4, **CFG
        )
        refiner_c.set_scene_depth(scene_depth)
        t_ceil = _stream_median(
            lambda: refiner_c.refine_async(poses512, criteria=CRIT),
            lambda p: prt.fence(*p), 4)
        _emit({"metric": "poses_per_sec_serving_ceiling_coarse_optin",
               "value": round(512 / t_ceil, 1), "unit": "poses/sec",
               "wall_ms_per_batch": round(t_ceil * 1000, 1),
               "batches_in_flight": 4, "batch": 512,
               "config": {"coarse_iters": 16, "coarse_stride": 4}})
    except Exception as e:
        _emit({"metric": "poses_per_sec_serving_ceiling_coarse_optin",
               "error": str(e)[:200]})

    # ---- secondary metric: production config WITHOUT render-mesh
    # decimation (the full 31k-tri obj_06, for apples-to-apples against
    # renderers that do not simplify) ----
    cfg_full = {**CFG, "decimate_mm": 0.0}
    refiner_full = prt.PoseRefiner(
        model, K=K, width=WIDTH, height=HEIGHT, **cfg_full
    )
    refiner_full.set_scene_depth(scene_depth)
    t_full, (r_full, _) = _time_median(
        lambda: refiner_full.refine(poses_dev2, criteria=CRIT), lambda o: sync((o[0],)), iters=5
    )
    rot_full = rotation_angle_deg(np.asarray(r_full), truth)
    _emit({"metric": "poses_per_sec_batch256_full_mesh", "value": round(N_POSES / t_full, 1),
           "unit": "poses/sec", "wall_ms": round(t_full * 1000, 1),
           "verdict_agreement_vs_decimated": round(float(((rot_full < 3.0) == dev_ok).mean()), 3)})

    # ---- secondary metric: NN-association pipeline (reference headline
    # feature #2, README.md:9-15) - exact NN against a 2 mm
    # voxel-downsampled scene cloud (standard ICP practice; voxel centroids
    # denoise the 1 mm depth quantization, scripts/nn_voxel_study.py). The
    # raw-cloud number is emitted alongside, plus the scene-cascade
    # raw-cloud config (16 coarse iters vs a 2 mm twin + 4 full-res iters,
    # scripts/nn_cascade_study.py). ----
    for vox, cascade, crit_nn, tag in (
            (2.0, None, CRIT, "poses_per_sec_batch256_nn_scene"),
            (0.0, None, CRIT, "poses_per_sec_batch256_nn_scene_raw_cloud"),
            (0.0, (2.0, 16), ICPConvergenceCriteria(max_iteration=4),
             "poses_per_sec_batch256_nn_raw_cloud_cascade")):
        try:
            refiner_nn = prt.PoseRefiner(
                model, K=K, width=WIDTH, height=HEIGHT,
                scene="nn_bruteforce", scene_voxel_mm=vox,
                scene_cascade=cascade, **CFG,
            )
            refiner_nn.set_scene_depth(scene_depth)
            n_nn = N_POSES
            poses_nn = jax.device_put(jnp.asarray(poses[:n_nn]))
            t_nn, (r_nn, res_nn) = _time_median(
                lambda: refiner_nn.refine(poses_nn, criteria=crit_nn), lambda o: sync((o[0],))
            )
            rot_nn = rotation_angle_deg(np.asarray(r_nn), truth)
            _emit({"metric": tag, "value": round(n_nn / t_nn, 1),
                   "unit": "poses/sec", "wall_ms": round(t_nn * 1000, 1),
                   "scene_pts": int(refiner_nn.scene.points.shape[0]),
                   "recovered_lt3deg": round(float((rot_nn < 3.0).mean()), 3)})
        except Exception as e:
            _emit({"metric": tag, "error": str(e)[:200]})

    # ---- measured same-host CPU baseline + fixed-seed verdict agreement:
    # the reference algorithm in C++ (native/cpu_baseline.cpp) on a pose
    # subset; its per-case recover/fail verdicts are the quality gate (the
    # raw recovery %% moves +-10%% run to run, verdict agreement does not) ----
    cpu_line = "cpu baseline unavailable"
    agreement = None
    try:
        from pose_refine import native

        if native.native_available():
            n_sub = 16
            t0 = time.perf_counter()
            dep_cc = native.cpu_render_baseline(
                np.asarray(tris), poses[:n_sub], np.asarray(proj), WIDTH, HEIGHT
            )
            cpu_render_s = time.perf_counter() - t0
            clouds_v, valids_v = [], []
            K_np = np.asarray(K, np.float32)
            for i in range(n_sub):
                # full compacted cloud - the reference algorithm's own lift
                # (scan-order compaction of a smaller budget would keep only
                # the top image rows and bias its convergence), in host
                # numpy: a CPU-only baseline needs its inputs host-side
                d = dep_cc[i]
                vs, us = np.nonzero(d > 0)  # row-major == scan order
                z = d[vs, us].astype(np.float32) / 1000.0
                pts = np.stack([
                    (us.astype(np.float32) - K_np[0, 2]) / K_np[0, 0] * z,
                    (vs.astype(np.float32) - K_np[1, 2]) / K_np[1, 1] * z,
                    z,
                ], axis=-1)[:32768]
                c = np.zeros((32768, 3), np.float32)
                c[: len(pts)] = pts
                v = np.zeros((32768,), bool)
                v[: len(pts)] = True
                clouds_v.append(c)
                valids_v.append(v)
            scene_p = refiner.scene
            # best-of-2: background work (XLA compile threads) can steal
            # cores mid-run; the verdicts are deterministic either way
            cpu_icp_s = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                T_cc, _, _ = native.cpu_icp_baseline(
                    np.stack(clouds_v), np.stack(valids_v),
                    np.asarray(scene_p.pcd), np.asarray(scene_p.normal), K,
                )
                cpu_icp_s = min(cpu_icp_s, time.perf_counter() - t0)
            T_mm = T_cc.copy()
            T_mm[:, :3, 3] *= 1000.0
            cpu_final = np.einsum("nij,njk->nik", T_mm, poses[:n_sub])
            cpu_ok = rotation_angle_deg(cpu_final, truth) < 3.0
            agreement = float((dev_ok[:n_sub] == cpu_ok).mean())
            cpu_per_pose = (cpu_render_s + cpu_icp_s) / n_sub
            cpu_line = (
                f"same-host CPU baseline ({native.cpu_threads()} threads): "
                f"{1.0/cpu_per_pose:.1f} poses/sec "
                f"({cpu_render_s/n_sub*1000:.0f} ms render + {cpu_icp_s/n_sub*1000:.0f} ms icp per pose)"
            )
            _emit({"metric": "verdict_agreement_vs_reference_alg",
                   "value": agreement, "unit": "fraction", "n_cases": n_sub})
    except Exception as e:  # baseline must never break the bench
        cpu_line = f"cpu baseline failed: {e}"

    value = N_POSES / dt
    result = {
        "metric": "poses_refined_per_sec_batch256_640x480_full_pipeline",
        "value": round(value, 2),
        "unit": "poses/sec",
        "vs_baseline": round(value / 256.0, 4),
    }
    print(json.dumps(result))
    print(
        f"# details: batch {N_POSES}, wall {dt*1000:.1f} ms, compile {compile_s:.1f} s, "
        f"scene init {scene_init_s*1000:.1f} ms (warm re-init {warm_init_s*1000:.1f} ms), "
        f"mean fitness {fit.mean():.3f}, recovered<3deg {ok*100:.0f}%, "
        f"verdict agreement vs reference alg {('%.0f%%' % (agreement*100)) if agreement is not None else 'n/a'}, "
        f"config {CFG}, device {CARD['device']} x{n_dev} ({CARD['card']}); "
        f"{cpu_line}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
