"""Smoke check of the render -> ICP pipeline on one NVIDIA GPU.

Drives the library through its public entry points at the production
configuration (640x480 frames, batch 256, a seeded 20,480-triangle bumpy
sphere), runs every kernel of that path as compiled for the card, and
checks the results against the plain references:

  1. rasterizer  - the GPU kernel compiled at full frame (batch 256) and at
                   the pipeline's auto-ROI shape; parity with rasterize_dense
                   (4 poses) and the numpy scanline oracle (1 pose);
  2. projective  - PoseRefiner at the production config, 256 hypotheses;
                   16 poses checked against the same program on the CPU and
                   against the C++ reference algorithm;
  3. nn          - scene='nn' and 'nn_bruteforce', 2 mm voxels and the raw
                   cloud, batch 256; 16 poses checked against the CPU;
  4. tracking    - 12 frames of TrackingSession.step_async, projective and
                   with a device-built NN scene;
  5. timing      - the raster kernel against XLA's rasterize_scatter
                   (render-only and inside the phase-2 pipeline), and the
                   kd traversal against the brute-force NN scan.

Every phase runs; the script exits non-zero if any failed, if JAX finds no
GPU, or if the package is missing. The last line of stdout is one JSON
object naming the device. Run from the repository root:

    python chip_smoke.py              # one card, all phases
    python chip_smoke.py --chips 4    # only the data-parallel path, 4 cards
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

WIDTH, HEIGHT = 640, 480
N_POSES = 256
N_CHECK = 16
# production configuration (bench.py): half-res hypothesis renders, window
# lift 128 / stride 2 compacted to 2048 points, 4 mm decimated render mesh
CFG = dict(render_scale=2, max_points=2048, window=128, stride=2, decimate_mm=4.0)
MAX_ITER = 24
RECOVERED_DEG = 3.0
MIN_RECOVERY = 0.5  # of the batch-256 hypotheses
MIN_AGREEMENT = 1.0  # verdict agreement with the C++ reference algorithm
# phase-2/3 agreement with the CPU run. Float contraction and summation
# order differ between the two backends; projective association rounds
# each point to a pixel, so an ulp can move a correspondence, and the
# bumpy sphere's rotation is weakly observable (a near-sphere), so such a
# move shifts a pose by tenths of a degree along that direction. Required:
# identical verdicts; every recovered pose within TOL_MM and TOL_DEG_MAX;
# the median pose within TOL_DEG.
TOL_DEG, TOL_MM, TOL_DEG_MAX = 0.1, 0.2, 1.0
# rasterizer parity: a pixel centre on a triangle edge, or a depth on a .5 mm
# rounding boundary, can move under a different floating-point contraction
# (FMA), nothing else. Every pixel that differs by more than RASTER_MM must
# be such an edge pixel (some triangle's barycentric within EDGE_TOL of 0
# in float64).
RASTER_PIXEL_FRAC, RASTER_MM, EDGE_TOL = 1e-4, 1, 1e-4


CARD = ""


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def timed(msg: str, seconds: float) -> None:
    log(f"{msg}: {seconds * 1e3:.3f} ms  [{CARD}]")


def median_time(fn, iters: int = 5):
    """Warm once, then the median wall time of ``iters`` fenced calls."""
    import jax

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def workload():
    """Mesh, truth pose and the batch of perturbed hypotheses (bench.py's
    recipe: +-0.17 rad per Euler axis, +-20 mm per axis)."""
    from pose_refine import geometry, mesh

    model = mesh.make_bumpy_sphere(radius=50.0, subdivisions=5)
    K = np.asarray(geometry.LINEMOD_K, np.float32)
    R_ren = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = np.eye(4, dtype=np.float32)
    truth[:3, :3] = R_ren
    truth[:3, 3] = (0.0, 0.0, 300.0)
    rng = np.random.default_rng(0)
    d_rot = geometry._euler_to_rotation_np(
        rng.uniform(-0.17, 0.17, (N_POSES, 3)).astype(np.float32))
    d_t = rng.uniform(-20, 20, (N_POSES, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N_POSES, 1, 1))
    poses[:, :3, :3] = np.einsum("nij,jk->nik", d_rot, R_ren)
    poses[:, :3, 3] = truth[:3, 3] + d_t
    return model, K, truth, poses


def pose_errors(a, b):
    """(rotation deg, translation mm) between two (N, 4, 4) pose batches."""
    from pose_refine.utils.metrics import rotation_angle_deg

    a, b = np.asarray(a), np.asarray(b)
    return (rotation_angle_deg(a, b),
            np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1))


def check_against(name, got, want, truth):
    """16-pose agreement of two refinements: pose within TOL, same verdict."""
    from pose_refine.utils.metrics import rotation_angle_deg

    d_rot, d_t = pose_errors(got, want)
    v_got = rotation_angle_deg(np.asarray(got), truth) < RECOVERED_DEG
    v_want = rotation_angle_deg(np.asarray(want), truth) < RECOVERED_DEG
    worst = int(np.argmax(d_rot))
    log(f"  {name}: max rot diff {d_rot.max():.5f} deg (pose {worst}, "
        f"recovered {bool(v_got[worst])}), max trans diff {d_t.max():.5f} mm, "
        f"verdicts {int(v_got.sum())}/{len(v_got)} vs "
        f"{int(v_want.sum())}/{len(v_want)}, agreement "
        f"{float((v_got == v_want).mean()):.3f}")
    log(f"    per-pose rot diff (deg): {np.array2string(d_rot, precision=4)}")
    log(f"    per-pose trans diff (mm): {np.array2string(d_t, precision=4)}")
    rec = v_got & v_want
    assert (v_got == v_want).all(), f"{name}: verdicts differ"
    assert np.median(d_rot) <= TOL_DEG, f"{name}: median rotation diff {np.median(d_rot)}"
    assert np.median(d_t) <= TOL_MM, f"{name}: median translation diff {np.median(d_t)}"
    assert (d_rot[rec] <= TOL_DEG_MAX).all(), f"{name}: a recovered pose differs by >{TOL_DEG_MAX} deg"
    assert (d_t[rec] <= TOL_MM).all(), f"{name}: a recovered pose differs by >{TOL_MM} mm"


class Ctx:
    """State shared by the phases of one run."""

    def __init__(self):
        import jax

        from pose_refine import platform
        import pose_refine.ops.rasterize as rz

        self.jax = jax
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.model, self.K, self.truth, self.poses = workload()
        from pose_refine import geometry, mesh

        self.proj = np.asarray(geometry.compute_proj(self.K, WIDTH, HEIGHT))
        self.full_tris = self.model.tris[mesh.morton_order(self.model.tris)]
        # observed scene: the model at the truth pose, rendered by the
        # platform's rasterizer
        self.scene_depth = np.asarray(rz.render(
            self.full_tris, self.truth[None], WIDTH, HEIGHT, self.proj))[0]
        assert platform.raster_kernel(), "the GPU must take the raster kernel"
        from pose_refine.icp import ICPConvergenceCriteria

        self.crit = ICPConvergenceCriteria(max_iteration=MAX_ITER)
        self.refiner = self.make_refiner()

    def make_refiner(self, **kw):
        import pose_refine as prt

        r = prt.PoseRefiner(self.model, K=self.K, width=WIDTH, height=HEIGHT,
                            **{**CFG, **kw})
        r.set_scene_depth(self.scene_depth)
        return r

    def cpu_refine(self, poses, **kw):
        """The same refinement pinned to the CPU device, with the CPU's
        platform choices."""
        from pose_refine import platform

        with self.jax.default_device(self.cpu):
            r = self.make_refiner(
                use_pallas=platform.raster_kernel("cpu"),
                chunk_iters=platform.icp_chunk_iters(MAX_ITER, "cpu"),
                devices=1, **kw)
            refined, _ = r.refine(np.asarray(poses), criteria=self.crit)
            return np.asarray(refined)


def dense_on_cpu(c: Ctx, tris, poses, w, h, proj, roi=(0, 0, 0, 0)):
    """rasterize_dense (the exact O(T*H*W) oracle) on the CPU device, over
    the smallest crop that holds every clamped triangle bbox of these poses
    - outside it the oracle is empty by construction - pasted into an
    empty frame of the render's shape."""
    import pose_refine.ops.rasterize as rz

    with c.jax.default_device(c.cpu):
        pts2, _ = rz.screen_triangles(tris, poses, proj, w, h)
        bbmin, bbmax = map(np.asarray, rz.triangle_bbox(pts2, w, h, roi))
        out_w, out_h = rz.roi_shape(w, h, roi)
        x0s, y0s = np.trunc(bbmin[..., 0] + 0.5), np.trunc(bbmin[..., 1] + 0.5)
        x1s, y1s = np.floor(bbmax[..., 0]), np.floor(bbmax[..., 1])
        live = (x0s <= x1s) & (y0s <= y1s) & np.isfinite(x0s + y0s + x1s + y1s)
        frame = np.zeros((len(poses), out_h, out_w), np.int32)
        if not live.any():
            return frame
        x0, x1 = int(x0s[live].min()), int(x1s[live].max())
        y0, y1 = int(y0s[live].min()), int(y1s[live].max())
        crop = (x0, h - 1 - y1, x1 - x0 + 1, y1 - y0 + 1)  # image coords
        dense = np.asarray(rz.rasterize_dense(tris, poses, w, h, proj, roi=crop))
    r0, c0 = crop[1] - roi[1], crop[0] - roi[0]
    frame[:, r0:r0 + crop[3], c0:c0 + crop[2]] = dense
    return frame


def on_an_edge(tris, pose, w, h, proj, roi, row, col):
    """True if a triangle edge passes through pixel (row, col) of a render
    (ROI coordinates) to within EDGE_TOL, in float64 barycentrics."""
    t = np.asarray(tris, np.float64)
    pose, proj = np.asarray(pose, np.float64), np.asarray(proj, np.float64)
    cam = t @ pose[:3, :3].T + pose[:3, 3]
    pr = cam @ proj[:2, :3].T + proj[:2, 3]
    sx = pr[..., 0] / cam[..., 2] * (w / 2.0) + w / 2.0
    sy = pr[..., 1] / cam[..., 2] * (h / 2.0) + h / 2.0
    px, py = col + roi[0], h - 1 - roi[1] - row  # flipped-y P space
    (ax, bx, cx), (ay, by, cy) = sx.T, sy.T
    with np.errstate(divide="ignore", invalid="ignore"):
        area = 0.5 * ((cx - ax) * (by - ay) - (bx - ax) * (cy - ay))
        beta = 0.5 * ((cx - ax) * (py - ay) - (px - ax) * (cy - ay)) / area
        gamma = 0.5 * ((px - ax) * (by - ay) - (bx - ax) * (py - ay)) / area
    bary = np.stack([1.0 - beta - gamma, beta, gamma])
    lo, hi = bary.min(axis=0), bary.max(axis=0)
    touching = (lo >= -EDGE_TOL) & (hi <= 1.0 + EDGE_TOL)
    return bool((touching & ((np.abs(lo) <= EDGE_TOL)
                             | (np.abs(hi - 1.0) <= EDGE_TOL))).any())


def phase_rasterizer(c: Ctx):
    import pose_refine.ops.rasterize as rz
    from pose_refine.ops.rasterize_pallas import rasterize_pallas
    from pose_refine.utils import oracle

    r = c.refiner
    shapes = [
        (f"full frame {WIDTH}x{HEIGHT}, batch {N_POSES}", c.full_tris, WIDTH, HEIGHT, c.proj,
         (0, 0, 0, 0)),
        (f"pipeline auto-ROI {r.roi} of {r.render_w}x{r.render_h}, "
         f"batch {N_POSES}",
         np.asarray(r.tris), r.render_w, r.render_h, np.asarray(r.proj), r.roi),
    ]
    poses = c.jax.device_put(c.poses)
    for name, tris, w, h, proj, roi in shapes:
        t0 = time.perf_counter()
        compiled = rasterize_pallas.lower(
            tris, poses, width=w, height=h, proj=proj, roi=roi).compile()
        log(f"  compiled raster kernel, {name} ({tris.shape[0]} tris) in "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"  memory_analysis: {compiled.memory_analysis()}")

    def compare(name, got, want, tris, poses, w, h, proj, roi=(0, 0, 0, 0)):
        got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
        flips = ((got > 0) != (want > 0))
        diff = np.abs(got - want)
        frac = float((diff > 0).mean())
        big = np.argwhere(diff > RASTER_MM)
        edge = [on_an_edge(tris, poses[i], w, h, proj, roi, r_, c_)
                for i, r_, c_ in big]
        log(f"  {name}: {int((want > 0).sum())} covered px, "
            f"{int((diff > 0).sum())} differ ({frac:.2e} of {got.size}), "
            f"{int(flips.sum())} coverage flips, {len(big)} differ by "
            f">{RASTER_MM} mm (max {int(diff.max())} mm), of which "
            f"{sum(edge)} sit on a triangle edge")
        assert frac <= RASTER_PIXEL_FRAC, f"{name}: {frac} of pixels differ"
        assert all(edge), f"{name}: a depth differs off any triangle edge"

    sub = c.poses[:4]
    compare("kernel vs rasterize_dense (4 poses, full frame)",
            rasterize_pallas(c.full_tris, sub, WIDTH, HEIGHT, c.proj),
            dense_on_cpu(c, c.full_tris, sub, WIDTH, HEIGHT, c.proj),
            c.full_tris, sub, WIDTH, HEIGHT, c.proj)
    rt, rp = np.asarray(r.tris), np.asarray(r.proj)
    compare("kernel vs rasterize_dense (4 poses, auto-ROI)",
            rasterize_pallas(rt, sub, r.render_w, r.render_h, rp, roi=r.roi),
            dense_on_cpu(c, rt, sub, r.render_w, r.render_h, rp, r.roi),
            rt, sub, r.render_w, r.render_h, rp, r.roi)
    one = c.truth[None]
    compare("kernel vs scanline oracle (1 pose, full frame)",
            rasterize_pallas(c.full_tris, one, WIDTH, HEIGHT, c.proj),
            oracle.render_scanline(c.full_tris, one, WIDTH, HEIGHT, c.proj),
            c.full_tris, one, WIDTH, HEIGHT, c.proj)


def phase_projective(c: Ctx):
    from pose_refine import native
    from pose_refine.utils.metrics import rotation_angle_deg

    r = c.refiner
    poses = c.jax.device_put(c.poses)
    t0 = time.perf_counter()
    c.jax.block_until_ready(r.refine(poses, criteria=c.crit))
    log(f"  compile + first refine: {time.perf_counter() - t0:.1f} s")
    t, (refined, res) = median_time(lambda: r.refine(poses, criteria=c.crit))
    refined = np.asarray(refined)
    ok = rotation_angle_deg(refined, c.truth) < RECOVERED_DEG
    log(f"  batch {N_POSES}: recovered<{RECOVERED_DEG:g}deg {ok.mean():.4f}, "
        f"mean fitness {float(np.asarray(res.fitness).mean()):.4f}, "
        f"render {r.render_w}x{r.render_h} roi {r.roi}, "
        f"{r.tris.shape[0]} render tris")
    timed(f"  refine batch {N_POSES} median wall", t)
    assert ok.mean() >= MIN_RECOVERY, "most hypotheses must recover"

    cpu = c.cpu_refine(c.poses[:N_CHECK])
    failures = []
    try:
        check_against(f"GPU vs CPU ({N_CHECK} poses)", refined[:N_CHECK], cpu,
                      c.truth)
    except AssertionError as e:  # reported with the phase, after the C++ check
        failures.append(str(e))

    # the reference algorithm in C++ (native/cpu_baseline.cpp): full-mesh
    # full-res render, scan-order full cloud, projective point-to-plane ICP
    assert native.native_available(), "C++ reference unavailable (g++?)"
    dep = native.cpu_render_baseline(c.full_tris, c.poses[:N_CHECK], c.proj,
                                     WIDTH, HEIGHT)
    clouds, valids = [], []
    for d in dep:
        vs, us = np.nonzero(d > 0)
        z = d[vs, us].astype(np.float32) / 1000.0
        pts = np.stack([(us - c.K[0, 2]) / c.K[0, 0] * z,
                        (vs - c.K[1, 2]) / c.K[1, 1] * z, z], -1)[:32768]
        cl = np.zeros((32768, 3), np.float32)
        cl[:len(pts)] = pts
        v = np.zeros(32768, bool)
        v[:len(pts)] = True
        clouds.append(cl)
        valids.append(v)
    T, _, _ = native.cpu_icp_baseline(
        np.stack(clouds), np.stack(valids), np.asarray(r.scene.pcd),
        np.asarray(r.scene.normal), c.K)
    T[:, :3, 3] *= 1000.0
    ref = np.einsum("nij,njk->nik", T, c.poses[:N_CHECK])
    v_ref = rotation_angle_deg(ref, c.truth) < RECOVERED_DEG
    agree = float((v_ref == ok[:N_CHECK]).mean())
    log(f"  verdict agreement with the C++ reference algorithm: {agree:.3f} "
        f"({int(v_ref.sum())}/{N_CHECK} vs {int(ok[:N_CHECK].sum())}/{N_CHECK})")
    assert agree >= MIN_AGREEMENT, "verdicts differ from the reference algorithm"
    assert not failures, failures


def phase_nn(c: Ctx):
    from pose_refine import platform
    from pose_refine.utils.metrics import rotation_angle_deg

    poses = c.jax.device_put(c.poses)
    cpu_cache = {}
    c.nn_times = {}
    for kind in ("nn", "nn_bruteforce"):
        for vox in (2.0, 0.0):
            r = c.make_refiner(scene=kind, scene_voxel_mm=vox)
            backend = r.scene.backend
            t0 = time.perf_counter()
            c.jax.block_until_ready(r.refine(poses, criteria=c.crit))
            comp = time.perf_counter() - t0
            t, (refined, _) = median_time(
                lambda: r.refine(poses, criteria=c.crit), iters=3)
            c.nn_times[(backend, vox)] = t
            ok = rotation_angle_deg(np.asarray(refined), c.truth) < RECOVERED_DEG
            peak = (c.gpu.memory_stats() or {}).get("peak_bytes_in_use", -1)
            log(f"  scene={kind} ({backend}), voxel {vox:g} mm, "
                f"{r.scene.points.shape[0]} scene pts: recovered "
                f"{ok.mean():.4f}, compile+first {comp:.1f} s, peak device "
                f"memory {peak / 2**30:.2f} GiB")
            timed(f"  refine batch {N_POSES} scene={kind} voxel {vox:g}", t)
            if vox not in cpu_cache:
                # the CPU's own exact NN backend (kd): the same neighbours
                cpu_cache[vox] = c.cpu_refine(
                    c.poses[:N_CHECK],
                    scene="nn_" + platform.nn_backend("cpu"),
                    scene_voxel_mm=vox)
            check_against(f"{kind} voxel {vox:g} GPU vs CPU ({N_CHECK} poses)",
                          np.asarray(refined)[:N_CHECK], cpu_cache[vox],
                          c.truth)


def phase_tracking(c: Ctx):
    import pose_refine as prt
    from pose_refine import geometry
    import pose_refine.ops.rasterize as rz
    from pose_refine.utils.metrics import rotation_angle_deg

    rng = np.random.default_rng(9)
    truth = c.truth.copy()
    frames, truths = [], []
    for _ in range(12):
        drift = geometry._euler_to_rotation_np(
            rng.uniform(-0.035, 0.035, 3).astype(np.float32))
        truth = truth.copy()
        truth[:3, :3] = drift @ truth[:3, :3]
        truth[:3, 3] += rng.uniform(-5, 5, 3).astype(np.float32)
        truths.append(truth)
        frames.append(np.asarray(rz.render(
            c.full_tris, truth[None], WIDTH, HEIGHT, c.proj))[0])
    for kind, kw in (("projective", {}),
                     ("nn (device-built scene)",
                      dict(scene="nn", scene_pool=4))):
        r = c.make_refiner(**kw)
        for run in ("compile", "timed"):
            session = prt.TrackingSession(
                r, c.truth, n_hypotheses=16,
                process_noise=(np.radians(2.0), 0.005), seed=9)
            t0 = time.perf_counter()
            for f in frames:
                session.step_async(f)
            last = session.flush()
            dt = (time.perf_counter() - t0) / len(frames)
        err = float(rotation_angle_deg(last.pose, truths[-1]))
        terr = float(np.linalg.norm(last.pose[:3, 3] - truths[-1][:3, 3]))
        log(f"  tracking {kind}: 12 frames, final error {err:.4f} deg / "
            f"{terr:.3f} mm, rejected {session.n_rejected}")
        timed(f"  tracking {kind} per frame (pipelined, 16 hypotheses)", dt)
        assert err < RECOVERED_DEG and terr < 10.0, f"tracking {kind} lost"


def phase_timing(c: Ctx):
    import pose_refine.ops.rasterize as rz
    from pose_refine.ops.rasterize_pallas import rasterize_pallas

    tris = c.full_tris
    # the reference's render workloads: batch 100 full frame, and its
    # ROI {160, 80, 320, 240} repeat (cuda_renderer/test.cpp:63-157)
    roi_ref = (WIDTH // 4, HEIGHT // 6, WIDTH // 2, HEIGHT // 2)
    for n, roi in ((100, (0, 0, 0, 0)), (N_POSES, (0, 0, 0, 0)), (100, roi_ref)):
        batch = c.jax.device_put(np.tile(c.truth, (n, 1, 1)))
        tk, dk = median_time(lambda: rasterize_pallas(
            tris, batch, WIDTH, HEIGHT, c.proj, roi=roi))
        ts, ds = median_time(lambda: rz.rasterize_scatter(
            tris, batch, WIDTH, HEIGHT, c.proj, roi=roi))
        same = float((np.asarray(dk) != np.asarray(ds)).mean())
        log(f"  render batch {n} roi {roi}: kernel {tk * 1e3:.3f} ms vs "
            f"rasterize_scatter {ts * 1e3:.3f} ms (x{ts / tk:.2f}), pixels "
            f"differing {same:.2e}  [{CARD}]")

    poses = c.jax.device_put(c.poses)
    r_scatter = c.make_refiner(use_pallas=False)
    for _ in range(2):  # alternate to spread drift over both arms
        tk, _ = median_time(lambda: c.refiner.refine(poses, criteria=c.crit))
        ts, _ = median_time(lambda: r_scatter.refine(poses, criteria=c.crit))
        log(f"  refine batch {N_POSES}: kernel pipeline {tk * 1e3:.3f} ms vs "
            f"scatter pipeline {ts * 1e3:.3f} ms (x{ts / tk:.2f})  [{CARD}]")

    for vox in (2.0, 0.0):
        r = c.make_refiner(scene="nn_kdtree", scene_voxel_mm=vox)
        tkd, _ = median_time(lambda: r.refine(poses, criteria=c.crit), iters=1)
        tbf = c.nn_times.get(("bruteforce", vox))
        log(f"  NN refine batch {N_POSES} voxel {vox:g}: _nn_kdtree "
            f"{tkd * 1e3:.3f} ms vs _nn_bruteforce "
            f"{tbf * 1e3 if tbf else float('nan'):.3f} ms  [{CARD}]")


def phase_multichip(c: Ctx, n_dev: int):
    """The data-parallel path (PoseRefiner(devices=n)) against devices=1:
    refine at a divisible and a non-divisible batch, track() projective
    and NN, one MultiObjectSession step. Tolerances as
    __graft_entry__.dryrun_multichip; every comparison is reported before
    the phase fails."""
    import pose_refine as prt
    from pose_refine import mesh

    assert len(c.jax.devices()) >= n_dev, f"{n_dev} devices needed"
    failures = []

    def close(name, got, want, atol):
        err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        log(f"  {name}: devices={n_dev} vs 1 max |diff| {err:.3e} (atol {atol:g})")
        if not err <= atol:
            failures.append(f"{name}: {err} > {atol}")

    for n in (N_POSES, N_POSES + 2):
        poses = np.concatenate([c.poses, c.poses[:n - N_POSES]])
        out = {}
        for d in (n_dev, 1):
            r = c.make_refiner(devices=d)
            t, (refined, res) = median_time(
                lambda: r.refine(poses, criteria=c.crit), iters=3)
            timed(f"  refine batch {n} devices={d}", t)
            out[d] = (np.asarray(refined), np.asarray(res.fitness))
        close(f"refine batch {n} poses", out[n_dev][0], out[1][0], 1e-5)
        close(f"refine batch {n} fitness", out[n_dev][1], out[1][1], 1e-6)

    for kind in ("projective", "nn"):
        res = {}
        for d in (n_dev, 1):
            r = c.make_refiner(devices=d, scene=kind, scene_pool=4)
            t_out, fit = r.track(c.scene_depth, c.poses, criteria=c.crit)
            res[d] = (np.asarray(t_out), np.asarray(fit.fitness))
        close(f"track {kind} poses", res[n_dev][0], res[1][0], 5e-3)
        close(f"track {kind} fitness", res[n_dev][1], res[1][1], 1e-2)

    m2 = mesh.make_icosphere(radius=40.0, subdivisions=3)
    steps = {}
    for d in (n_dev, 1):
        mm = prt.MultiModelRefiner([c.model, m2], K=c.K, width=WIDTH,
                                   height=HEIGHT, devices=d, **CFG)
        mm.set_scene_depth(c.scene_depth)
        session = prt.MultiObjectSession(
            mm, [(0, c.poses[0]), (1, c.poses[1])], n_hypotheses=8, seed=7)
        steps[d] = np.stack([s_.pose for s_ in session.step(c.scene_depth)])
    close("MultiObjectSession step poses", steps[n_dev], steps[1], 5e-3)
    assert not failures, failures


PHASES = {
    "rasterizer": phase_rasterizer,
    "projective": phase_projective,
    "nn": phase_nn,
    "tracking": phase_tracking,
    "timing": phase_timing,
}


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel path on four cards")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    import jax

    from pose_refine import platform

    platform.enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU - JAX found {devs[0].platform} "
              f"({devs[0].device_kind})", file=sys.stderr)
        return 2
    CARD = platform.gpu_card()
    log(f"device: {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    log(f"card: {CARD}")

    t0 = time.perf_counter()
    c = Ctx()
    log(f"setup (mesh, scene render, refiner) {time.perf_counter() - t0:.1f} s")
    if args.chips > 1:
        phases = {"multichip": lambda c: phase_multichip(c, args.chips)}
    else:
        names = [p for p in args.phases.split(",") if p]
        phases = {p: PHASES[p] for p in names}
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn(c)
            log(f"== phase {name} OK in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"== phase {name} FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
