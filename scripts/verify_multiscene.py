"""End-to-end drive of the stacked multi-scene path through the PUBLIC API.

Renders K ground-truth frames of different poses, stacks them with
``set_scene_depths``, refines a mixed batch with ``scene_ids`` in ONE
dispatch, and checks every hypothesis recovered ITS OWN frame's truth.
Runs on JAX's default device (the CPU with ``--cpu``). Exits non-zero on
failure.
"""
import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--full", action="store_true",
                    help="full-res 640x480 frames (device scale)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pose_refine.platform import enable_compile_cache

    enable_compile_cache(".jax_cache_cpu" if args.cpu else ".jax_cache")

    import pose_refine as prt
    from pose_refine import geometry, mesh
    from jax import block_until_ready as sync

    print(f"device: {jax.devices()[0].device_kind}", flush=True)

    scale = 1 if args.full else 4
    W, H = 640 // scale, 480 // scale
    K = geometry.LINEMOD_K.copy()
    K[:2] /= scale
    ply = mesh.find_reference_ply()
    m = prt.Model.load(ply).mesh if ply and args.full else \
        mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    r = prt.PoseRenderer(m, K=K, width=W, height=H,
                         backend="pallas" if args.full else "dense")

    rng = np.random.default_rng(7)
    base = np.asarray(geometry.pose_from_Rt(
        np.eye(3, dtype=np.float32), np.float32([0, 0, 400])))
    truths, frames = [], []
    for k in range(4):
        d_rot = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.4, 0.4, 3).astype(np.float32)))
        t = base[:3, 3] + rng.uniform(-20, 20, 3).astype(np.float32)
        truth = np.asarray(geometry.pose_from_Rt(d_rot @ base[:3, :3], t))
        truths.append(truth)
        frames.append(np.asarray(r.render_depth(truth))[0].astype(np.int32))
    truths = np.stack(truths)
    frames = np.stack(frames)
    assert (frames > 0).any(axis=(1, 2)).all(), "a frame rendered empty"

    ref = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                          use_pallas=args.full, window=64 if not args.full
                          else "auto", stride=1, auto_roi=False)
    ref.set_scene_depths(frames)

    hyps, ids = [], []
    for k, truth in enumerate(truths):
        for _ in range(4):
            d = np.asarray(geometry.euler_to_rotation(
                rng.uniform(-0.12, 0.12, 3).astype(np.float32)))
            hyps.append(np.asarray(geometry.pose_from_Rt(
                d @ truth[:3, :3],
                truth[:3, 3] + rng.uniform(-10, 10, 3).astype(np.float32))))
            ids.append(k)
    hyps = np.stack(hyps).astype(np.float32)
    ids = np.asarray(ids, np.int32)

    t0 = time.perf_counter()
    refined, res = ref.refine(hyps, scene_ids=ids)
    sync(refined)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    refined, res = ref.refine(hyps, scene_ids=ids)
    sync(refined)
    t_warm = time.perf_counter() - t0
    refined = np.asarray(refined)

    worst_deg, worst_mm = 0.0, 0.0
    for r_pose, k in zip(refined, ids):
        cos = (np.trace(r_pose[:3, :3].T @ truths[k][:3, :3]) - 1) / 2
        deg = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        mm = np.abs(r_pose[:3, 3] - truths[k][:3, 3]).max()
        worst_deg, worst_mm = max(worst_deg, deg), max(worst_mm, mm)
    fit = float(np.min(np.asarray(res.fitness)))
    print(f"16 poses x 4 frames, one dispatch: worst {worst_deg:.2f} deg / "
          f"{worst_mm:.2f} mm, min fitness {fit:.3f}, "
          f"cold {t_cold:.2f}s warm {t_warm*1e3:.0f}ms", flush=True)
    ok = worst_deg < 4.0 and worst_mm < 4.0 and fit > 0.5
    print("VERIFY_MULTISCENE " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
