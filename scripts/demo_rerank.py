"""BASELINE config 5: end-to-end LINEMOD-style refinement - render a cloud of
pose hypotheses, refine each with projective ICP, score by fitness/rmse, and
re-rank (the detect -> refine -> select pipeline the reference serves).

Prints the rank-1 pose error vs ground truth; PASS iff the re-ranked winner
is within 3 degrees / 6 mm even though most hypotheses start far away.
"""
import sys

import numpy as np


def main():
    import jax

    from pose_refine.platform import enable_compile_cache


    enable_compile_cache()
    import jax.numpy as jnp

    import pose_refine as prt
    from pose_refine import geometry, mesh
    from jax import block_until_ready as sync
    from pose_refine.utils.timer import Timer

    W, H, N = 640, 480, 256
    model = mesh.load_benchmark_model(verbose=False)
    K = geometry.LINEMOD_K

    R1 = np.array(
        [[0.34768538, 0.93761126, 0.0],
         [0.70540612, -0.26157897, -0.65877056],
         [-0.61767070, 0.22904489, -0.75234390]], np.float32)
    truth = np.asarray(geometry.pose_from_Rt(R1, np.array([0, 0, 300], np.float32)))

    # a detector's hypothesis cloud: wide perturbations, many beyond the
    # single-shot ICP basin (up to ~30 deg / 40 mm)
    rng = np.random.default_rng(7)
    d_rot = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)))
    hyps = np.asarray(geometry.pose_from_Rt(
        jnp.einsum("nij,jk->nik", d_rot, truth[:3, :3]),
        truth[:3, 3] + rng.uniform(-40, 40, (N, 3)).astype(np.float32)))

    renderer = prt.PoseRenderer(model, K=K, width=W, height=H)
    scene_depth = np.asarray(sync(renderer.render_depth(truth)))[0].astype(np.int32)

    refiner = prt.PoseRefiner(model, K=K, width=W, height=H, max_points=8192)
    refiner.set_scene_depth(scene_depth)

    t = Timer()
    refined, results = refiner.refine(jax.device_put(jnp.asarray(hyps)))
    refined = np.asarray(sync(refined))
    t.out(f"refine + score {N} hypotheses (compile + run)")

    order = prt.PoseRefiner.rank(results)
    best = refined[order[0]]
    fit = np.asarray(results.fitness)

    Rr = best[:3, :3] @ truth[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(Rr) - 1) / 2, -1, 1)))
    terr = np.abs(best[:3, 3] - truth[:3, 3]).max()
    print(f"hypotheses: {N}, fitness range [{fit.min():.3f}, {fit.max():.3f}]")
    print(f"rank-1 fitness {fit[order[0]]:.4f}, rmse {float(np.asarray(results.inlier_rmse)[order[0]])*1000:.2f} mm")
    print(f"rank-1 pose error vs truth: {ang:.3f} deg, {terr:.2f} mm")
    ok = ang < 3.0 and terr < 6.0
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
