"""End-to-end demo: the reference's acceptance scenario (test.cpp:10-193).

Renders the benchmark model at a ground-truth pose and a 10 deg/axis + 20 mm
perturbed pose, builds both scene types from the perturbed render, runs
point-to-plane ICP from the ground-truth render's cloud, and prints the
recovered per-axis angle error in degrees - the same report the reference
demo prints (test.cpp:177-192).

Usage: PYTHONPATH=. python scripts/demo.py [--scene projective|nn] [--res 640x480]
"""

import argparse
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="nn", choices=["projective", "nn", "nn_bruteforce"])
    ap.add_argument("--res", default="640x480")
    ap.add_argument("--model", default=None, help="path to a PLY (default: benchmark mesh)")
    args = ap.parse_args()
    width, height = (int(v) for v in args.res.split("x"))

    import jax

    from pose_refine.platform import enable_compile_cache


    enable_compile_cache()
    import jax.numpy as jnp

    import pose_refine as prt
    from pose_refine import geometry, mesh
    from pose_refine.utils.timer import Timer
    from jax import block_until_ready as sync

    print(f"device: {jax.devices()[0].device_kind}")
    model = mesh.Model.load(args.model) if args.model else mesh.load_benchmark_model(verbose=True)

    K = geometry.LINEMOD_K.copy()
    K[:2] *= width / 640.0
    renderer = prt.PoseRenderer(model, K=K, width=width, height=height)

    # ground truth + known perturbation (test.cpp:29-44)
    R_ren = np.array(
        [
            [0.34768538, 0.93761126, 0.0],
            [0.70540612, -0.26157897, -0.65877056],
            [-0.61767070, 0.22904489, -0.75234390],
        ],
        np.float32,
    )
    ang = np.float32(10.0 / 180.0 * 3.14)
    print(f"init angle diff per axis: {np.degrees(ang):.2f} deg\n")
    rot = np.asarray(geometry.euler_to_rotation(np.array([ang] * 3)))
    pose1 = np.asarray(geometry.pose_from_Rt(R_ren, np.array([0, 0, 300], np.float32)))
    pose2 = np.asarray(
        geometry.pose_from_Rt(rot @ R_ren, np.array([20, 20, 320], np.float32))
    )

    timer = Timer()
    depth = np.asarray(sync(renderer.render_depth(np.stack([pose1, pose2]))))
    timer.out("render both poses")

    b1, b2 = prt.get_bbox(depth[0]), prt.get_bbox(depth[1])
    print(f"bbox pose1: {b1}\nbbox pose2: {b2}")
    print(f"init pixel diff xy: {abs(b1[0]-b2[0])}----{abs(b1[1]-b2[1])}\n")

    scene_kind = args.scene if args.scene != "nn" else (
        "nn"
    )
    refiner = prt.PoseRefiner(model, K=K, width=width, height=height, scene=scene_kind)
    timer.reset()
    refiner.set_scene_depth(depth[1].astype(np.int32))
    timer.out(f"init scene ({scene_kind})")

    refined, result = refiner.refine(pose1)
    sync(refined)
    timer.out("refine (render + depth2cloud + ICP, one jitted program)")

    T = np.asarray(result.transformation)
    euler = np.asarray(geometry.rotation_to_euler(T[:3, :3]))

    print("result:")
    print(f"  fitness: {float(result.fitness):.6f}")
    print(f"  inlier rmse: {float(result.inlier_rmse):.6f} m")
    print("  icp transform:")
    for row in T:
        print("   ", " ".join(f"{v:9.5f}" for v in row))
    print("\nerror in degree:")
    for axis, e in zip("xyz", np.abs(euler - ang) / np.pi * 180.0):
        print(f"  {axis}: {e:.4f}")

    ok = (np.abs(euler - ang) / np.pi * 180.0 < 1.5).all()
    print("\nPASS" if ok else "\nFAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
