"""Seeded config-space fuzz: the refiner must behave across odd image
sizes, strides, windows, scales and scene kinds - no NaNs, no shape
errors, and small perturbations recover. Complements the targeted tests
with breadth (the reference is only ever exercised at 640x480)."""

import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh


def _case(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([96, 120, 160, 200]))
    h = int(rng.choice([80, 96, 120, 144]))
    cfg = dict(
        render_scale=int(rng.choice([1, 2])),
        stride=int(rng.choice([1, 2])),
        window=int(rng.choice([48, 64, 96])),
        max_points=int(rng.choice([1024, 2048, 4096])),
        scene=str(rng.choice(["projective", "nn_bruteforce"])),
        decimate_mm=float(rng.choice([0.0, 6.0])),
        robust_delta=float(rng.choice([0.0, 0.02])),
        coarse_iters=int(rng.choice([0, 8])),
        coarse_stride=int(rng.choice([2, 4])),
    )
    if w % cfg["render_scale"] or h % cfg["render_scale"]:
        cfg["render_scale"] = 1
    return w, h, cfg


@pytest.mark.parametrize("seed", range(8))
def test_random_config_recovers(seed):
    w, h, cfg = _case(seed)
    rng = np.random.default_rng(100 + seed)
    K = geometry.LINEMOD_K.copy()
    K[:2, :] *= np.float32([[w / 640.0], [h / 480.0]])

    m = mesh.make_bumpy_sphere(
        radius=float(rng.uniform(35, 55)), subdivisions=3,
        bump=float(rng.uniform(0.2, 0.35)))
    z = float(rng.uniform(280, 380))
    Rt = np.asarray(geometry.euler_to_rotation(
        rng.uniform(-np.pi, np.pi, 3).astype(np.float32)))
    truth = np.asarray(geometry.pose_from_Rt(Rt, np.float32([0, 0, z])))

    r = prt.PoseRenderer(m, K=K, width=w, height=h, backend="dense")
    scene_depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
    if (scene_depth > 0).sum() < 200:
        pytest.skip("object fell outside this random frame")

    refiner = prt.PoseRefiner(m, K=K, width=w, height=h, use_pallas=False, **cfg)
    refiner.set_scene_depth(scene_depth)

    hyps = prt.sample_hypotheses(truth, 3, rot_deg=5.0, trans_mm=8.0, rng=rng)
    refined, res = refiner.refine(hyps)
    refined = np.asarray(refined)
    assert np.isfinite(refined).all()
    assert np.isfinite(np.asarray(res.fitness)).all()
    assert np.isfinite(np.asarray(res.inlier_rmse)).all()

    from pose_refine.utils.metrics import rotation_angle_deg

    rot = rotation_angle_deg(refined, truth)
    t_err = np.abs(refined[:, :3, 3] - truth[:3, 3]).max(axis=(1,))
    ok = (rot < 4.0) & (t_err < 8.0)
    assert ok.sum() >= 2, (
        f"seed {seed} cfg {cfg} {w}x{h}: rot {rot}, terr {t_err}"
    )
