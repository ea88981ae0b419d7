"""Calibration study for the fused PoseUncertainty measurement covariance.

The Laplace covariance
sigma2 * inv(J^T J) computed from the final fit residuals claimed
trace(R) ~ 1e-4 while the actual per-frame measurement error of the whole
pipeline (render quantization + weakly-constrained rotation DOFs) was
3-5 deg / tens of mm on a near-symmetric icosphere at 160x120 renders.
The filter then collapsed P after one overconfident update and chi-square
gate-rejected every subsequent honest measurement - textbook divergence by
underestimated R (tests/test_tracking.py::test_multi_object_session_
tracks_both was the red test).

This study measures the TRUE error distribution of refined poses against
the reported covariance, per DOF and as NEES (normalized estimation error
squared, e^T R^-1 e ~ chi2_6 when R is calibrated):

  for each frame: drift truth, render, jitter hypotheses around truth
  (the filter-belief scatter a tracking loop would sample), refine with
  with_covariance=True, take the best-ranked row, and compare
  e = log(T_meas @ inv(T_truth)) against the reported R.

Configs: a bumpy sphere (well-constrained: every DOF observable) and an
icosphere (rotation DOFs nearly unobservable - the divergence trigger),
each at two hypothesis-jitter levels.

Run (CPU is fine - dense 160x120 renders):
    PYTHONPATH=. python scripts/uncertainty_calibration_study.py
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.utils import fusion

W, H = 160, 120
N_FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 20
N_HYP = 3


def to_m(T):
    out = np.asarray(T, np.float64).copy()
    out[:3, 3] /= 1000.0
    return out


def run(name, m, jitter_rot, jitter_trans_mm, seed=0):
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=8192,
                              use_pallas=False, window=96, stride=1)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3, :3] = np.asarray(geometry.euler_to_rotation(
        np.float32([0.4, -0.3, 0.2])))
    pose0[:3, 3] = [10.0, -5.0, 300.0]

    rng = np.random.default_rng(seed)
    truth = pose0.copy()
    errs, nees, rep_std = [], [], []
    covs, ens_covs = [], []
    for _ in range(N_FRAMES):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.015, 0.015, 3).astype(np.float32)))
        truth = np.asarray(geometry.pose_from_Rt(
            d @ truth[:3, :3],
            truth[:3, 3] + rng.uniform(-2.0, 2.0, 3).astype(np.float32)))
        depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        refiner.set_scene_depth(depth)
        # hypotheses: truth jittered by the filter-belief scatter
        hyps = []
        for _h in range(N_HYP):
            xi = np.concatenate([
                rng.normal(0.0, jitter_rot, 3),
                rng.normal(0.0, jitter_trans_mm / 1000.0, 3)])
            hyps.append(fusion.se3_exp(xi) @ to_m(truth))
        hyps = np.stack(hyps)
        hyps[:, :3, 3] *= 1000.0
        refined, results, unc = refiner.refine(
            hyps.astype(np.float32), with_covariance=True)
        refined = np.asarray(refined)
        fit = np.asarray(results.fitness)
        rmse = np.asarray(results.inlier_rmse)
        best = int(np.lexsort((rmse, -fit))[0])
        R = np.asarray(unc.covariance, np.float64)[best]
        e = fusion.se3_log(to_m(refined[best]) @ np.linalg.inv(to_m(truth)))
        errs.append(e)
        nees.append(float(e @ np.linalg.solve(R, e)))
        rep_std.append(np.sqrt(np.diag(R)))
        covs.append(R)
        # ensemble scatter: converged hypotheses about the best (the
        # candidate empirical per-frame covariance floor)
        inv_best = np.linalg.inv(to_m(refined[best]))
        es = [fusion.se3_log(to_m(refined[i]) @ inv_best)
              for i in range(len(refined)) if i != best and fit[i] > 0.5]
        if es:
            es = np.asarray(es)
            ens_covs.append(es.T @ es / len(es))
        else:
            ens_covs.append(np.zeros((6, 6)))
    errs = np.asarray(errs)
    rep_std = np.asarray(rep_std)
    nees = np.asarray(nees)
    emp_rot = np.sqrt(np.mean(errs[:, :3] ** 2, axis=0))
    emp_t = np.sqrt(np.mean(errs[:, 3:] ** 2, axis=0))
    rep_rot = rep_std[:, :3].mean(axis=0)
    rep_t = rep_std[:, 3:].mean(axis=0)
    print(f"\n== {name} (jitter {np.degrees(jitter_rot):.1f} deg / "
          f"{jitter_trans_mm:.0f} mm, {N_FRAMES} frames) ==")
    print(f"  empirical rot err std  [deg]: {np.degrees(emp_rot)}")
    print(f"  reported  rot std      [deg]: {np.degrees(rep_rot)}")
    print(f"  empirical trans err std [mm]: {emp_t * 1000}")
    print(f"  reported  trans std     [mm]: {rep_t * 1000}")
    print(f"  NEES mean {nees.mean():.1f} (calibrated ~6), "
          f"median {np.median(nees):.1f}, p95 {np.quantile(nees, 0.95):.1f}, "
          f"max {nees.max():.1f}")
    print(f"  NEES > chi2_6_99 (16.81): "
          f"{(nees > 16.81).mean() * 100:.0f}% of frames (calibrated ~1%)")
    # candidate calibrations
    ens = np.asarray(ens_covs)
    ens_rot = np.degrees(np.sqrt(np.mean([np.diag(c)[:3] for c in ens], 0)))
    ens_t = np.sqrt(np.mean([np.diag(c)[3:] for c in ens], 0)) * 1000
    print(f"  ensemble rot scatter   [deg]: {ens_rot}")
    print(f"  ensemble trans scatter  [mm]: {ens_t}")
    for label, mk in (
        ("laplace*9", lambda R, E: 9.0 * R),
        ("laplace+ens", lambda R, E: R + E),
        ("9*laplace+ens", lambda R, E: 9.0 * R + E),
        ("9*(laplace+ens)", lambda R, E: 9.0 * (R + E)),
    ):
        nn = [float(e @ np.linalg.solve(mk(R, E) + 1e-18 * np.eye(6), e))
              for e, R, E in zip(errs, covs, ens)]
        nn = np.asarray(nn)
        print(f"  NEES[{label:>16}]: mean {nn.mean():7.1f}  median "
              f"{np.median(nn):7.1f}  p95 {np.quantile(nn, 0.95):7.1f}  "
              f">gate {(nn > 16.81).mean() * 100:3.0f}%")
    return nees


if __name__ == "__main__":
    bumpy = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    ico = mesh.make_icosphere(radius=30.0, subdivisions=3)
    for name, m in (("bumpy_sphere r40", bumpy), ("icosphere r30", ico)):
        for jr, jt in ((np.radians(1.0), 2.0), (np.radians(3.0), 6.0)):
            run(name, m, jr, jt)
