"""Calibration property-test for the reported pose uncertainty: render
perturbed frames, refine, and assert the
empirical error distribution is COVERED by the reported covariances - NEES
(e^T R^-1 e, ~chi2_6 when R is calibrated) must stay inside loose chi-square
bands. Pins the round-4 calibration (icp.RENDER_COV_INFLATION sigma2 floor +
the session ensemble term) so a re-introduced overconfident R fails loudly:
the raw round-3 Laplace scored NEES mean 84-384 here (calibrated ~6), which
collapsed the tracking filter's P and gate-rejected every honest frame
(tests/test_tracking.py::test_multi_object_session_tracks_both was red).

Full sweep with per-DOF diagnostics: scripts/uncertainty_calibration_study.py.
"""
import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, icp, mesh
from pose_refine.tracking import _ensemble_cov
from pose_refine.utils import fusion

W, H = 160, 120
N_FRAMES = 8
N_HYP = 3
# chi2_6 quantiles: mean 6; the assertions are deliberately loose ONE-SIDED
# coverage bands (overconfidence is the divergence mode; mild conservatism
# only slows the filter). 8 frames x p95-ish slack => mean in [0.15, 30].
NEES_MEAN_MAX = 30.0
NEES_MEAN_MIN = 0.15


def _to_m(T):
    out = np.asarray(T, np.float64).copy()
    out[:3, 3] /= 1000.0
    return out


def _run_track(m, render_scale, seed):
    """Refine jittered hypotheses against rendered frames of a drifting
    truth; return per-frame (true error twist, effective session R)."""
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    refiner = prt.PoseRefiner(
        m, K=K, width=W, height=H, max_points=4096, use_pallas=False,
        window=96, stride=1, render_scale=render_scale)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3, :3] = np.asarray(
        geometry.euler_to_rotation(np.float32([0.4, -0.3, 0.2])))
    pose0[:3, 3] = [10.0, -5.0, 300.0]

    rng = np.random.default_rng(seed)
    truth = pose0.copy()
    out = []
    for _ in range(N_FRAMES):
        d = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.015, 0.015, 3).astype(np.float32)))
        truth = np.asarray(geometry.pose_from_Rt(
            d @ truth[:3, :3],
            truth[:3, 3] + rng.uniform(-2.0, 2.0, 3).astype(np.float32)))
        depth = np.asarray(r.render_depth(truth))[0].astype(np.int32)
        hyps = []
        for _h in range(N_HYP):
            xi = np.concatenate([rng.normal(0.0, np.radians(1.5), 3),
                                 rng.normal(0.0, 0.003, 3)])
            hyps.append(fusion.se3_exp(xi) @ _to_m(truth))
        hyps = np.stack(hyps)
        hyps[:, :3, 3] *= 1000.0
        refined, results, unc = refiner.track(
            depth, hyps.astype(np.float32), with_covariance=True)
        refined = np.asarray(refined)
        fit = np.asarray(results.fitness)
        best = int(prt.PoseRefiner.rank(
            icp.RegistrationResult(
                np.asarray(results.transformation), fit,
                np.asarray(results.inlier_rmse)))[0])
        R = np.asarray(unc.covariance, np.float64)[best]
        R = R + _ensemble_cov(refined, fit, best,
                              np.asarray(results.inlier_rmse))
        e = fusion.se3_log(_to_m(refined[best]) @ np.linalg.inv(_to_m(truth)))
        out.append((e, R))
    return out


# default profile runs (ico, rs1) - the round-3 divergence trigger - and
# (bumpy, rs2) - the lateral-quantization-floor pin; the other two corners
# are `slow` (each config costs ~20 s of dense CPU renders)
@pytest.mark.parametrize("shape,render_scale", [
    pytest.param("bumpy", 1, marks=pytest.mark.slow),
    ("bumpy", 2),
    ("ico", 1),
    pytest.param("ico", 2, marks=pytest.mark.slow),
])
def test_nees_within_chisquare_bands(shape, render_scale):
    if shape == "bumpy":  # every DOF observable
        m = mesh.make_bumpy_sphere(radius=40.0, subdivisions=3)
    else:  # rotation DOFs nearly unobservable - the r3 divergence trigger
        m = mesh.make_icosphere(radius=30.0, subdivisions=3)
    frames = _run_track(m, render_scale, seed=17)
    nees = np.asarray([float(e @ np.linalg.solve(R, e)) for e, R in frames])
    assert np.isfinite(nees).all()
    assert nees.mean() < NEES_MEAN_MAX, (
        f"overconfident covariance: NEES mean {nees.mean():.1f} "
        f"(calibrated ~6) - the round-3 filter-divergence mode")
    assert nees.mean() > NEES_MEAN_MIN, (
        f"absurdly underconfident covariance: NEES mean {nees.mean():.2f}")
    # tail: no frame may be catastrophically outside its own covariance
    assert nees.max() < 12 * NEES_MEAN_MAX
