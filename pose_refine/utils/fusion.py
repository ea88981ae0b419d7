"""Temporal pose fusion: an error-state filter on SE(3) (beyond parity).

Closes the loop that `icp.pose_information` / `icp.pose_covariance` open:
per-frame refinement gives a pose MEASUREMENT with a 6x6 Laplace covariance;
a tracking loop wants those measurements fused over time - smoothing jitter,
carrying the pose through bad frames, and rejecting outlier refinements
(e.g. an ICP that latched onto the wrong basin) by innovation gating. The
reference has no analog (its tracking story is "feed the refined pose back
as the next hypothesis", test.cpp usage); this module is the standard
left-invariant error-state Kalman filter on SE(3), host-side numpy (the
per-frame work is 6x6 algebra - a device dispatch would cost far more than
the math).

Conventions (matching the refinement pipeline):
  * poses are model->camera (4, 4) with MILLIMETER translations
    (pipeline.py rescales the ICP transform to mm before composing).
  * twists are [omega (rad), t (m)] in the CAMERA frame, applied by LEFT
    multiplication: pose' = exp(xi) @ pose - exactly the space
    `pose_information` measures in (icp.py: A-row [p x n, n] twist order).
  * covariances are 6x6 in that twist space (what `pose_covariance`
    returns).

The motion model is a pose random walk with per-frame process noise Q;
constant-velocity or IMU-driven prediction can be layered by calling
`predict(T_motion, Q)` with an externally predicted increment.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9
# millimeters (library pose convention) <-> meters (twist convention)
_MM = 1000.0


def _skew(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
        dtype=np.float64,
    )


def se3_exp(xi):
    """Exact SE(3) exponential map: xi = [omega (rad), t] -> (4, 4).

    Rodrigues rotation + the standard V matrix for the translation
    (closed-form series for small angles). Unlike geometry.twist_to_mat4
    (the solver's Rz*Ry*Rx Euler composition, faithful to the reference's
    icp.cpp:7-17), this is the true exponential - required for the
    filter's log/exp consistency; the two agree to second order in the
    small angles the filter handles.
    """
    xi = np.asarray(xi, np.float64)
    w, t = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    W = _skew(w)
    if th < 1e-7:
        R = np.eye(3) + W + 0.5 * (W @ W)
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / (th * th)
        c = (1.0 - a) / (th * th)
        R = np.eye(3) + a * W + b * (W @ W)
        V = np.eye(3) + b * W + c * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ t
    return T


def se3_log(T):
    """Exact SE(3) logarithm: (4, 4) -> [omega (rad), t] (inverse of
    se3_exp; valid for rotation angles < pi)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(cos))
    if th < 1e-7:
        W = 0.5 * (R - R.T)
        w = np.array([W[2, 1], W[0, 2], W[1, 0]])
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
    else:
        if np.pi - th < 1e-6:
            raise ValueError(
                f"se3_log: rotation angle {np.degrees(th):.2f} deg too "
                "close to 180 (log is not unique there)"
            )
        W = (th / (2.0 * np.sin(th))) * (R - R.T)
        w = np.array([W[2, 1], W[0, 2], W[1, 0]])
        half = th / 2.0
        # V^-1 closed form
        Vinv = (
            np.eye(3)
            - 0.5 * W
            + (1.0 - half / np.tan(half)) / (th * th) * (W @ W)
        )
    return np.concatenate([w, Vinv @ T[:3, 3]])


def se3_adjoint(T):
    """Adjoint of T=(R, t) on twists ordered [omega, v]:
    Ad (w, v) = (R w, [t]x R w + R v). Transports left-error twists across
    a left-applied motion: T' = Tm T  =>  e' = Ad_{Tm} e."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[3:, 3:] = R
    Ad[3:, :3] = _skew(t) @ R
    return Ad


# chi-square 0.99 quantile, 6 dof - the default innovation gate
CHI2_6_99 = 16.81


class PoseTracker:
    """Left-invariant error-state Kalman filter over one object's pose.

    Usage in a tracking loop (measured end-to-end in scripts/fusion_study.py):

        tracker = PoseTracker(first_pose_mm, init_cov=cov0)
        for frame in frames:
            tracker.predict()                      # random-walk diffusion
            refined, results, unc = refiner.track(
                frame, tracker.hypotheses(n), with_covariance=True)
            best = refiner.rank(results)[0]        # unc: icp.PoseUncertainty,
            tracker.update(np.asarray(refined)[best],   # fused in-program
                           np.asarray(unc.covariance)[best])
            pose = tracker.pose_mm                  # fused estimate

    (The standalone icp.pose_information/pose_covariance pair computes the
    same 6x6 R outside the pipeline - at ~20 eager dispatches per frame;
    with_covariance=True folds it into the one fused
    program, scripts/fusion_study.py measures both.)

    Args:
      pose_mm:   initial (4, 4) model->camera pose, translation in mm.
      init_cov:  initial 6x6 twist covariance [rad, m]; defaults to a
                 diffuse prior (5 deg, 20 mm std).
      process_noise: per-predict() diffusion - either a full 6x6 Q or a
                 (rot_std_rad, trans_std_m) pair for isotropic noise;
                 defaults to (1 deg, 5 mm) per frame.
    """

    def __init__(self, pose_mm, init_cov=None, process_noise=None):
        self._T = self._to_m(pose_mm)
        self._T_prev = None  # previous frame's estimate (predict_cv)
        if init_cov is None:
            init_cov = np.diag([np.radians(5.0) ** 2] * 3 + [0.02**2] * 3)
        self.P = np.asarray(init_cov, np.float64).copy()
        if self.P.shape != (6, 6):
            raise ValueError(f"init_cov must be 6x6, got {self.P.shape}")
        if process_noise is None:
            process_noise = (np.radians(1.0), 0.005)
        self.Q = self._as_Q(process_noise)
        self.n_rejected = 0

    @staticmethod
    def _as_Q(process_noise):
        q = np.asarray(process_noise, np.float64)
        if q.shape == (6, 6):
            return q.copy()
        if q.shape == (2,):
            return np.diag([q[0] ** 2] * 3 + [q[1] ** 2] * 3)
        raise ValueError(
            "process_noise must be a 6x6 matrix or (rot_std_rad, "
            f"trans_std_m), got shape {q.shape}"
        )

    @staticmethod
    def _to_m(pose_mm):
        T = np.asarray(pose_mm, np.float64).copy()
        if T.shape != (4, 4):
            raise ValueError(f"pose must be (4, 4), got {T.shape}")
        T[:3, 3] /= _MM
        return T

    @staticmethod
    def _to_mm(T):
        out = T.copy()
        out[:3, 3] *= _MM
        return out.astype(np.float32)

    @property
    def pose_mm(self):
        """Current fused (4, 4) pose, translation in mm (float32, like the
        pipeline's poses)."""
        return self._to_mm(self._T)

    def predict(self, T_motion_mm=None, Q=None):
        """Time update. Default: pose random walk (state unchanged,
        covariance grows by Q). Pass T_motion_mm (a LEFT-applied camera-
        frame increment, mm translation) to inject an external motion
        prediction - e.g. a constant-velocity extrapolation or odometry -
        and optionally a per-call Q."""
        Tm = None if T_motion_mm is None else self._to_m(T_motion_mm)
        return self._predict_m(Tm, Q)

    def _predict_m(self, Tm, Q):
        """predict() core on a meter-translation motion increment. Every
        time update advances the one-frame velocity baseline (so coasting
        through missed measurements keeps a constant velocity, and mixing
        predict()/predict_cv() stays one-frame consistent)."""
        self._T_prev = self._T.copy()
        if Tm is not None:
            self._T = Tm @ self._T
            # left-error transport: T' = Tm T  =>  e' = Ad_{Tm} e, so the
            # covariance conjugates through the motion's adjoint (a pure
            # random walk has Tm = I and Ad = I)
            Ad = se3_adjoint(Tm)
            self.P = Ad @ self.P @ Ad.T
        self.P = self.P + (self.Q if Q is None else self._as_Q(Q))
        return self.pose_mm

    def predict_cv(self, Q=None, decay=1.0):
        """Constant-velocity time update: re-apply the left increment
        between the two most recent per-frame estimates (the velocity
        twist), then diffuse by Q. This is the standard fix for the
        fast-motion regime where a random-walk predict() forces Q up to
        the full inter-frame motion and the filter degenerates to a
        pass-through (scripts/fusion_study.py): with the motion explained
        by the model, Q only has to cover the ACCELERATION, so the gain
        stays < 1 and smoothing/gating keep their value.

        decay in [0, 1] shrinks the applied velocity (exp(decay * log(V)));
        1.0 is pure constant velocity, 0.0 degenerates to the random walk.
        Falls back to a plain random walk until two frames exist."""
        if self._T_prev is None:
            return self._predict_m(None, Q)
        try:
            vel = se3_log(self._T @ np.linalg.inv(self._T_prev))
        except ValueError:
            # inter-frame increment ~180 deg (a basin flip fused with
            # gating disabled): the velocity is not observable there -
            # degrade to the random walk instead of crashing the loop,
            # exactly like update()'s gate handles the same ambiguity
            return self._predict_m(None, Q)
        return self._predict_m(se3_exp(decay * vel), Q)

    def update(self, measured_pose_mm, cov6, gate_chi2=CHI2_6_99,
               max_innovation=None, quality=None, min_quality=None):
        """Measurement update with a refined pose + its 6x6 twist
        covariance (icp.pose_covariance output). Returns True if the
        measurement was fused, False if the innovation gate rejected it
        (pose and covariance then stay at the prediction - the standard
        defense against a refinement that latched onto a wrong basin).
        gate_chi2=None disables gating.

        max_innovation: optional (rot_rad, trans_m) HARD cap on the
        innovation twist, rejecting regardless of the claimed covariance.
        The chi-square gate trusts cov6; a refinement that failed on a
        degraded frame reports an INFLATED covariance from that same
        frame, which widens its own gate (measured: a 21 mm translation
        slip gate-passed in scripts/fusion_study.py's fast regime). The
        hard cap is the physical-limits backstop, complementing the
        statistical gate the way the reference's 0.1 m association gate
        complements robust weighting.

        quality / min_quality: optional measurement-quality gate - reject
        when quality < min_quality (NaN-safe: a non-finite quality
        rejects). Pass the refinement's own fitness (inlier fraction, the
        quantity the reference exposes exactly for acceptance decisions,
        icp.h:26-36): the covariance gates above trust the measurement's
        self-reported statistics, which a refinement on a degraded frame
        inflates in its own favor; the fitness gate is an INDEPENDENT
        signal (a corrupt frame's dropout crashes the inlier fraction
        regardless of what the residual variance claims). Measured in
        scripts/fusion_study.py's fast regime (min_quality=0.6):
        corrupted frames score best-hypothesis fitness 0.07-0.15 vs
        >=0.835 on every clean frame, and the gate cuts the one
        covariance slip that chi-square-passed from t max 27.8 mm to
        4.7 mm (all 4 corrupt frames rejected)."""
        R = np.asarray(cov6, np.float64)
        if R.shape != (6, 6):
            raise ValueError(f"cov6 must be 6x6, got {R.shape}")
        if min_quality is not None:
            if quality is None:
                raise ValueError("min_quality set but no quality passed")
            # reject-unless-provably-inside, like the other gates
            if not (float(quality) >= float(min_quality)):
                self.n_rejected += 1
                return False
        T_meas = self._to_m(measured_pose_mm)
        # innovation: the left twist carrying prediction -> measurement
        try:
            e = se3_log(T_meas @ np.linalg.inv(self._T))
        except ValueError:
            # relative rotation ~180 deg: the log is not unique there, and
            # such a measurement is the canonical wrong-basin outlier the
            # gate exists to reject - treat it as an automatic rejection
            # rather than crashing the tracking loop
            if gate_chi2 is not None or max_innovation is not None:
                self.n_rejected += 1
                return False
            raise
        if max_innovation is not None:
            rot_cap, trans_cap = max_innovation
            rot_mag = float(np.linalg.norm(e[:3]))
            trans_mag = float(np.linalg.norm(e[3:]))
            # reject-unless-provably-inside (NaN-safe, like the chi2 gate)
            if not (rot_mag <= rot_cap and trans_mag <= trans_cap):
                self.n_rejected += 1
                return False
        S = self.P + R
        Sinv = np.linalg.inv(S)
        if gate_chi2 is not None:
            chi2 = float(e @ Sinv @ e)
            # reject-unless-provably-inside: a NaN chi2 (diverged refinement
            # handing in a non-finite pose) must REJECT, and 'nan > gate' is
            # False - so test acceptance, not rejection
            if not (chi2 <= gate_chi2):
                self.n_rejected += 1
                return False
        K = self.P @ Sinv
        self._T = se3_exp(K @ e) @ self._T
        IK = np.eye(6) - K
        # Joseph form: symmetric + positive-definite under roundoff
        self.P = IK @ self.P @ IK.T + K @ R @ K.T
        return True

    def state_dict(self):
        """Exact filter state as plain arrays (utils.serialization hooks
        into this for checkpoint/resume of long-lived tracking loops).
        ``T_m`` is the internal float64 meter-translation pose - full
        precision, unlike the float32 ``pose_mm`` view."""
        state = {
            "T_m": self._T.copy(),
            "P": self.P.copy(),
            "Q": self.Q.copy(),
            "n_rejected": int(self.n_rejected),
        }
        if self._T_prev is not None:  # predict_cv velocity baseline
            state["T_prev"] = self._T_prev.copy()
        return state

    @classmethod
    def from_state(cls, state):
        """Inverse of :meth:`state_dict` (bit-exact resume)."""
        self = cls.__new__(cls)
        self._T = np.asarray(state["T_m"], np.float64).copy()
        self._T_prev = (np.asarray(state["T_prev"], np.float64).copy()
                        if state.get("T_prev") is not None else None)
        self.P = np.asarray(state["P"], np.float64).copy()
        self.Q = np.asarray(state["Q"], np.float64).copy()
        self.n_rejected = int(state["n_rejected"])
        if self._T.shape != (4, 4) or self.P.shape != (6, 6) or self.Q.shape != (6, 6):
            raise ValueError(
                "PoseTracker state must have T_m (4,4), P (6,6), Q (6,6); "
                f"got {self._T.shape}, {self.P.shape}, {self.Q.shape}"
            )
        if self._T_prev is not None and self._T_prev.shape != (4, 4):
            raise ValueError(
                f"PoseTracker state T_prev must be (4,4), got {self._T_prev.shape}"
            )
        return self

    def hypotheses(self, n: int, scale: float = 1.0, seed=None):
        """Sample n pose hypotheses from the current belief - the bridge
        back into the refiner (replaces geometry.sample_hypotheses' fixed
        jitter with the filter's own uncertainty; scale widens/narrows).
        Row 0 is always the mean pose."""
        rng = np.random.default_rng(seed)
        # sqrtm via eigh (P is symmetric PSD)
        lam, U = np.linalg.eigh(self.P)
        L = U @ np.diag(np.sqrt(np.maximum(lam, 0.0)))
        out = [self._T]
        for _ in range(max(0, int(n) - 1)):
            xi = scale * (L @ rng.standard_normal(6))
            out.append(se3_exp(xi) @ self._T)
        return np.stack([self._to_mm(T) for T in out])
