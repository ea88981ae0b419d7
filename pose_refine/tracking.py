"""Productized per-frame tracking: one object, one fused dispatch per frame.

``TrackingSession`` wires a :class:`~pose_refine.pipeline.PoseRefiner`
to a :class:`~pose_refine.utils.fusion.PoseTracker` with the loop and
defaults measured best end-to-end in scripts/fusion_study.py and
scripts/demo_track.py:

    predict (motion model)
      -> sample hypotheses from the filter's own belief
      -> ONE fused track() program (scene build + refinement + in-program
         measurement covariance, refine/track(with_covariance=True))
      -> rank hypotheses by (fitness, -rmse)
      -> multi-gated fusion (chi-square innovation gate + independent
         fitness quality gate [+ optional hard innovation cap])

The reference stops at per-frame refinement - its acceptance loop re-seeds
each frame from fixed jitter around the last estimate and keeps the raw
best hypothesis (/root/reference/test.cpp:29-44,96-126). Everything this
class adds on top (uncertainty, temporal fusion, gating) is beyond-parity;
the per-frame refinement underneath is exactly the reference pipeline.

All loop bookkeeping is host numpy: the only device work per step() is the
single fused track() program plus the small result readbacks (eager jnp
ops would each pay a dispatch).
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional

import numpy as np

from pose_refine import icp
from pose_refine.pipeline import MultiModelRefiner, PoseRefiner
from pose_refine.utils.fusion import CHI2_6_99, PoseTracker, se3_log

_MOTIONS = ("random_walk", "constant_velocity")


def _set_loop_config(self, motion, n_hypotheses, hypothesis_scale,
                     min_quality, gate_chi2, max_innovation,
                     from_state: bool = False):
    """Validate + assign the shared per-frame loop config - ONE definition
    for TrackingSession/MultiObjectSession x __init__/from_state (the four
    copies had already begun to drift; a corrupted state must error with
    the same invariants __init__ enforces, e.g. n_hypotheses=0 would
    resume as mean-only tracking)."""
    motion = str(motion)
    if motion not in _MOTIONS:
        raise ValueError(
            f"state has unknown motion {motion!r}" if from_state
            else f"motion must be one of {_MOTIONS}, got {motion!r}")
    if int(n_hypotheses) < 1:
        raise ValueError(
            f"{'state ' if from_state else ''}n_hypotheses must be >= 1, "
            f"got {n_hypotheses}")
    if not float(hypothesis_scale) > 0.0:
        raise ValueError(
            f"{'state ' if from_state else ''}hypothesis_scale must be "
            f"> 0, got {hypothesis_scale}")
    self.motion = motion
    self.n_hypotheses = int(n_hypotheses)
    self.hypothesis_scale = float(hypothesis_scale)
    self.min_quality = None if min_quality is None else float(min_quality)
    self.gate_chi2 = None if gate_chi2 is None else float(gate_chi2)
    self.max_innovation = (
        None if max_innovation is None
        else tuple(float(v) for v in max_innovation))


class TrackStep(NamedTuple):
    """Everything one ``TrackingSession.step`` produced.

    pose:       (4, 4) fused estimate AFTER this frame (the prediction if
                the measurement was rejected) - feed downstream consumers.
    accepted:   True if the best refinement passed every gate and was fused.
    best:       index of the winning hypothesis (into refined/results rows).
    fitness:    the winner's inlier fraction (the quality-gate signal).
    refined:    (N, 4, 4) all refined hypotheses (host numpy).
    results:    the batch RegistrationResult (fitness/inlier_rmse per row).
    covariance: (6, 6) the effective measurement covariance the filter
                fused [rad, m] twist: the winner's render-calibrated
                Laplace covariance plus the hypothesis-ensemble scatter
                term (see _ensemble_cov).
    """

    pose: np.ndarray
    accepted: bool
    best: int
    fitness: float
    refined: np.ndarray
    results: icp.RegistrationResult
    covariance: np.ndarray


def _advance_tracker(tracker: PoseTracker, motion: str, motion_mm) -> None:
    """One motion-model time update: an explicit odometry increment wins,
    else the session's configured model. THE single advance used by both
    sessions' step/step_async/fuse paths and the hypothesis-sampling
    extrapolation - they must extrapolate identically or the pipelined
    path's filter-ordering guarantee silently breaks."""
    if motion_mm is not None:
        tracker.predict(motion_mm)
    elif motion == "constant_velocity":
        tracker.predict_cv()
    else:
        tracker.predict()


def _unpack_outputs(buf: np.ndarray, has_np: bool):
    """Host-side inverse of pipeline._pack_track_outputs' (N, 71) session
    buffer ([refined 16 | transformation 16 | fitness | rmse | n_points |
    cov 36]): (refined, results, cov f64). Every np.asarray is a separate
    device-to-host copy and fence - six per frame would make the tracking
    loop host-readback-bound. One packed pull is one - and since the packing is traced INTO the
    fused track program (pack_outputs=True), a session frame is exactly one
    enqueued program plus this one readback."""
    n = buf.shape[0]
    results_np = icp.RegistrationResult(
        transformation=buf[:, 16:32].reshape(n, 4, 4),
        fitness=buf[:, 32],
        inlier_rmse=buf[:, 33],
        # restore the int dtype the unpacked path had (counts <= max_points
        # are exact in f32, so the round trip is lossless)
        n_points=buf[:, 34].astype(np.int32) if has_np else None,
    )
    cov_np = buf[:, 35:71].reshape(n, 6, 6).astype(np.float64)
    return buf[:, :16].reshape(n, 4, 4), results_np, cov_np


def _pull_packed(refiner, packed):
    """Fence + unpack one frame's packed track outputs, running the
    refiner's saturation guard on the buffer's own n_points column (the
    fused pack path skips the in-refiner check to stay readback-free)."""
    refined_np, results_np, cov_np = _unpack_outputs(np.asarray(packed), True)
    refiner._warn_if_saturated_host(results_np.n_points)
    return refined_np, results_np, cov_np


# hypotheses below this fitness diverged (or track a different basin) and
# must not pollute the ensemble scatter; clean frames score >= 0.835 in
# scripts/fusion_study.py, corrupt ones 0.07-0.15
_ENSEMBLE_MIN_FITNESS = 0.5
# ...and rows that did not reach the winner's basin floor (visibly worse
# fitness/rmse = partial convergence from a far start, common with
# step_async's one-frame-stale hypothesis centers) measure CONVERGENCE
# distance, not measurement repeatability - including them inflated R until
# the filter lagged the motion (measured: 1.4 deg vs 0.08 deg final error
# on the tracking drive). On degenerate DOFs (the icosphere's
# rotations) the wandering rows have IDENTICAL scores - the surface does
# not move - so they pass these tolerances and the honest scatter is kept.
_ENSEMBLE_FITNESS_TOL = 0.05
_ENSEMBLE_RMSE_TOL = 0.25  # relative, plus the depth-quantization floor


def _ensemble_cov(refined_np, fitness_np, best: int,
                  rmse_np=None) -> np.ndarray:
    """Hypothesis-scatter measurement covariance term (6x6, [rad, m] twist).

    The fused Laplace covariance - even render-calibrated
    (icp.RENDER_COV_INFLATION) - cannot see error the fit never corrects:
    on weakly-constrained geometry (near-symmetric meshes) the refined
    rotation largely inherits the HYPOTHESIS's error, so per-fit statistics
    claim ~0.25 deg std while the actual scatter is 2-4 deg (the round-3
    filter-divergence mode). The session refines several hypotheses from
    different starts each frame; their post-convergence scatter about the
    winner measures exactly that per-frame basin wander, per direction:
    well-constrained DOFs collapse together (tiny term), unobservable ones
    stay spread at the sampling scale (honest term). Measured in
    scripts/uncertainty_calibration_study.py: adding this to the calibrated
    Laplace takes the icosphere's NEES from ~35-43 to ~8-9 while leaving
    the bumpy sphere near-ideal."""
    ens = np.zeros((6, 6))
    k = 0
    try:
        inv_best = np.linalg.inv(PoseTracker._to_m(refined_np[best]))
    except np.linalg.LinAlgError:
        return ens
    min_fit = max(_ENSEMBLE_MIN_FITNESS,
                  float(fitness_np[best]) - _ENSEMBLE_FITNESS_TOL)
    max_rmse = None
    if rmse_np is not None:
        br = float(rmse_np[best])
        max_rmse = br + max(_ENSEMBLE_RMSE_TOL * br, icp.DEPTH_QUANT_SIGMA_M)
    for i in range(len(refined_np)):
        if i == best or not (fitness_np[i] >= min_fit):
            continue
        if max_rmse is not None and not (rmse_np[i] <= max_rmse):
            continue
        try:
            e = se3_log(PoseTracker._to_m(refined_np[i]) @ inv_best)
        except ValueError:
            continue  # ~180 deg apart: a wrong-basin row, not scatter
        if not np.isfinite(e).all():
            continue
        ens += np.outer(e, e)
        k += 1
    return ens / k if k else ens


def _fuse_ranked_best(
    tracker: PoseTracker,
    refined_np: np.ndarray,
    results_np: icp.RegistrationResult,
    cov_np: np.ndarray,
    gate_chi2,
    max_innovation,
    min_quality,
) -> TrackStep:
    """Rank one object's refined hypotheses by (fitness, -rmse) and fuse the
    winner through the tracker's gates. All inputs are host numpy."""
    best = int(PoseRefiner.rank(results_np)[0])
    fitness = float(results_np.fitness[best])
    cov = cov_np[best] + _ensemble_cov(
        refined_np, results_np.fitness, best, results_np.inlier_rmse)
    accepted = tracker.update(
        refined_np[best],
        cov,
        gate_chi2=gate_chi2,
        max_innovation=max_innovation,
        quality=fitness if min_quality is not None else None,
        min_quality=min_quality,
    )
    return TrackStep(
        pose=tracker.pose_mm,
        accepted=accepted,
        best=best,
        fitness=fitness,
        refined=refined_np,
        results=results_np,
        covariance=cov,
    )


class TrackingSession:
    """Per-frame tracking loop around one object: refiner + fusion filter.

    Args:
      refiner: a configured PoseRefiner (or MultiModelRefiner - then pass
        ``model_id`` to every step()). Its scene kind decides the fused
        per-frame scene build ('projective' or flash-backend NN; see
        PoseRefiner.track).
      init_pose: (4, 4) detector pose for frame 0, translation in mm.
      init_cov / process_noise: forwarded to PoseTracker (defaults: diffuse
        5 deg / 20 mm prior; 1 deg / 5 mm per-frame random walk). COLD
        STARTS: make init_cov as wide as the detector's actual error - an
        init pose several sigma outside the prior makes the innovation
        gate reject the (correct) first refinement as a wrong-basin jump
        (tests/test_tracking.py::test_session_cold_start_needs_matching_init_cov).
      motion: 'random_walk' (default - measured strictly dominant for slow
        or jittery motion, scripts/fusion_study.py slow regime) or
        'constant_velocity' (the fix for FAST smooth motion, where a random
        walk forces Q up to the full inter-frame motion and the filter
        degenerates to a pass-through; fast regime: 0.53 deg mean vs 1.54).
        A per-step ``motion_mm`` (odometry / external prediction) overrides
        either model for that frame.
      n_hypotheses: refined hypotheses per frame, sampled from the CURRENT
        BELIEF (row 0 is always the mean pose) - the filter's covariance
        replaces hand-tuned jitter scales. 1 tracks the mean only.
      hypothesis_scale: widens (>1) / narrows (<1) the belief sampling.
      min_quality: fitness quality gate - reject measurements whose best
        fitness falls below this, independently of their self-reported
        covariance (measured: corrupt frames score 0.07-0.15 vs >= 0.835
        clean; the gate cut the one covariance slip that chi-square-passed
        from 27.8 mm to 4.7 mm). None disables. Lower it (or disable) for
        scenes with heavy legitimate occlusion.
      gate_chi2: chi-square innovation gate (None disables); max_innovation:
        optional (rot_rad, trans_m) hard cap - both forwarded to
        PoseTracker.update.
      seed: hypothesis-sampling rng seed (resume restores the exact stream).

    Example (one fused device program per frame):

        session = TrackingSession(refiner, detector_pose)
        for depth in frames:
            step = session.step(depth)
            use(step.pose)          # fused estimate, gated against slips
    """

    def __init__(
        self,
        refiner: PoseRefiner,
        init_pose,
        *,
        init_cov=None,
        process_noise=None,
        motion: str = "random_walk",
        n_hypotheses: int = 4,
        hypothesis_scale: float = 1.0,
        min_quality: Optional[float] = 0.6,
        gate_chi2: Optional[float] = CHI2_6_99,
        max_innovation=None,
        seed=0,
    ):
        _set_loop_config(self, motion, n_hypotheses, hypothesis_scale,
                         min_quality, gate_chi2, max_innovation)
        self.refiner = refiner
        self.tracker = PoseTracker(
            init_pose, init_cov=init_cov, process_noise=process_noise
        )
        self._rng = np.random.default_rng(seed)
        self.n_frames = 0
        self._inflight = None  # step_async's pending (packed, motion)

    @property
    def pose(self) -> np.ndarray:
        """Current fused (4, 4) estimate, translation in mm."""
        return self.tracker.pose_mm

    @property
    def n_rejected(self) -> int:
        """Measurements rejected by any gate since the session started."""
        return self.tracker.n_rejected

    def step(self, frame_depth, motion_mm=None, model_id=None) -> TrackStep:
        """Consume one depth frame; returns a :class:`TrackStep`.

        motion_mm: optional (4, 4) LEFT-applied camera-frame motion
        increment (odometry, external prediction) used instead of the
        session's motion model for this frame.
        model_id: required when the refiner is a MultiModelRefiner -
        which model this session's object is (all hypotheses share it).
        """
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before synchronous step()"
            )
        # validate BEFORE mutating the filter/rng: a failed call must leave
        # the session resumable exactly as it was (see step_async)
        if isinstance(self.refiner, MultiModelRefiner):
            if model_id is None:
                raise ValueError(
                    "refiner is a MultiModelRefiner: step() needs model_id"
                )
        elif model_id is not None:
            raise ValueError("model_id is only valid with MultiModelRefiner")
        # pre-checks cannot catch everything (track() itself validates the
        # frame): snapshot the filter + rng and roll back on ANY failure so
        # a corrected retry replays the exact same hypothesis stream
        rng_state = self._rng.bit_generator.state
        tracker_state = self.tracker.state_dict()
        try:
            self._advance(self.tracker, motion_mm)
            hyps = self.tracker.hypotheses(
                self.n_hypotheses, scale=self.hypothesis_scale, seed=self._rng
            )
            if isinstance(self.refiner, MultiModelRefiner):
                ids = np.full((hyps.shape[0],), int(model_id), np.int32)
                packed = self.refiner.track(
                    frame_depth, ids, hyps, with_covariance=True,
                    _pack_outputs=True,
                )
            else:
                packed = self.refiner.track(
                    frame_depth, hyps, with_covariance=True,
                    _pack_outputs=True,
                )
            step = _fuse_ranked_best(
                self.tracker,
                *_pull_packed(self.refiner, packed),
                self.gate_chi2,
                self.max_innovation,
                self.min_quality,
            )
        except BaseException:
            self._rng.bit_generator.state = rng_state
            self.tracker = PoseTracker.from_state(tracker_state)
            raise
        self.n_frames += 1
        return step

    # -- pipelined (double-buffered) stepping ------------------------------
    # step() is fence-per-frame: frame k+1's program cannot be enqueued
    # until frame k's readback returns, so every frame pays the full
    # dispatch + execute + D2H latency SERIALLY. step_async() enqueues
    # frame k's fused program FIRST and only then fences frame k-1 - device
    # execution of frame k overlaps frame k-1's readback + fusion + frame
    # k+1's host prep, so the steady-state frame period approaches
    # max(device_time, host_time) instead of their sum. The price: one
    # frame of latency, and hypothesis centers extrapolated from a belief
    # that lags by the in-flight frame (the filter itself stays exactly
    # ordered - predict/update run at fuse time). The reference gets
    # concurrency from per-thread CUDA streams (README.md:15); this is the
    # XLA-async-dispatch expression of the same intent.

    def _advance(self, tracker: PoseTracker, motion_mm):
        _advance_tracker(tracker, self.motion, motion_mm)

    def _sample_ahead(self, motion_mm):
        """Hypotheses for the NEXT enqueued frame: the current belief
        extrapolated (on a throwaway filter copy) across the in-flight
        frame plus this one. The real filter is untouched - it predicts in
        order at fuse time."""
        tmp = PoseTracker.from_state(self.tracker.state_dict())
        if self._inflight is not None:
            self._advance(tmp, self._inflight[1])  # the in-flight frame's motion
        self._advance(tmp, motion_mm)
        return tmp.hypotheses(
            self.n_hypotheses, scale=self.hypothesis_scale, seed=self._rng
        )

    def _fuse_inflight(self) -> Optional[TrackStep]:
        """Fence + fuse the in-flight frame (None if nothing is pending).
        Runs the filter's predict for that frame immediately before its
        update, so the estimate sequence is identical to unpipelined
        stepping with the same measurements."""
        if self._inflight is None:
            return None
        packed, motion_mm = self._inflight
        self._inflight = None
        self._advance(self.tracker, motion_mm)
        step = _fuse_ranked_best(
            self.tracker,
            *_pull_packed(self.refiner, packed),
            self.gate_chi2,
            self.max_innovation,
            self.min_quality,
        )
        self.n_frames += 1
        return step

    def step_async(self, frame_depth, motion_mm=None,
                   model_id=None) -> Optional[TrackStep]:
        """Pipelined tracking: enqueue this frame's fused program, then
        fence + fuse the PREVIOUS frame and return its :class:`TrackStep`
        (None on the first call - results lag one frame). Call
        :meth:`flush` after the last frame to collect the final step.

            session = TrackingSession(refiner, detector_pose)
            for depth in frames:
                step = session.step_async(depth)
                if step is not None:
                    use(step.pose)
            use(session.flush().pose)
        """
        # validate BEFORE _sample_ahead consumes the hypothesis rng stream:
        # a failed call must not mutate session state, or a corrected retry
        # samples different hypotheses than an error-free run (breaking the
        # from_state bit-exact-resume contract)
        if isinstance(self.refiner, MultiModelRefiner):
            if model_id is None:
                raise ValueError(
                    "refiner is a MultiModelRefiner: step_async() needs "
                    "model_id"
                )
        elif model_id is not None:
            raise ValueError("model_id is only valid with MultiModelRefiner")
        # track_async can still reject the frame after _sample_ahead has
        # consumed the rng stream - roll the stream back on failure (the
        # filter itself is untouched; _sample_ahead works on a copy)
        rng_state = self._rng.bit_generator.state
        try:
            hyps = self._sample_ahead(motion_mm)
            # the output packing is traced INTO the fused track program
            # (pack_outputs) - one enqueued program per frame, and the
            # eventual fuse is one pure D2H
            if isinstance(self.refiner, MultiModelRefiner):
                ids = np.full((hyps.shape[0],), int(model_id), np.int32)
                packed = self.refiner.track_packed_async(
                    frame_depth, ids, hyps
                )
            else:
                packed = self.refiner.track_packed_async(frame_depth, hyps)
        except BaseException:
            self._rng.bit_generator.state = rng_state
            raise
        # fusing the PREVIOUS frame can itself fail (e.g. LinAlgError in the
        # filter update). Restore the FULL pre-call state then - rng, filter,
        # and the still-pending previous frame - discarding the just-enqueued
        # program's result; a corrected retry re-enqueues it with the same
        # hypotheses because the rng stream rolled back too.
        prev_inflight = self._inflight
        tracker_state = self.tracker.state_dict()
        try:
            prev = self._fuse_inflight()
        except BaseException:
            self._rng.bit_generator.state = rng_state
            self.tracker = PoseTracker.from_state(tracker_state)
            self._inflight = prev_inflight
            raise
        self._inflight = (packed, motion_mm)
        return prev

    def flush(self) -> Optional[TrackStep]:
        """Fence + fuse the last step_async frame (None if nothing is in
        flight). After flush(), pose/state_dict reflect every consumed
        frame and step()/step_async() may be mixed freely again.

        Atomic like step()/step_async(): if the readback or filter update
        raises (a failed D2H copy, LinAlgError, gated-off se3_log error),
        the tracker rolls back and the in-flight frame is re-installed so
        a corrected flush() can retry it rather than losing the frame."""
        prev_inflight = self._inflight
        tracker_state = self.tracker.state_dict()
        try:
            return self._fuse_inflight()
        except BaseException:
            self.tracker = PoseTracker.from_state(tracker_state)
            self._inflight = prev_inflight
            raise

    # -- checkpoint/resume ------------------------------------------------
    # The refiner itself is rebuilt from (model, K, config) by the caller;
    # the session state is the filter + the hypothesis rng stream + the
    # loop config. utils.serialization.save(path, session) persists it to
    # one .npz; load(path, refiner=...) resumes (the state dict nests the
    # tracker's dict plus strings/None - serialization flattens it).

    def state_dict(self):
        """Exact loop state (filter, rng stream, gates) as plain values -
        ``from_state(refiner, state)`` resumes bit-exactly."""
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before state_dict()"
            )
        return {
            "tracker": self.tracker.state_dict(),
            "rng_state_json": json.dumps(self._rng.bit_generator.state),
            "motion": self.motion,
            "n_hypotheses": self.n_hypotheses,
            "hypothesis_scale": self.hypothesis_scale,
            "min_quality": self.min_quality,
            "gate_chi2": self.gate_chi2,
            "max_innovation": (
                None
                if self.max_innovation is None
                else tuple(float(v) for v in self.max_innovation)
            ),
            "n_frames": self.n_frames,
        }

    @classmethod
    def from_state(cls, refiner: PoseRefiner, state) -> "TrackingSession":
        """Inverse of :meth:`state_dict` given a freshly configured refiner
        (refiners hold device programs and are rebuilt, not serialized)."""
        self = cls.__new__(cls)
        self.refiner = refiner
        self.tracker = PoseTracker.from_state(state["tracker"])
        _set_loop_config(
            self, state["motion"], state["n_hypotheses"],
            state["hypothesis_scale"], state["min_quality"],
            state["gate_chi2"], state["max_innovation"], from_state=True)
        self._rng = np.random.default_rng(0)
        self._rng.bit_generator.state = json.loads(str(state["rng_state_json"]))
        self.n_frames = int(state["n_frames"])
        self._inflight = None
        return self


class MultiObjectSession:
    """Track SEVERAL objects in the same sensor stream with ONE fused device
    program per frame.

    Each frame, every object's belief-sampled hypotheses are concatenated
    into a single MultiModelRefiner.track batch (per-pose model ids route
    each hypothesis to its object's mesh), refined together with in-program
    measurement covariances, and each object's filter then ranks and fuses
    its own rows. K objects cost ONE dispatch per frame, not K, and the
    device work
    is the same batched pipeline that serves batch-256 hypothesis sweeps.
    The reference cannot express this at all: it binds one mesh per
    renderer and runs its whole pipeline once per object
    (pose_renderer.h:15-19).

    Args:
      refiner: a MultiModelRefiner over all tracked meshes.
      objects: list of (model_id, init_pose_mm) pairs, one per tracked
        object instance (several instances may share a model_id).
      remaining kwargs: shared loop config, exactly TrackingSession's.

    Example:

        refiner = MultiModelRefiner([mesh_a, mesh_b], K=K)
        session = MultiObjectSession(refiner, [(0, pose_a), (1, pose_b)])
        for depth in frames:
            steps = session.step(depth)      # one fused dispatch
            use(steps[0].pose, steps[1].pose)
    """

    def __init__(
        self,
        refiner: MultiModelRefiner,
        objects,
        *,
        init_cov=None,
        process_noise=None,
        motion: str = "random_walk",
        n_hypotheses: int = 4,
        hypothesis_scale: float = 1.0,
        min_quality: Optional[float] = 0.6,
        gate_chi2: Optional[float] = CHI2_6_99,
        max_innovation=None,
        seed=0,
    ):
        if not isinstance(refiner, MultiModelRefiner):
            raise ValueError(
                "MultiObjectSession needs a MultiModelRefiner (a single-model "
                "PoseRefiner tracks one object - use TrackingSession)"
            )
        objects = list(objects)
        if not objects:
            raise ValueError("MultiObjectSession needs at least one object")
        _set_loop_config(self, motion, n_hypotheses, hypothesis_scale,
                         min_quality, gate_chi2, max_innovation)
        self.refiner = refiner
        self.model_ids = []
        self.trackers = []
        for model_id, init_pose in objects:
            mid = int(model_id)
            if not 0 <= mid < len(refiner.models):
                raise ValueError(
                    f"model_id {mid} out of range [0, {len(refiner.models)})"
                )
            self.model_ids.append(mid)
            self.trackers.append(
                PoseTracker(init_pose, init_cov=init_cov, process_noise=process_noise)
            )
        self._rng = np.random.default_rng(seed)
        self.n_frames = 0
        self._inflight = None  # step_async's pending (packed, motions)

    @property
    def poses(self) -> np.ndarray:
        """(K, 4, 4) current fused estimates, translation in mm."""
        return np.stack([t.pose_mm for t in self.trackers])

    def _check_motions(self, motions_mm):
        k = len(self.trackers)
        if motions_mm is None:
            motions_mm = [None] * k
        if len(motions_mm) != k:
            raise ValueError(f"{len(motions_mm)} motions for {k} objects")
        return list(motions_mm)

    def _advance(self, tracker: PoseTracker, motion_mm):
        _advance_tracker(tracker, self.motion, motion_mm)

    def _track_batch(self, frame_depth, hyp_blocks, async_: bool):
        """One fused dispatch over every object's hypothesis block,
        output packing included (pack_outputs) - returns the (K*n, 71)
        packed device buffer."""
        hyps = np.concatenate(hyp_blocks)  # (K*n, 4, 4)
        ids = np.repeat(np.asarray(self.model_ids, np.int32),
                        self.n_hypotheses)
        if async_:
            return self.refiner.track_packed_async(frame_depth, ids, hyps)
        return self.refiner.track(frame_depth, ids, hyps,
                                  with_covariance=True, _pack_outputs=True)

    def _fuse_all(self, refined_np, results_np, cov_np) -> list:
        """Slice the fused batch per object and gate/fuse each tracker."""
        n = self.n_hypotheses
        steps = []
        for i, tracker in enumerate(self.trackers):
            rows = slice(i * n, (i + 1) * n)
            steps.append(
                _fuse_ranked_best(
                    tracker,
                    refined_np[rows],
                    icp.RegistrationResult(
                        transformation=results_np.transformation[rows],
                        fitness=results_np.fitness[rows],
                        inlier_rmse=results_np.inlier_rmse[rows],
                        n_points=(
                            None
                            if results_np.n_points is None
                            else results_np.n_points[rows]
                        ),
                    ),
                    cov_np[rows],
                    self.gate_chi2,
                    self.max_innovation,
                    self.min_quality,
                )
            )
        self.n_frames += 1
        return steps

    def step(self, frame_depth, motions_mm=None) -> list:
        """Consume one depth frame; returns one :class:`TrackStep` per
        object (``refined``/``results``/``best`` are that object's rows of
        the fused batch).

        motions_mm: optional per-object external motion increments - a
        sequence of K entries, each a (4, 4) LEFT-applied camera-frame
        increment or None (that object falls back to the session's motion
        model for this frame).
        """
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before synchronous step()"
            )
        motions_mm = self._check_motions(motions_mm)
        # snapshot + roll back on ANY failure (track() validates the frame
        # only after the filters have predicted and the rng stream moved)
        # so a corrected retry replays the exact same hypothesis stream
        rng_state = self._rng.bit_generator.state
        tracker_states = [t.state_dict() for t in self.trackers]
        try:
            hyp_blocks = []
            for tracker, motion_mm in zip(self.trackers, motions_mm):
                self._advance(tracker, motion_mm)
                hyp_blocks.append(tracker.hypotheses(
                    self.n_hypotheses, scale=self.hypothesis_scale,
                    seed=self._rng))
            packed = self._track_batch(frame_depth, hyp_blocks, async_=False)
            return self._fuse_all(*_pull_packed(self.refiner, packed))
        except BaseException:
            self._rng.bit_generator.state = rng_state
            self.trackers = [
                PoseTracker.from_state(s) for s in tracker_states]
            raise

    # -- pipelined (double-buffered) stepping: the multi-object twin of
    # TrackingSession.step_async (which see for the latency/staleness
    # trade). One fused dispatch per frame for ALL objects, enqueued before
    # the previous frame's fence - device execution overlaps readback +
    # K-object fusion + the next frame's host prep.

    def _fuse_inflight(self) -> Optional[list]:
        if self._inflight is None:
            return None
        packed, motions_mm = self._inflight
        self._inflight = None
        for tracker, motion_mm in zip(self.trackers, motions_mm):
            self._advance(tracker, motion_mm)
        return self._fuse_all(*_pull_packed(self.refiner, packed))

    def step_async(self, frame_depth, motions_mm=None) -> Optional[list]:
        """Pipelined tracking: enqueue this frame's fused program, then
        fence + fuse the PREVIOUS frame and return its per-object
        :class:`TrackStep` list (None on the first call). Call
        :meth:`flush` after the last frame to collect the final steps."""
        motions_mm = self._check_motions(motions_mm)
        inflight_motions = (
            self._inflight[1] if self._inflight is not None
            else [None] * len(self.trackers)
        )
        # roll the rng stream back if the dispatch rejects the frame (the
        # filters are untouched - sampling works on throwaway copies)
        rng_state = self._rng.bit_generator.state
        try:
            hyp_blocks = []
            for tracker, m_in, m_now in zip(
                    self.trackers, inflight_motions, motions_mm):
                tmp = PoseTracker.from_state(tracker.state_dict())
                if self._inflight is not None:
                    self._advance(tmp, m_in)
                self._advance(tmp, m_now)
                hyp_blocks.append(tmp.hypotheses(
                    self.n_hypotheses, scale=self.hypothesis_scale,
                    seed=self._rng))
            packed = self._track_batch(frame_depth, hyp_blocks, async_=True)
        except BaseException:
            self._rng.bit_generator.state = rng_state
            raise
        # same rollback as TrackingSession.step_async: a failed fuse of the
        # previous frame must not drop the pending frame nor leave the rng /
        # filters advanced (atomic-step contract)
        prev_inflight = self._inflight
        tracker_states = [t.state_dict() for t in self.trackers]
        try:
            prev = self._fuse_inflight()
        except BaseException:
            self._rng.bit_generator.state = rng_state
            self.trackers = [
                PoseTracker.from_state(s) for s in tracker_states]
            self._inflight = prev_inflight
            raise
        self._inflight = (packed, motions_mm)
        return prev

    def flush(self) -> Optional[list]:
        """Fence + fuse the last step_async frame (None if nothing is in
        flight). Atomic like step()/step_async(): on a failed readback or
        filter update every tracker rolls back (a mid-list _fuse_all
        failure would otherwise leave earlier objects fused and later
        ones only predicted) and the frame is re-installed for retry."""
        prev_inflight = self._inflight
        tracker_states = [t.state_dict() for t in self.trackers]
        try:
            return self._fuse_inflight()
        except BaseException:
            self.trackers = [
                PoseTracker.from_state(s) for s in tracker_states]
            self._inflight = prev_inflight
            raise

    def state_dict(self):
        """Exact loop state; ``from_state(refiner, state)`` resumes
        bit-exactly (see TrackingSession.state_dict)."""
        if self._inflight is not None:
            raise RuntimeError(
                "a step_async frame is still in flight - call flush() "
                "before state_dict()"
            )
        return {
            "model_ids": list(self.model_ids),
            "trackers": [t.state_dict() for t in self.trackers],
            "rng_state_json": json.dumps(self._rng.bit_generator.state),
            "motion": self.motion,
            "n_hypotheses": self.n_hypotheses,
            "hypothesis_scale": self.hypothesis_scale,
            "min_quality": self.min_quality,
            "gate_chi2": self.gate_chi2,
            "max_innovation": (
                None
                if self.max_innovation is None
                else tuple(float(v) for v in self.max_innovation)
            ),
            "n_frames": self.n_frames,
        }

    @classmethod
    def from_state(cls, refiner: MultiModelRefiner, state) -> "MultiObjectSession":
        """Inverse of :meth:`state_dict` given a freshly configured refiner."""
        self = cls.__new__(cls)
        if not isinstance(refiner, MultiModelRefiner):
            raise ValueError("MultiObjectSession.from_state needs a MultiModelRefiner")
        self.refiner = refiner
        self.model_ids = [int(i) for i in state["model_ids"]]
        for mid in self.model_ids:
            if not 0 <= mid < len(refiner.models):
                raise ValueError(
                    f"state model_id {mid} out of range [0, {len(refiner.models)})"
                )
        self.trackers = [PoseTracker.from_state(s) for s in state["trackers"]]
        if len(self.trackers) != len(self.model_ids):
            raise ValueError(
                f"{len(self.trackers)} tracker states for "
                f"{len(self.model_ids)} model ids"
            )
        _set_loop_config(
            self, state["motion"], state["n_hypotheses"],
            state["hypothesis_scale"], state["min_quality"],
            state["gate_chi2"], state["max_innovation"], from_state=True)
        self._rng = np.random.default_rng(0)
        self._rng.bit_generator.state = json.loads(str(state["rng_state_json"]))
        self.n_frames = int(state["n_frames"])
        self._inflight = None
        return self
