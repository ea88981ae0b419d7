"""Point-to-plane ICP, fully on-device and pose-batch ready.

Re-designs the reference ICP (icp.cpp:125-188 CPU / icp.cu:156-217 CUDA):
the reference round-trips device->host every iteration (29-float reduction
down, 6x6 solve on host with Eigen, 16-float transform up); here the whole
outer loop stays on device (a done-latched ``lax.fori_loop``, optionally
chunked for early exit) with the normal equations built by a matmul and
the damped 6x6 system solved on device, so a vmap over the pose batch refines
hundreds of hypotheses with zero host synchronization.

Semantics preserved from the reference:
  * residual b = dot(dst - src, n); A row = [cross(src, n), n] (icp.h:144-163)
  * mse accumulates point-to-POINT |dst - src|^2, per the Open3D issue the
    reference cites (icp.h:151-153)
  * fitness = inliers / cloud size; rmse = sqrt(mse/inliers) (icp.cpp:158-159)
  * convergence when |dfitness| < rf AND |drmse| < rr (1e-5 each), max 30
    iterations plus one extra scoring-only pass (icp.h:38-50, icp.cpp:137-166)
  * count == 0 aborts, keeping the previous scores (icp.cpp:156)
  * solve: (AtA + 0.01*I) x = Atb, Tikhonov-damped per icpstability.pdf
    (icp.cpp:29-45); update composes Rz(x2)Ry(x1)Rx(x0) + t (icp.cpp:7-17)
  * transformation accumulates left-to-right: T <- update @ T (icp.cpp:183)

The reference solves in float64 LDLT; the device path stays in float32, so
the solve is float32 Cholesky + one iterative-refinement step (validated to
reference accuracy in tests/test_icp.py).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from pose_refine import geometry

F32 = jax.lax.Precision.HIGHEST


class ICPConvergenceCriteria(NamedTuple):
    """Defaults per icp.h:38-50."""

    relative_fitness: float = 1e-5
    relative_rmse: float = 1e-5
    max_iteration: int = 30


class RegistrationResult(NamedTuple):
    """Open3D-style result (icp.h:26-36). All fields are arrays so the result
    is a pytree: batched refinement returns batched results."""

    transformation: jnp.ndarray  # (..., 4, 4)
    fitness: jnp.ndarray         # (...,) inlier fraction
    inlier_rmse: jnp.ndarray     # (...,)
    # valid source-cloud points fed to ICP (the fitness divisor,
    # icp.cpp:158). Lets callers detect a saturated lift budget: n_points
    # == max_points means the compaction ran out of room and silently
    # dropped boundary points. None when the producer predates the field.
    n_points: jnp.ndarray = None


class PoseUncertainty(NamedTuple):
    """Per-pose Laplace/Gauss-Newton uncertainty (beyond parity; the
    reference's results carry only fitness/rmse, icp.h:26-36). Produced
    in-program by the fused pipeline (`refine(..., with_covariance=True)`)
    from one extra association pass at the FINAL cloud - the standalone
    `pose_information` path costs ~20 eager dispatches. Twist order
    [omega, t] in [rad, m] (icp.h:157-163). All fields are arrays, so the
    batched result is a pytree."""

    information: jnp.ndarray  # (..., 6, 6) J^T J (unscaled)
    sigma2: jnp.ndarray       # (...,) unbiased residual variance
    count: jnp.ndarray        # (...,) inlier count
    covariance: jnp.ndarray   # (..., 6, 6) sigma2 * inv(info + rel ridge)


class _State(NamedTuple):
    cloud: jnp.ndarray
    T: jnp.ndarray
    fitness: jnp.ndarray
    rmse: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def _solve_damped(AtA, Atb, penalty: float = 0.01):
    """(AtA + penalty*I) x = Atb in f32 Cholesky + one refinement step,
    standing in for the reference's f64 LDLT (icp.cpp:29-45)."""
    M = AtA + penalty * jnp.eye(6, dtype=AtA.dtype)
    cho = jax.scipy.linalg.cho_factor(M)
    x = jax.scipy.linalg.cho_solve(cho, Atb)
    # full-f32 residual: with reduced-precision products (TF32) r would be
    # ~1e-2 relative NOISE and the refinement step would ADD
    # cond(M)-amplified error instead of recovering f64-like accuracy -
    # the whole point of this stand-in for the reference's f64 LDLT
    r = Atb - jnp.matmul(M, x, precision=F32)
    x = x + jax.scipy.linalg.cho_solve(cho, r)
    return x


def _huber_sqrt_w(b, delta: float):
    """sqrt of the Huber IRLS weight on the point-to-plane residual:
    w = 1 inside |b| <= delta, delta/|b| outside. Applied as sqrt(w) to the
    Jacobian rows and residuals, this solves the Huber-robustified normal
    equations - the standard guard against sensor outliers that survive the
    hard association gate (beyond parity: the reference's only robustness is
    the 0.1 m gate, depth_scene.h:9)."""
    ab = jnp.abs(b)
    return jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(ab, 1e-12)))


def _weighted_rows(cloud, valid, dst, nrm, q_valid, robust_delta: float):
    """Shared front half of both point-to-plane reductions: mask, residual,
    Huber weight, masked-and-weighted (P, 6) Jacobian rows. One definition
    so the round-4 invariant (every reduce masks by q_valid & valid, which
    keeps non-origin padded rows bit-inert) cannot drift between the
    matmul and packed variants."""
    v = (q_valid & valid).astype(cloud.dtype)
    diff = dst - cloud
    b = jnp.sum(diff * nrm, axis=-1)
    w = v if robust_delta <= 0.0 else v * _huber_sqrt_w(b, robust_delta)
    arow = jnp.concatenate([jnp.cross(cloud, nrm), nrm], axis=-1) * w[:, None]
    return v, diff, b, w, arow


def _normal_equations_from_assoc(cloud, valid, dst, nrm, q_valid,
                                 robust_delta: float = 0.0):
    """Reduction half of _normal_equations, from a given association.

    Split out so passes that already hold an association - the in-program
    PoseUncertainty information matrix (pose_information) - can rebuild
    the normal equations without re-querying the scene; this half is
    matmul-cheap (the association gather is the row-count-bound part of
    an iteration)."""
    v, diff, b, w, arow = _weighted_rows(
        cloud, valid, dst, nrm, q_valid, robust_delta)
    bm = b * w
    AtA = jnp.einsum("pi,pj->ij", arow, arow, precision=F32)
    Atb = jnp.einsum("pi,p->i", arow, bm, precision=F32)
    count = jnp.sum(v)
    mse_sum = jnp.sum(jnp.sum(diff * diff, axis=-1) * v)
    return AtA, Atb, count, mse_sum


def _normal_equations(cloud, valid, query_fn, robust_delta: float = 0.0):
    """One fused association + reduction pass.

    Equivalent of the reference's single transform_reduce over thrust__pcd2Ab
    (icp.h:128-209, icp.cu:170-172), but shaped for a matmul: build the masked
    (P, 6) Jacobian rows and reduce AtA/Atb with a matmul instead of packing
    29-float tuples. robust_delta > 0 (meters) Huber-weights the rows; the
    fitness/rmse scores stay unweighted (reference semantics).
    """
    dst, nrm, q_valid = query_fn(cloud)
    return _normal_equations_from_assoc(cloud, valid, dst, nrm, q_valid,
                                        robust_delta)


def _p2p_equations_from_assoc(cloud, valid, dst, nrm, q_valid,
                              robust_delta: float = 0.0):
    """Point-to-POINT Gauss-Newton normal equations from an association.

    Residual e = dst - p is a 3-vector per point; the Jacobian row block is
    J = [-[p]x | I3] in the same [omega, t] twist order as the plane form
    (n . J reproduces the plane A-row [cross(p, n), n], so both estimations
    share twist_to_mat4 and the left-composition semantics). The scene's
    normals are ignored: this is the estimation to reach for when normals
    are unreliable (thin structures, heavy sensor noise) - Open3D's
    TransformationEstimationPointToPoint, which the reference cross-checks
    against but never implements (test.cpp:96-126). Beyond parity.

    robust_delta > 0 (meters) Huber-weights on the 3D residual NORM (the
    plane form weights on the signed plane residual). Scores (count /
    point-to-point mse) are identical to the plane form by construction
    (icp.h:151-153 already accumulates point-to-point distances).
    """
    del nrm  # p2p ignores scene normals
    v = (q_valid & valid).astype(cloud.dtype)
    diff = dst - cloud
    if robust_delta > 0.0:
        r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        w = v * _huber_sqrt_w(r, robust_delta)
    else:
        w = v
    px, py, pz = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    zeros = jnp.zeros_like(px)
    # (P, 3, 3) = -[p]x
    negskew = jnp.stack(
        [
            jnp.stack([zeros, pz, -py], axis=-1),
            jnp.stack([-pz, zeros, px], axis=-1),
            jnp.stack([py, -px, zeros], axis=-1),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cloud.dtype), negskew.shape)
    J = jnp.concatenate([negskew, eye], axis=-1) * w[:, None, None]  # (P,3,6)
    e = diff * w[:, None]
    AtA = jnp.einsum("pab,pac->bc", J, J, precision=F32)
    Atb = jnp.einsum("pab,pa->b", J, e, precision=F32)
    count = jnp.sum(v)
    mse_sum = jnp.sum(jnp.sum(diff * diff, axis=-1) * v)
    return AtA, Atb, count, mse_sum


def _p2p_equations(cloud, valid, query_fn, robust_delta: float = 0.0):
    """One fused association + point-to-point reduction pass (the p2p twin
    of _normal_equations)."""
    dst, nrm, q_valid = query_fn(cloud)
    return _p2p_equations_from_assoc(cloud, valid, dst, nrm, q_valid,
                                     robust_delta)


def _normal_equations_packed(cloud, valid, query_fn, robust_delta: float = 0.0):
    """The reference's "tight" formulation: each point maps to a 29-float
    vector (21 upper-triangular AtA entries + 6 Atb + mse + count) summed in
    one reduction (thrust__pcd2Ab, icp.h:125-209). Numerically equivalent to
    _normal_equations; kept as a selectable variant and cross-checked in
    tests (the reference similarly keeps its global-memory variant around
    for comparison, icp.cu:8-9)."""
    dst, nrm, q_valid = query_fn(cloud)
    v, diff, b, w, arow = _weighted_rows(
        cloud, valid, dst, nrm, q_valid, robust_delta)
    iu, ju = jnp.triu_indices(6)
    packed = jnp.concatenate(
        [
            arow[:, iu] * arow[:, ju],                    # 21 upper-tri AtA
            arow * (b * w)[:, None],                      # 6 Atb
            (jnp.sum(diff * diff, axis=-1) * v)[:, None],  # mse (pt-to-pt)
            v[:, None],                                   # count
        ],
        axis=1,
    )
    s = jnp.sum(packed, axis=0)
    AtA = jnp.zeros((6, 6), cloud.dtype).at[iu, ju].set(s[:21])
    AtA = AtA + jnp.triu(AtA, 1).T
    return AtA, s[21:27], s[28], s[27]


def icp_point_to_plane(
    cloud,
    valid,
    query_fn: Callable,
    criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
    n_points=None,
    reduction: str = "matmul",
    chunk_iters: int = 8,
    robust_delta: float = 0.0,
    coarse_iters: int = 0,
    coarse_stride: int = 2,
):
    """Refine one cloud against a scene.

    Args:
      cloud:    (P, 3) float32 source points (static padding allowed).
      valid:    (P,) bool - which rows are real points.
      query_fn: scene.query - (P, 3) -> (dst, normal, valid).
      criteria: convergence constants.
      n_points: divisor for fitness; defaults to sum(valid) (the reference
                divides by its compacted cloud size, icp.cpp:158).
      reduction: 'matmul' (normal equations by one matmul - the default) or
                 'packed' (the reference's 29-float transform_reduce shape).
      robust_delta: > 0 (meters) enables Huber-IRLS weighting of the normal
                 equations with this inlier width; 0 = the reference's plain
                 least squares. Scores stay unweighted either way.
      chunk_iters: early-exit granularity. The loop runs as a while_loop over
                 chunks of this many fori iterations: convergence still stops
                 the work early (like the reference's while-style exit,
                 icp.cpp:162-166) while bounding the number of device
                 program segments (each while iteration checks its
                 condition on the host). Set >= max_iteration + 1 for one
                 pure fori program.
      coarse_iters: > 0 enables a coarse-to-fine point schedule (beyond
                 parity): the first `coarse_iters` iterations run pure
                 Gauss-Newton updates on a 1-in-`coarse_stride` strided
                 subsample of the cloud, then the standard scored loop
                 finishes on the full cloud - all inside ONE fused program
                 (two sequential fori loops; no extra dispatch, unlike a
                 two-pass cascade). An ICP iteration's cost is gather-row-
                 bound, so each coarse iteration costs
                 ~1/coarse_stride of a fine one. The coarse phase carries
                 no convergence latch (the latch saves no work in a fused
                 fori anyway - it only freezes state); reported
                 fitness/rmse always come from full-cloud iterations.
                 Total iteration count is unchanged: coarse_iters coarse +
                 (max_iteration - coarse_iters) fine + the scoring pass.
                 Requires a fused loop.

    Returns:
      (RegistrationResult, transformed cloud (P, 3)).
    """
    if reduction not in ("matmul", "packed"):
        # fail LOUD like the estimation/variant selectors: a typo'd
        # reduction would otherwise silently A/B matmul against itself
        raise ValueError(
            f"unknown reduction {reduction!r}: expected 'matmul' or 'packed'"
        )
    base_fn = (
        _normal_equations_packed if reduction == "packed" else _normal_equations
    )
    rd = float(robust_delta)
    return _icp_run(
        cloud, valid, query_fn, criteria, n_points,
        functools.partial(base_fn, robust_delta=rd),
        chunk_iters, coarse_iters, coarse_stride,
    )


def icp_point_to_point(
    cloud,
    valid,
    query_fn: Callable,
    criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
    n_points=None,
    chunk_iters: int = 8,
    robust_delta: float = 0.0,
    coarse_iters: int = 0,
    coarse_stride: int = 2,
):
    """Refine one cloud with point-to-POINT Gauss-Newton estimation.

    Same outer loop, convergence semantics, scores and knobs as
    :func:`icp_point_to_plane` (which see); only the per-point residual
    changes: e = dst - src (3 rows per point, scene normals ignored)
    instead of the plane-projected dot(dst - src, n). Reach for it when
    scene normals are unreliable (thin structures, heavy sensor noise,
    sparse clouds); it converges slower than point-to-plane (no tangential
    sliding) - the classic trade-off. Beyond parity: the reference
    cross-checks against Open3D's point-to-point estimator
    (test.cpp:96-126) but implements only point-to-plane.

    PAIR WITH NEAREST-NEIGHBOR ASSOCIATION (SceneNN). Projective
    association returns the scene point at the SAME PIXEL the source
    projects to, so its residuals are ray-aligned by construction;
    minimizing their full 3D length is ill-posed and measured to DIVERGE
    (first Gauss-Newton step overshoots 3x on the standard recovery
    workload). Point-to-plane is the correct residual for projective
    scenes - that is exactly why the reference (and every projective-ICP
    system) uses it.

    Returns:
      (RegistrationResult, transformed cloud (P, 3)).
    """
    rd = float(robust_delta)
    return _icp_run(
        cloud, valid, query_fn, criteria, n_points,
        functools.partial(_p2p_equations, robust_delta=rd),
        chunk_iters, coarse_iters, coarse_stride,
    )


def _icp_run(
    cloud,
    valid,
    query_fn: Callable,
    criteria: ICPConvergenceCriteria,
    n_points,
    reduce_fn: Callable,
    chunk_iters: int,
    coarse_iters: int,
    coarse_stride: int,
):
    """Shared ICP outer loop (see icp_point_to_plane for the semantics).

    reduce_fn(cloud, valid, query_fn) produces (AtA, Atb, count, mse_sum)
    for the chosen estimation; everything else (the done-latched fori, the
    chunked while, the coarse-to-fine schedule) is estimation-agnostic.
    """
    cloud = jnp.asarray(cloud, jnp.float32)
    valid = jnp.asarray(valid, bool)
    # anchor padded rows to a REAL point instead of the origin: their
    # contribution is exactly zero either way (every reduction multiplies
    # by `q_valid & valid`, so AtA/Atb/count/mse are bit-identical), but
    # origin rows 0.3 m off the surface inflate the flash-NN kernel's
    # query-tile bounds to the full association gate and defeat its
    # chunk pruning (nn_pallas._kernel_gated). All-invalid clouds keep
    # row 0 and hit the count==0 abort as before.
    anchor = cloud[jnp.argmax(valid)]
    cloud = jnp.where(valid[:, None], cloud, anchor)
    n_total = jnp.sum(valid).astype(jnp.float32) if n_points is None else jnp.asarray(n_points, jnp.float32)
    max_iter = criteria.max_iteration

    # A fori_loop with a static trip count and a `done` latch, rather than a
    # while_loop with early exit: semantics are identical (state freezes once
    # done), but the whole refinement stays ONE device program (a
    # while_loop checks its condition on the host every iteration; a
    # converged lane wastes no work under vmap either way).

    def step(it, s: _State, AtA, Atb, count, mse_sum) -> _State:
        empty = count == 0
        new_fit = jnp.where(empty, s.fitness, count / jnp.maximum(n_total, 1.0))
        new_rmse = jnp.where(
            empty, s.rmse, jnp.sqrt(mse_sum / jnp.maximum(count, 1.0))
        )
        scoring_only = it == max_iter
        converged = (
            (jnp.abs(new_fit - s.fitness) < criteria.relative_fitness)
            & (jnp.abs(new_rmse - s.rmse) < criteria.relative_rmse)
        )
        done = s.done | empty | scoring_only | converged

        x = _solve_damped(AtA, Atb)
        upd = geometry.twist_to_mat4(x)
        new_cloud = geometry.transform_points(upd, s.cloud)
        # full-f32 composition: a reduced default precision (TF32) would
        # compound over up to 31 left-compositions
        # straight into the returned pose (geometry.py:20-23 rationale)
        new_T = jnp.matmul(upd, s.T, precision=F32)

        # no solve/update on the terminating pass (icp.cpp:162-166); once
        # done, freeze everything including the scores
        return _State(
            cloud=jnp.where(done, s.cloud, new_cloud),
            T=jnp.where(done, s.T, new_T),
            fitness=jnp.where(s.done, s.fitness, new_fit),
            rmse=jnp.where(s.done, s.rmse, new_rmse),
            it=it + 1,
            done=done,
        )

    def body(it, s: _State) -> _State:
        return step(it, s, *reduce_fn(s.cloud, valid, query_fn))

    init = _State(
        cloud=cloud,
        T=jnp.eye(4, dtype=jnp.float32),
        fitness=jnp.float32(0.0),
        rmse=jnp.float32(0.0),
        it=jnp.int32(0),
        done=jnp.asarray(False),
    )
    total = max_iter + 1
    chunk = max(1, min(int(chunk_iters), total))
    c = int(coarse_iters)
    if c > 0:
        if chunk < total:
            raise ValueError(
                "coarse_iters > 0 requires a fused loop "
                "(chunk_iters >= max_iteration + 1)"
            )
        if not 0 < c < max_iter:
            raise ValueError(
                f"coarse_iters={c} must leave at least one full-cloud "
                f"iteration before the scoring pass (max_iteration={max_iter})"
            )
        cs = int(coarse_stride)
        if cs < 2:
            raise ValueError(f"coarse_stride={cs} must be >= 2")
        valid_c = valid[::cs]

        def coarse_body(it, s: _State) -> _State:
            AtA, Atb, count, _mse = reduce_fn(s.cloud, valid_c, query_fn)
            x = _solve_damped(AtA, Atb)
            upd = geometry.twist_to_mat4(x)
            ok = count > 0  # empty association: hold the pose (icp.cpp:156)
            return s._replace(
                cloud=jnp.where(ok, geometry.transform_points(upd, s.cloud),
                                s.cloud),
                T=jnp.where(ok, jnp.matmul(upd, s.T, precision=F32), s.T),
                it=it + 1,
            )

        warm = jax.lax.fori_loop(
            0, c, coarse_body, init._replace(cloud=cloud[::cs])
        )
        # hand off: move the FULL cloud by the accumulated coarse transform
        # and run the standard scored loop from iteration c. Scores restart
        # from zero, so the fine phase behaves exactly like a fresh ICP
        # initialized at the coarse-polished pose.
        init_fine = init._replace(
            cloud=geometry.transform_points(warm.T, cloud),
            T=warm.T,
            it=jnp.int32(c),
        )
        final = jax.lax.fori_loop(c, total, body, init_fine)
        return (
            RegistrationResult(final.T, final.fitness, final.rmse, n_total),
            final.cloud,
        )
    if chunk >= total:
        final = jax.lax.fori_loop(0, total, body, init)
    else:
        # done latches inside body, so overrunning past `total` inside the
        # last chunk is a no-op; the while just stops dispatching chunks.
        def chunk_body(s: _State) -> _State:
            # static trip count (a traced-bound fori would lower back to a
            # per-iteration while); the state carries its own counter
            return jax.lax.fori_loop(
                0, chunk, lambda _, st: body(st.it, st), s
            )

        final = jax.lax.while_loop(
            lambda s: (s.it < total) & ~s.done, chunk_body, init
        )
    return (
        RegistrationResult(final.T, final.fitness, final.rmse, n_total),
        final.cloud,
    )


def pose_information(cloud, valid, query_fn: Callable,
                     robust_delta: float = 0.0,
                     estimation: str = "point_to_plane"):
    """Gauss-Newton information matrix of a refined pose (beyond parity).

    One association + reduction pass at the given (already transformed)
    cloud - the same J rows the solver uses ([p x n, n] twist order
    [omega, t], icp.h:157-163; for estimation='point_to_point' the 3-row
    block [-[p]x | I]) - returning:

      info:   (6, 6) J^T J - the unscaled information matrix. Near-zero
              eigenvalues are the pose's unconstrained directions (e.g. a
              single plane leaves in-plane translation + in-plane rotation
              free; a sphere leaves all rotations free).
      sigma2: unbiased residual variance: point-to-plane sum(b^2)/(n-6),
              point-to-point sum(|e|^2)/(3n-6) (3 residual rows per point).
      count:  inlier count n.

    The Laplace/Gauss-Newton pose covariance is sigma2 * inv(info)
    (`pose_covariance` computes it with a relative ridge for the
    unconstrained directions). Works under vmap/jit; costs one extra
    association gather, only when called - the refinement program is
    untouched. Uncertainty output has no reference analog (its results
    carry only fitness/rmse, icp.h:26-36)."""
    cloud = jnp.asarray(cloud, jnp.float32)
    valid = jnp.asarray(valid, bool)
    dst, nrm, q_valid = query_fn(cloud)
    v = (q_valid & valid).astype(cloud.dtype)
    count = jnp.sum(v)
    if estimation == "point_to_point":
        info, _Atb, _c, _mse = _p2p_equations_from_assoc(
            cloud, valid, dst, nrm, q_valid, robust_delta=robust_delta
        )
        diff = dst - cloud
        if robust_delta > 0.0:
            r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
            w2 = v * _huber_sqrt_w(r, robust_delta) ** 2
        else:
            w2 = v
        rss = jnp.sum(jnp.sum(diff * diff, axis=-1) * w2)
        sigma2 = rss / jnp.maximum(3.0 * count - 6.0, 1.0)
        return info, sigma2, count
    if estimation != "point_to_plane":
        raise ValueError(f"unknown estimation {estimation!r}")
    b = jnp.sum((dst - cloud) * nrm, axis=-1)
    w = v if robust_delta <= 0.0 else v * _huber_sqrt_w(b, robust_delta)
    arow = jnp.concatenate([jnp.cross(cloud, nrm), nrm], axis=-1) * w[:, None]
    info = jnp.einsum("pi,pj->ij", arow, arow, precision=F32)
    rss = jnp.sum((b * w) ** 2)
    sigma2 = rss / jnp.maximum(count - 6.0, 1.0)
    return info, sigma2, count


# Calibration of the Laplace covariance for RENDERED-pipeline measurements
# (scripts/uncertainty_calibration_study.py, round 4). On real point clouds
# with i.i.d. sensor noise the textbook sigma2 * inv(J^T J) is provably
# calibrated (tests/test_icp_anchor.py pins var(t_z) ~ sigma^2/n against the
# generative model). On the RENDER->lift->ICP pipeline it is badly
# overconfident: the per-frame render quantization pattern is a CORRELATED
# residual field that shifts the basin minimum itself - a bias the curvature
# cannot see - so the measured NEES of refined poses vs ground truth is
# 84-384 (calibrated ~6; 160x120 renders, bumpy sphere / icosphere). A x3
# std inflation restores the well-constrained mesh to NEES ~9-13; the
# weakly-constrained icosphere additionally needs the SESSION-level ensemble
# term (hypothesis scatter, tracking._ensemble_cov) because its rotation
# error is inherited from the hypothesis prior, invisible to any per-fit
# statistic. A filter divergence seen without this term was exactly
# this: trace(R) ~ 1e-4 claims on 3-5 deg actual error collapsed P and the
# chi-square gate then rejected every honest frame.
RENDER_COV_INFLATION = 9.0
# depth images are integer millimeters: uniform quantization noise with
# std 1 mm / sqrt(12) ~ 0.29 mm - the floor below which a residual-variance
# estimate on rendered data is fiction (the fit can drive residuals to ~0 by
# absorbing the correlated quantization field into the pose)
DEPTH_QUANT_SIGMA_M = 2.9e-4
# lateral quantization: projective association snaps to pixel centers, so a
# point carries ~coeff * z / fx of position noise along the surface slope
# (fx at the RENDER intrinsics - render_scale shrinks fx, growing the floor
# for coarser renders). coeff ~ 1/sqrt(12) for uniform in-pixel position,
# validated against empirical NEES at render_scale 1 and 2
# (tests/test_uncertainty_calibration.py)
LATERAL_QUANT_COEFF = 0.29


def pose_covariance(info, sigma2, rel_ridge: float = 1e-6,
                    inflation: float = 1.0, sigma2_floor: float = 0.0):
    """sigma2 * inv(info) with a RELATIVE ridge: unconstrained directions
    (near-zero eigenvalues) come back as large-variance, not inf/NaN. The
    ridge scales with trace(info)/6 so well-conditioned problems are
    perturbed by ~rel_ridge only.

    inflation / sigma2_floor calibrate the pure Laplace estimate for
    measurement sources whose residuals are not i.i.d.: sigma2 is floored at
    sigma2_floor (e.g. DEPTH_QUANT_SIGMA_M**2 for integer-mm depth) and the
    covariance is scaled by `inflation` (RENDER_COV_INFLATION for rendered-
    pipeline measurements - see the constant's rationale above). Defaults
    keep the textbook estimate (anchored in tests/test_icp_anchor.py)."""
    info = jnp.asarray(info, jnp.float32)
    scale = jnp.trace(info, axis1=-2, axis2=-1) / 6.0
    ridge = jnp.maximum(scale * rel_ridge, 1e-30)
    eye = jnp.eye(6, dtype=info.dtype)
    M = info + ridge[..., None, None] * eye
    sigma2 = jnp.maximum(jnp.asarray(sigma2, info.dtype), sigma2_floor)
    return (inflation * sigma2)[..., None, None] * jnp.linalg.inv(M)


@functools.partial(
    jax.jit, static_argnames=("criteria", "chunk_iters", "robust_delta")
)
def icp_point_to_plane_batch(
    clouds, valids, scene,
    criteria: ICPConvergenceCriteria = ICPConvergenceCriteria(),
    chunk_iters: int = 8,
    robust_delta: float = 0.0,
):
    """vmap of icp_point_to_plane over a pose batch against one shared scene.

    This replaces the reference's per-thread CUDA
    streams (README.md:15): N hypotheses refine concurrently inside one XLA
    program. clouds (N, P, 3), valids (N, P).
    """
    def one(cloud, valid):
        return icp_point_to_plane(cloud, valid, scene.query, criteria,
                                  chunk_iters=chunk_iters,
                                  robust_delta=robust_delta)

    return jax.vmap(one)(clouds, valids)
