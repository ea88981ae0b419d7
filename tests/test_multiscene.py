"""Heterogeneous scenes in one batch: SceneProjectiveStack + refine(scene_ids=).

The reference runs concurrent ICPs against *different* scene frames via
per-thread CUDA streams (README.md:15, cuda_icp/icp.cu:170). Here the
equivalent is ONE program over a stacked (K*H*W, 8) table with a per-pose
frame index offsetting the row gather - closing the PARITY.md "Partial" row
with parity anchors: the stacked result must equal per-frame refinement.
"""
import numpy as np
import pytest

import pose_refine as prt
from pose_refine import geometry, mesh
from pose_refine.scene.projective import SceneProjective, SceneProjectiveStack
from tests.test_icp import reference_demo_poses

W, H = 160, 120


@pytest.fixture(scope="module")
def setup():
    K = geometry.LINEMOD_K.copy()
    K[:2] *= 0.25
    m = mesh.make_bumpy_sphere(radius=50.0, subdivisions=3)
    r = prt.PoseRenderer(m, K=K, width=W, height=H, backend="dense")
    pose1, _, _ = reference_demo_poses()
    rng = np.random.default_rng(11)
    truths, frames = [], []
    for k in range(3):
        d_rot = np.asarray(geometry.euler_to_rotation(
            rng.uniform(-0.3, 0.3, 3).astype(np.float32)))
        t = pose1[:3, 3] + rng.uniform(-15, 15, 3).astype(np.float32)
        truth = np.asarray(geometry.pose_from_Rt(d_rot @ pose1[:3, :3], t))
        truths.append(truth)
        frames.append(np.asarray(r.render_depth(truth))[0].astype(np.int32))
    return m, K, np.stack(truths), np.stack(frames)


def _refiner(m, K):
    return prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                           use_pallas=False, window=64, stride=1,
                           auto_roi=False)


def _perturbed(truths, rng, per=2):
    hyps, ids = [], []
    for k, truth in enumerate(truths):
        for _ in range(per):
            d = np.asarray(geometry.euler_to_rotation(
                rng.uniform(-0.1, 0.1, 3).astype(np.float32)))
            hyps.append(np.asarray(geometry.pose_from_Rt(
                d @ truth[:3, :3],
                truth[:3, 3] + rng.uniform(-8, 8, 3).astype(np.float32))))
            ids.append(k)
    return np.stack(hyps).astype(np.float32), np.asarray(ids, np.int32)


def test_stack_query_matches_per_frame_scene(setup):
    """query_at(sid) must equal the standalone per-frame scene query - the
    offset gather is a pure re-indexing."""
    import jax.numpy as jnp

    m, K, truths, frames = setup
    stack = SceneProjectiveStack.from_depths(frames, K)
    assert stack.n_scenes == 3 and stack.table.shape == (3 * H * W, 8)
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(-0.1, 0.1, (256, 3)).astype(np.float32)
                      + np.float32([0, 0, 0.3]))
    for i in range(3):
        single = SceneProjective.from_depth(frames[i], K)
        d_s, n_s, v_s = single.query(src)
        d_q, n_q, v_q = stack.query_at(jnp.int32(i))(src)
        d_l, n_l, v_l = stack.lane(i).query(src)
        np.testing.assert_array_equal(np.asarray(v_s), np.asarray(v_q))
        np.testing.assert_array_equal(np.asarray(d_s), np.asarray(d_q))
        np.testing.assert_array_equal(np.asarray(n_s), np.asarray(n_q))
        np.testing.assert_array_equal(np.asarray(d_q), np.asarray(d_l))
        np.testing.assert_array_equal(np.asarray(v_q), np.asarray(v_l))


def test_refine_multiscene_matches_per_frame(setup):
    """ONE stacked dispatch == K per-frame refinements, pose for pose."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(1))

    ref = _refiner(m, K).set_scene_depths(frames)
    refined, res = ref.refine(hyps, scene_ids=ids)
    refined = np.asarray(refined)

    single = _refiner(m, K)
    for k in range(3):
        single.set_scene_depth(frames[k])
        rows = ids == k
        r_k, res_k = single.refine(hyps[rows])
        np.testing.assert_allclose(refined[rows], np.asarray(r_k), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(res.fitness)[rows], np.asarray(res_k.fitness),
            atol=1e-6)
        # each lane recovered ITS OWN frame's truth
        for r in np.asarray(r_k):
            cos = (np.trace(r[:3, :3].T @ truths[k][:3, :3]) - 1) / 2
            assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 3.0
            assert np.abs(r[:3, 3] - truths[k][:3, 3]).max() < 3.0


def test_refine_multiscene_covariance_and_schedule(setup):
    """scene_ids composes with with_covariance and schedule= (the gate
    replacement keeps the stack type)."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(2), per=1)
    ref = _refiner(m, K).set_scene_depths(frames)
    refined, res, unc = ref.refine(hyps, scene_ids=ids, with_covariance=True)
    assert np.asarray(unc.covariance).shape == (3, 6, 6)
    assert np.isfinite(np.asarray(unc.covariance)).all()
    r2, res2 = ref.refine(hyps, scene_ids=ids,
                          schedule=[(0.25, 10), (0.05, 20)])
    assert float(np.min(np.asarray(res2.fitness))) > 0.5
    # streaming: refine_async forwards scene_ids; fenced result == sync
    pending = ref.refine_async(hyps, scene_ids=ids)
    r3, res3 = pending.wait()
    np.testing.assert_allclose(np.asarray(r3), np.asarray(refined), atol=1e-6)


def test_refine_multiscene_validation(setup):
    m, K, truths, frames = setup
    ref = _refiner(m, K).set_scene_depths(frames)
    hyps, ids = _perturbed(truths, np.random.default_rng(3), per=1)
    with pytest.raises(ValueError, match="scene_ids"):
        ref.refine(hyps)  # stack without ids
    with pytest.raises(ValueError, match="does not match"):
        ref.refine(hyps, scene_ids=ids[:2])
    with pytest.raises(ValueError, match="in \\[0, 3\\)"):
        ref.refine(hyps, scene_ids=np.asarray([0, 1, 3], np.int32))
    single = _refiner(m, K).set_scene_depth(frames[0])
    with pytest.raises(ValueError, match="single scene"):
        single.refine(hyps, scene_ids=ids)
    with pytest.raises(ValueError, match="nn_kdtree"):
        prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_kdtree",
                        use_pallas=False).set_scene_depths(frames)
    with pytest.raises(ValueError, match="scene_cascade"):
        prt.PoseRefiner(m, K=K, width=W, height=H, scene="nn_bruteforce",
                        scene_cascade=(8.0, 10), max_points=4096,
                        use_pallas=False).set_scene_depths(frames)
    with pytest.raises(ValueError, match="K, H, W"):
        ref.set_scene_depths(frames[0])


def test_multimodel_multiscene_full_heterogeneity(setup):
    """K different MODELS against K different FRAMES in ONE dispatch
    (MultiModelRefiner inherits set_scene_depths; per-pose tris and
    per-pose scene rows compose) - the reference needs one renderer per
    mesh AND one CUDA stream per scene for this."""
    m, K, truths, frames = setup
    m2 = mesh.make_icosphere(radius=45.0, subdivisions=3)
    # frame 0/1 show the bumpy sphere, frame 2's truth re-rendered with
    # the icosphere so model 1 has something to converge to
    r2 = prt.PoseRenderer(m2, K=K, width=W, height=H, backend="dense")
    frames = frames.copy()
    frames[2] = np.asarray(r2.render_depth(truths[2]))[0].astype(np.int32)

    multi = prt.MultiModelRefiner([m, m2], K=K, width=W, height=H,
                                  max_points=4096, use_pallas=False,
                                  window=64, stride=1, auto_roi=False)
    multi.set_scene_depths(frames)
    hyps, ids = _perturbed(truths, np.random.default_rng(5), per=2)
    model_ids = np.where(ids == 2, 1, 0)  # frame 2 -> icosphere
    refined, res = multi.refine(model_ids, hyps, scene_ids=ids)
    refined = np.asarray(refined)
    for r_pose, k in zip(refined, ids):
        assert np.abs(r_pose[:3, 3] - truths[k][:3, 3]).max() < 4.0
    assert float(np.min(np.asarray(res.fitness))) > 0.5
    # parity: each (model, frame) group must match its dedicated refiner
    single = prt.PoseRefiner(m2, K=K, width=W, height=H, max_points=4096,
                             use_pallas=False, window=64, stride=1,
                             auto_roi=False).set_scene_depth(frames[2])
    rows = ids == 2
    r_k, _ = single.refine(hyps[rows])
    np.testing.assert_allclose(refined[rows], np.asarray(r_k), atol=1e-5)


def test_refine_multiscene_sharded_parity(setup):
    """The stacked program sharded over an 8-device mesh (scene_ids shard
    with their poses, table replicates; non-divisible batch pads) must
    match the single-device result."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(4))  # 6 poses / 8 dev
    ref = _refiner(m, K).set_scene_depths(frames)
    r1, res1 = ref.refine(hyps, scene_ids=ids)
    ref8 = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                           use_pallas=False, window=64, stride=1,
                           auto_roi=False, devices=8)
    ref8.set_scene_depths(frames)
    r8, res8 = ref8.refine(hyps, scene_ids=ids)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r8), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res1.fitness), np.asarray(res8.fitness), atol=1e-6)


# ------------------------------------------------------------- NN stacks

def _nn_refiner(m, K):
    return prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                           use_pallas=False, window=64, stride=1,
                           auto_roi=False, scene="nn_bruteforce")


def test_nn_stack_query_matches_per_frame_scene(setup):
    """SceneNNStack.query_at(sid) must equal the standalone per-frame
    SceneNN query: bit-identical to the brute-force scene (same kd reorder
    -> same rows -> identical in-gate NN, ties included), and at the same
    distance as the kd traversal's answer."""
    import jax.numpy as jnp

    from pose_refine.scene.nn import SceneNN, SceneNNStack

    m, K, truths, frames = setup
    rng = np.random.default_rng(7)
    src_np = (rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
              + np.float32([0, 0, 0.3]))
    src = jnp.asarray(src_np)
    stack = SceneNNStack.from_depths(frames, K)
    assert stack.n_scenes == 3
    assert stack.points.shape[0] == 3 * stack.frame_rows
    for i in range(3):
        d_q, n_q, v_q = map(np.asarray, stack.query_at(jnp.int32(i))(src))
        for backend in ("bruteforce", "kdtree"):
            single = SceneNN.from_depth(frames[i], K, backend=backend)
            d_s, n_s, v_s = map(np.asarray, single.query(src))
            np.testing.assert_array_equal(v_s, v_q)
            v = v_s
            if backend == "bruteforce":
                np.testing.assert_array_equal(d_s[v], d_q[v])
                np.testing.assert_array_equal(n_s[v], n_q[v])
            else:
                np.testing.assert_array_equal(
                    ((d_s[v] - src_np[v]) ** 2).sum(-1),
                    ((d_q[v] - src_np[v]) ** 2).sum(-1))


def test_stack_query_clamps_out_of_range_sid(setup):
    """Device-resident scene_ids are validated by shape only (a min/max
    readback would fence refine_async), so the refine() docstring promises
    an out-of-range id CLAMPS to the nearest valid frame. Pin that for
    both stack kinds: without the clamp, jnp.take's fill mode would NaN-
    poison every association)."""
    import jax.numpy as jnp

    from pose_refine.scene.nn import SceneNNStack

    m, K, truths, frames = setup
    rng = np.random.default_rng(13)
    src = jnp.asarray(rng.uniform(-0.1, 0.1, (128, 3)).astype(np.float32)
                      + np.float32([0, 0, 0.3]))
    proj = SceneProjectiveStack.from_depths(frames, K)
    nn = SceneNNStack.from_depths(frames, K, backend="bruteforce")
    for stack in (proj, nn):
        for bad, good in ((jnp.int32(3), 2), (jnp.int32(-1), 0),
                          (jnp.int32(99), 2)):
            d_b, n_b, v_b = stack.query_at(bad)(src)
            d_g, n_g, v_g = stack.query_at(jnp.int32(good))(src)
            assert np.isfinite(np.asarray(d_b)[np.asarray(v_b)]).all()
            np.testing.assert_array_equal(np.asarray(v_b), np.asarray(v_g))
            np.testing.assert_array_equal(np.asarray(d_b), np.asarray(d_g))
            np.testing.assert_array_equal(np.asarray(n_b), np.asarray(n_g))


def test_refine_nn_multiscene_matches_per_frame(setup):
    """ONE stacked NN dispatch == K per-frame NN refinements (the gated
    kernel windows its scan to each pose's frame region)."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(8))

    ref = _nn_refiner(m, K).set_scene_depths(frames)
    from pose_refine.scene.nn import SceneNNStack

    assert isinstance(ref.scene, SceneNNStack)
    refined, res = ref.refine(hyps, scene_ids=ids)
    refined = np.asarray(refined)

    single = _nn_refiner(m, K)
    for k in range(3):
        single.set_scene_depth(frames[k])
        rows = ids == k
        r_k, res_k = single.refine(hyps[rows])
        np.testing.assert_allclose(refined[rows], np.asarray(r_k), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(res.fitness)[rows], np.asarray(res_k.fitness),
            atol=1e-6)
        for r in np.asarray(r_k):
            cos = (np.trace(r[:3, :3].T @ truths[k][:3, :3]) - 1) / 2
            assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 3.0
            assert np.abs(r[:3, 3] - truths[k][:3, 3]).max() < 3.0


def test_refine_nn_multiscene_composition(setup):
    """NN scene_ids compose with with_covariance, schedule= and
    refine_async, like the projective stack."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(9), per=1)
    ref = _nn_refiner(m, K).set_scene_depths(frames)
    refined, res, unc = ref.refine(hyps, scene_ids=ids, with_covariance=True)
    assert np.asarray(unc.covariance).shape == (3, 6, 6)
    assert np.isfinite(np.asarray(unc.covariance)).all()
    r2, res2 = ref.refine(hyps, scene_ids=ids,
                          schedule=[(0.25, 10), (0.05, 20)])
    assert float(np.min(np.asarray(res2.fitness))) > 0.5
    pending = ref.refine_async(hyps, scene_ids=ids)
    r3, res3 = pending.wait()
    np.testing.assert_allclose(np.asarray(r3), np.asarray(refined), atol=1e-6)


def test_refine_nn_multiscene_sharded_parity(setup):
    """The stacked NN program sharded over an 8-device mesh must match the
    single-device result (tables replicate, poses + scene_ids shard)."""
    m, K, truths, frames = setup
    hyps, ids = _perturbed(truths, np.random.default_rng(10))  # 6 poses
    ref = _nn_refiner(m, K).set_scene_depths(frames)
    r1, res1 = ref.refine(hyps, scene_ids=ids)
    ref8 = prt.PoseRefiner(m, K=K, width=W, height=H, max_points=4096,
                           use_pallas=False, window=64, stride=1,
                           auto_roi=False, scene="nn_bruteforce", devices=8)
    ref8.set_scene_depths(frames)
    r8, res8 = ref8.refine(hyps, scene_ids=ids)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r8), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res1.fitness), np.asarray(res8.fitness), atol=1e-6)


def test_nn_stack_serialization_roundtrip(setup, tmp_path):
    """SceneNNStack round-trips through the one-file .npz checkpoint."""
    from pose_refine.scene.nn import SceneNNStack
    from pose_refine.utils import serialization

    m, K, truths, frames = setup
    stack = SceneNNStack.from_depths(frames, K)
    p = str(tmp_path / "stack.npz")
    serialization.save(p, stack)
    back = serialization.load(p)
    assert isinstance(back, SceneNNStack)
    assert back.n_scenes == stack.n_scenes
    assert back.frame_rows == stack.frame_rows
    np.testing.assert_array_equal(np.asarray(back.table),
                                  np.asarray(stack.table))
    np.testing.assert_array_equal(np.asarray(back.points),
                                  np.asarray(stack.points))
