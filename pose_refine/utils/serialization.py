"""Checkpoint / resume: persist scenes, kd-trees and refinement results.

The reference has no persistence at all (its only artifact is the input PLY;
ICP state is 16 floats - SURVEY.md section 5). Serving pipelines want to
reuse per-frame scene structures and archive results, so every scene pytree
and result here round-trips through a single .npz file.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from pose_refine.icp import RegistrationResult
from pose_refine.scene.kdtree import KDTree
from pose_refine.scene.nn import SceneNN, SceneNNStack
from pose_refine.scene.projective import SceneProjective, SceneProjectiveStack
from pose_refine.utils.fusion import PoseTracker

_KINDS = {
    "SceneProjective": SceneProjective,
    "SceneProjectiveStack": SceneProjectiveStack,
    "SceneNN": SceneNN,
    "SceneNNStack": SceneNNStack,
    "KDTree": KDTree,
    "RegistrationResult": RegistrationResult,
    "PoseTracker": PoseTracker,
    # tracking sessions resolve lazily (tracking imports pipeline); their
    # refiners hold device programs and are rebuilt by the caller - load()
    # needs `refiner=` for these kinds
    "TrackingSession": None,
    "MultiObjectSession": None,
}

# session state_dict values that are plain arrays (everything else - floats,
# strings, None, tuples - rides in the JSON meta)
_TRACKER_ARRAY_KEYS = ("T_m", "P", "Q", "T_prev")


def _flatten_tracker(state: dict, prefix: str, arrays: dict, static: dict):
    for k, v in state.items():
        if k in _TRACKER_ARRAY_KEYS:
            arrays[f"{prefix}{k}"] = np.asarray(v)
        else:
            static[f"{prefix}{k}"] = v


def _unflatten_tracker(prefix: str, arrays: dict, static: dict) -> dict:
    state = {}
    for k in _TRACKER_ARRAY_KEYS:
        if f"{prefix}{k}" in arrays:
            state[k] = arrays[f"{prefix}{k}"]
    for k, v in static.items():
        if k.startswith(prefix) and "." not in k[len(prefix):]:
            state[k[len(prefix):]] = v
    return state


def save(path: str, obj) -> None:
    """Save a scene / kd-tree / result / tracker / tracking session to
    ``path`` (.npz). Sessions store their full loop state (filter, rng
    stream, gate config); reload with ``load(path, refiner=...)`` since
    refiners hold device programs and are rebuilt, not serialized."""
    kind = type(obj).__name__
    if kind not in _KINDS:
        raise TypeError(f"don't know how to serialize {kind}")
    arrays = {}
    meta = {"kind": kind, "static": {}}
    if kind == "PoseTracker":  # filter state: exact resume of a track
        state = obj.state_dict()
        meta["static"]["n_rejected"] = state.pop("n_rejected")
        arrays = state
    elif kind == "TrackingSession":
        state = obj.state_dict()
        _flatten_tracker(state.pop("tracker"), "tracker.", arrays,
                         meta["static"])
        meta["static"].update(state)
    elif kind == "MultiObjectSession":
        state = obj.state_dict()
        for i, ts in enumerate(state.pop("trackers")):
            _flatten_tracker(ts, f"tracker{i}.", arrays, meta["static"])
        meta["static"].update(state)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.metadata.get("static") or isinstance(v, (int, float, str, bool)):
                meta["static"][f.name] = v
            else:
                arrays[f.name] = np.asarray(v)
    else:  # NamedTuple (RegistrationResult)
        for name, v in obj._asdict().items():
            if v is not None:  # optional fields (e.g. n_points) may be unset
                arrays[name] = np.asarray(v)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, refiner=None):
    """Load an object previously stored with :func:`save`.

    Tracking sessions need ``refiner=`` (a freshly configured PoseRefiner /
    MultiModelRefiner matching the one the session was built with)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        kind = meta["kind"]
        if kind in ("TrackingSession", "MultiObjectSession"):
            if refiner is None:
                raise ValueError(
                    f"{kind} needs load(path, refiner=...) - refiners hold "
                    "device programs and are rebuilt, not serialized")
            from pose_refine import tracking

            arrays = {n: z[n] for n in z.files if n != "__meta__"}
            static = meta["static"]
            state = {k: (tuple(v) if k == "max_innovation"
                         and isinstance(v, list) else v)
                     for k, v in static.items() if "." not in k}
            if kind == "TrackingSession":
                state["tracker"] = _unflatten_tracker(
                    "tracker.", arrays, static)
                return tracking.TrackingSession.from_state(refiner, state)
            state["trackers"] = [
                _unflatten_tracker(f"tracker{i}.", arrays, static)
                for i in range(len(state["model_ids"]))
            ]
            return tracking.MultiObjectSession.from_state(refiner, state)
        cls = _KINDS[kind]
        kwargs = dict(meta["static"])
        for name in z.files:
            if name == "__meta__":
                continue
            arr = z[name]
            if meta["kind"] in ("KDTree", "PoseTracker"):
                kwargs[name] = arr  # host-side numpy objects
            else:
                kwargs[name] = jnp.asarray(arr)
    if meta["kind"] == "PoseTracker":
        return PoseTracker.from_state(kwargs)
    if meta["kind"] in ("KDTree", "SceneNN") and "bbox" in kwargs:
        # artifacts saved before round 3 carry no LEAF bboxes; the kd
        # traversal's far-child pruning needs them (zero boxes would
        # silently prune correct descents) - backfill from the points
        from pose_refine.scene.kdtree import ensure_leaf_bboxes

        fixed = ensure_leaf_bboxes(
            np.asarray(kwargs["points"]), np.asarray(kwargs["child"]),
            np.asarray(kwargs["bounds"]), np.asarray(kwargs["bbox"]),
        )
        kwargs["bbox"] = fixed if meta["kind"] == "KDTree" else jnp.asarray(fixed)
    return cls(**kwargs)
