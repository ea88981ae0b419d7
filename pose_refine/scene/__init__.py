from pose_refine.scene.projective import (  # noqa: F401
    SceneProjective,
    SceneProjectiveStack,
)
from pose_refine.scene.nn import SceneNN, SceneNNStack  # noqa: F401
from pose_refine.scene.kdtree import KDTree, build_kdtree  # noqa: F401
