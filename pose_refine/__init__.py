"""pose_refine: 6D pose refinement on the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
meiqua/pose_refine: batch depth rasterization of pose hypotheses plus
point-to-plane ICP (projective and nearest-neighbor association), expressed
as one jitted, vmap-batched program per pose batch.
"""

from pose_refine import geometry  # noqa: F401
from pose_refine.mesh import (  # noqa: F401
    Model,
    load_gltf,
    load_obj,
    load_ply,
    load_stl,
    make_icosphere,
    simplify_vertex_clustering,
)
from pose_refine.geometry import compute_proj, sample_hypotheses, LINEMOD_K  # noqa: F401
from pose_refine.ops import (  # noqa: F401
    render,
    rasterize_dense,
    rasterize_scatter,
    raw_to_depth_u16,
    raw_to_mask_u8,
    raw_to_depth_mask,
)
from pose_refine.ops.depth_to_cloud import depth_to_cloud  # noqa: F401
from pose_refine.icp import (  # noqa: F401
    ICPConvergenceCriteria,
    RegistrationResult,
    icp_point_to_plane,
    icp_point_to_plane_batch,
    icp_point_to_point,
    pose_information,
    pose_covariance,
    PoseUncertainty,
)
from pose_refine.scene import (  # noqa: F401
    SceneProjective,
    SceneProjectiveStack,
    SceneNN,
    SceneNNStack,
    KDTree,
    build_kdtree,
)
from pose_refine.utils.fusion import PoseTracker  # noqa: F401
from pose_refine.tracking import (  # noqa: F401
    MultiObjectSession,
    TrackingSession,
    TrackStep,
)
from pose_refine.api import PoseRenderer, get_bbox  # noqa: F401
from pose_refine.pipeline import (  # noqa: F401
    MultiModelRefiner,
    PendingResult,
    PoseRefiner,
    fence,
    refine_poses_jit,
)

__version__ = "0.2.0"
