from pose_refine.ops.rasterize import (  # noqa: F401
    render,
    rasterize_dense,
    rasterize_scatter,
    max_bbox_extent,
    screen_triangles,
)
from pose_refine.ops.convert import (  # noqa: F401
    raw_to_depth_u16,
    raw_to_mask_u8,
    raw_to_depth_mask,
)
# NOTE: the depth_to_cloud *function* is re-exported from the top-level
# package only; re-binding it here would shadow the submodule attribute.
from pose_refine.ops.depth_to_cloud import (  # noqa: F401
    depth_image_to_points,
    compact_points,
    compact_topk,
    window_cloud,
)
from pose_refine.ops.normals import estimate_normals  # noqa: F401
