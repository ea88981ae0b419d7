"""Model assets: mesh loading and procedural fixtures.

In this domain a "model" is a rigid-object triangle mesh (the reference's
cuda_renderer::Model); the implementation lives in pose_refine.mesh and
is re-exported here as the canonical import point.
"""

from pose_refine.mesh import (  # noqa: F401
    Model,
    load_ply,
    save_ply_ascii,
    load_benchmark_model,
    find_reference_ply,
    make_icosphere,
    make_bumpy_sphere,
    morton_order,
    simplify_vertex_clustering,
)
