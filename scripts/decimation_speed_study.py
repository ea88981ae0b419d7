"""Does decimating the HYPOTHESIS render mesh buy throughput at no accuracy?

The raster kernel's work scales with triangle blocks (31468 tris = 246
blocks); the reference's own loader advises simplifying >10k-face meshes
(renderer.cpp:50-57 "you may want tools like meshlab..."). We have a
built-in vertex-clustering decimator (mesh.simplify_vertex_clustering).
The SCENE stays full-resolution (it comes from the sensor); only the
rendered hypothesis clouds move by ~cell_size/2, which must stay inside the
~0.6 mm depth-quantization floor to be free.

Gates: recovery, per-case verdict agreement vs the full-mesh run,
ADD-to-truth of recovered poses.
"""
import jax
import jax.numpy as jnp
import numpy as np

from _workload import scene_render, setup, time_median

import pose_refine as prt
from pose_refine.utils.metrics import add_error, rotation_angle_deg

N = 256
model, tris, K, proj, truth, poses = setup(N)
# scene ALWAYS from the full mesh (it plays the sensor)
scene_depth = scene_render(tris, truth, proj)
poses_j = jax.device_put(jnp.asarray(poses))

base_ok = None
for cell in (0.0, 2.0, 3.0, 4.0, 6.0):
    refiner = prt.PoseRefiner(model, K=K, width=640, height=480, render_scale=2,
                              chunk_iters=64, window=128, stride=2,
                              max_points=2048, decimate_mm=cell)
    refiner.set_scene_depth(scene_depth)
    wall, (refined, res) = time_median(lambda: refiner.refine(poses_j))
    refined = np.asarray(refined)
    rot = rotation_angle_deg(refined, truth)
    rec = rot < 3.0
    if base_ok is None:
        base_ok = rec
    adds = add_error(refined, truth, model.vertices)
    flips = np.nonzero(rec != base_ok)[0]
    flip_txt = "" if not len(flips) else (
        " | flips: " + ", ".join(
            f"{i}({'RECOVERS' if rec[i] else 'fails'})" for i in flips)
    )
    print(f"cell {cell:3.1f} mm ({refiner.tris.shape[0]:6d} tris): wall {wall*1000:6.1f} ms "
          f"({N/wall:5.0f} poses/s) | recovered {rec.mean()*100:3.0f}% | verdict agree "
          f"{(rec == base_ok).mean()*100:3.0f}% | ADD(recovered) mean "
          f"{adds[rec].mean():.3f} max {adds[rec].max():.3f} mm{flip_txt}", flush=True)
