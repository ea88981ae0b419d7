// Native kd-tree builder: the host-side runtime component of the NN scene.
//
// The reference builds its kd-tree on the CPU even for the GPU path
// (pcd_scene.cpp:45-184, pcd_scene.cu:5-6); this is our C++ equivalent,
// emitting the same flat SoA arrays as the numpy builder in
// pose_refine/scene/kdtree.py (which doubles as its parity oracle).
// Exposed through ctypes (no pybind11 in the build image).
//
// Semantics (must exactly match kdtree.py for test parity):
//   - split along the widest bbox dimension at the bbox midpoint
//   - ties on the split value alternate right, left, right, ... (the
//     reference's lr_switch toggle, pcd_scene.cpp:118-133)
//   - right-side elements are appended back-to-front (reversed)
//   - split value re-centered to the midpoint of the inter-side gap
//   - level-by-level frontier, children appended in creation order
//   - leaves hold <= leaf_size points

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Builder {
  const float* pts;   // (n, 3)
  int n;
  int leaf_size;

  int32_t* parent;    // (cap,)
  int32_t* child;     // (cap, 2)
  int32_t* split_dim; // (cap,)
  float* split_v;     // (cap,)
  float* bbox;        // (cap, 6)
  int32_t* bounds;    // (cap, 2)
  int64_t* order;     // (n,) permutation: new position -> original index

  std::vector<int64_t> scratch;

  int run() {
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    scratch.resize(n);

    parent[0] = -1;
    child[0] = child[1] = -1;
    bounds[0] = 0;
    bounds[1] = n;
    int n_nodes = 1;

    std::vector<int> frontier{0}, next;
    while (!frontier.empty()) {
      next.clear();
      for (int node : frontier) {
        const int left = bounds[2 * node];
        const int right = bounds[2 * node + 1];

        // bbox of the segment - stored for EVERY node (leaves included):
        // the device traversal prunes with the descend target's bbox
        // (tighter than the reference's current-node check, and leaves
        // are descend targets too)
        float lo[3], hi[3];
        for (int d = 0; d < 3; ++d) {
          lo[d] = std::numeric_limits<float>::max();
          hi[d] = -std::numeric_limits<float>::max();
        }
        for (int i = left; i < right; ++i) {
          const float* p = pts + 3 * order[i];
          for (int d = 0; d < 3; ++d) {
            if (p[d] < lo[d]) lo[d] = p[d];
            if (p[d] > hi[d]) hi[d] = p[d];
          }
        }
        {
          float* bb = bbox + 6 * node;
          bb[0] = lo[0]; bb[1] = hi[0];
          bb[2] = lo[1]; bb[3] = hi[1];
          bb[4] = lo[2]; bb[5] = hi[2];
        }
        if (right - left <= leaf_size) continue;  // stays a leaf

        int dim = 0;
        float span = hi[0] - lo[0];
        for (int d = 1; d < 3; ++d) {
          if (hi[d] - lo[d] > span) { span = hi[d] - lo[d]; dim = d; }
        }
        // float arithmetic to bit-match the numpy builder and the reference
        // (pcd_scene.cpp computes the midpoint in float)
        const float mid = (lo[dim] + hi[dim]) / 2.0f;

        // stable partition with alternating ties; right side reversed
        int li = left, ri = right - 1;
        float split_low = -std::numeric_limits<float>::max();
        float split_high = std::numeric_limits<float>::max();
        bool tie_left = false;  // 1st tie goes right, 2nd left, ...
        for (int i = left; i < right; ++i) {
          const float v = pts[3 * order[i] + dim];
          bool go_left;
          if (v < mid) {
            go_left = true;
          } else if (v == mid) {
            go_left = tie_left;
            tie_left = !tie_left;
          } else {
            go_left = false;
          }
          if (go_left) {
            scratch[li++] = order[i];
            if (v > split_low) split_low = v;
          } else {
            scratch[ri--] = order[i];
            if (v < split_high) split_high = v;
          }
        }
        if (li == left || li == right) {
          // f32-degenerate node (widest extent <= 1 ULP: mid rounded onto
          // the boundary and one side came out empty). An empty child
          // would crash the next level's bbox pass; keep the node as an
          // (oversized) leaf instead, order untouched - bit-matches the
          // numpy builder's guard (scene/kdtree.py).
          continue;
        }
        std::memcpy(order + left, scratch.data() + left,
                    sizeof(int64_t) * (right - left));

        const int c1 = n_nodes, c2 = n_nodes + 1;
        child[2 * node] = c1;
        child[2 * node + 1] = c2;
        split_dim[node] = dim;
        split_v[node] = (split_low + split_high) / 2.0f;

        parent[c1] = node;
        parent[c2] = node;
        child[2 * c1] = child[2 * c1 + 1] = -1;
        child[2 * c2] = child[2 * c2 + 1] = -1;
        split_dim[c1] = split_dim[c2] = 0;
        split_v[c1] = split_v[c2] = 0.0f;
        std::memset(bbox + 6 * c1, 0, sizeof(float) * 12);
        bounds[2 * c1] = left;
        bounds[2 * c1 + 1] = li;
        bounds[2 * c2] = li;
        bounds[2 * c2 + 1] = right;
        n_nodes += 2;
        next.push_back(c1);
        next.push_back(c2);
      }
      frontier.swap(next);
    }
    return n_nodes;
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2n). All output buffers must be preallocated
// for 2n nodes (order: n entries). pts is (n, 3) float32 row-major.
int prt_build_kdtree(const float* pts, int n, int leaf_size,
                     int32_t* parent, int32_t* child, int32_t* split_dim,
                     float* split_v, float* bbox, int32_t* bounds,
                     int64_t* order) {
  if (n <= 0) return 0;
  Builder b{pts, n, leaf_size, parent, child, split_dim,
            split_v, bbox, bounds, order, {}};
  b.parent[0] = -1;
  return b.run();
}

}  // extern "C"
