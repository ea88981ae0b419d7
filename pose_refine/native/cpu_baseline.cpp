// CPU baseline: a reference-algorithm-equivalent renderer + projective ICP.
//
// The upstream project cannot be built here (its Assimp/Eigen deps are not
// in the image), so this standalone implementation of the SAME algorithms
// (scanline depth rasterization per renderer.cpp:190-298 semantics and
// point-to-plane ICP per icp.cpp:125-188 semantics, OpenMP over poses like
// renderer.cpp:272) provides the measured CPU wall-clock that bench.py
// reports against. It is deliberately organized differently from the
// upstream sources (flat arrays, no classes) - it shares semantics, not code.
//
// Exposed via ctypes (pose_refine.native.cpu_baseline_*).

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline void mat4_apply3(const float* m, const float* v, float* out) {
  // rows 0..2 of a row-major 4x4 applied to a point
  for (int r = 0; r < 3; ++r) {
    out[r] = m[4 * r] * v[0] + m[4 * r + 1] * v[1] + m[4 * r + 2] * v[2] + m[4 * r + 3];
  }
}

void raster_pose(const float* tris, int n_tris, const float* pose,
                 const float* proj, int width, int height, int32_t* fb) {
  const float w2 = width / 2.0f, h2 = height / 2.0f;
  for (int t = 0; t < n_tris; ++t) {
    float cam[3][3], scr[3][2], zc[3];
    for (int v = 0; v < 3; ++v) {
      mat4_apply3(pose, tris + 9 * t + 3 * v, cam[v]);
      zc[v] = cam[v][2];
      float pr[3];
      mat4_apply3(proj, cam[v], pr);
      scr[v][0] = pr[0] / zc[v] * w2 + w2;
      scr[v][1] = pr[1] / zc[v] * h2 + h2;
    }
    float bbmin[2] = {FLT_MAX, FLT_MAX}, bbmax[2] = {-FLT_MAX, -FLT_MAX};
    const float cmax[2] = {float(width - 1), float(height - 1)};
    for (int v = 0; v < 3; ++v) {
      for (int j = 0; j < 2; ++j) {
        bbmin[j] = std::max(0.0f, std::min(bbmin[j], scr[v][j]));
        bbmax[j] = std::min(cmax[j], std::max(bbmax[j], scr[v][j]));
      }
    }
    const float ax = scr[0][0], ay = scr[0][1];
    const float bx = scr[1][0], by = scr[1][1];
    const float cx = scr[2][0], cy = scr[2][1];
    const float area2 = (cx - ax) * (by - ay) - (bx - ax) * (cy - ay);
    if (area2 == 0.0f) continue;
    const float inv = 1.0f / area2;
    const int x0 = int(bbmin[0] + 0.5f), y0 = int(bbmin[1] + 0.5f);
    for (int py = y0; py <= int(bbmax[1]); ++py) {
      for (int px = x0; px <= int(bbmax[0]); ++px) {
        const float fx = float(px), fy = float(py);
        const float beta = ((cx - ax) * (fy - ay) - (fx - ax) * (cy - ay)) * inv;
        const float gamma = ((fx - ax) * (by - ay) - (bx - ax) * (fy - ay)) * inv;
        const float alpha = 1.0f - beta - gamma;
        if (alpha < 0 || beta < 0 || gamma < 0) continue;
        const float denom = alpha / zc[0] + beta / zc[1] + gamma / zc[2];
        const float frag = (alpha + beta + gamma) / denom;
        const int32_t d = int32_t(frag + 0.5f);
        int32_t& slot = fb[(height - 1 - py) * width + px];
        if (d < slot) slot = d;
      }
    }
  }
}

}  // namespace

extern "C" {

// Render n_poses depth images (int32 mm, 0 = empty). tris: (n_tris, 3, 3).
// poses: (n_poses, 4, 4). proj: (4, 4). out: (n_poses, height, width).
void cpu_render(const float* tris, int n_tris, const float* poses, int n_poses,
                const float* proj, int width, int height, int32_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int p = 0; p < n_poses; ++p) {
    int32_t* fb = out + size_t(p) * width * height;
    std::fill(fb, fb + size_t(width) * height, INT32_MAX);
    raster_pose(tris, n_tris, poses + 16 * p, proj, width, height, fb);
    for (size_t i = 0; i < size_t(width) * height; ++i) {
      if (fb[i] == INT32_MAX) fb[i] = 0;
    }
  }
}

// Projective point-to-plane ICP for n_poses clouds against one scene.
// clouds: (n_poses, n_pts, 3) float meters (modified in place).
// valid:  (n_poses, n_pts) uint8.
// scene_pcd/scene_nrm: (h, w, 3). K: (3, 3) row-major.
// out_T: (n_poses, 4, 4); out_fit/out_rmse: (n_poses,).
void cpu_icp(float* clouds, const uint8_t* valid, int n_poses, int n_pts,
             const float* scene_pcd, const float* scene_nrm, int sh, int sw,
             const float* K, float max_dist, int max_iter, float rel_fit,
             float rel_rmse, float* out_T, float* out_fit, float* out_rmse) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
#pragma omp parallel for schedule(dynamic)
  for (int p = 0; p < n_poses; ++p) {
    float* cloud = clouds + size_t(p) * n_pts * 3;
    const uint8_t* vmask = valid + size_t(p) * n_pts;
    double T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
    float fit = 0.0f, rmse = 0.0f;
    int n_valid_total = 0;
    for (int i = 0; i < n_pts; ++i) n_valid_total += vmask[i] ? 1 : 0;

    for (int iter = 0; iter <= max_iter; ++iter) {
      double A[36] = {0}, b6[6] = {0};
      double mse = 0.0;
      int count = 0;
      for (int i = 0; i < n_pts; ++i) {
        if (!vmask[i]) continue;
        const float* s = cloud + 3 * i;
        const int ix = int(s[0] / s[2] * fx + cx + 0.5f);
        const int iy = int(s[1] / s[2] * fy + cy + 0.5f);
        if (ix < 0 || iy < 0 || ix >= sw || iy >= sh) continue;
        const float* d = scene_pcd + 3 * (size_t(iy) * sw + ix);
        if (d[2] <= 0 || std::fabs(s[2] - d[2]) > max_dist) continue;
        const float* n = scene_nrm + 3 * (size_t(iy) * sw + ix);
        const float diff[3] = {d[0] - s[0], d[1] - s[1], d[2] - s[2]};
        const float bi = diff[0] * n[0] + diff[1] * n[1] + diff[2] * n[2];
        const float row[6] = {
            s[1] * n[2] - s[2] * n[1], s[2] * n[0] - s[0] * n[2],
            s[0] * n[1] - s[1] * n[0], n[0], n[1], n[2]};
        for (int r = 0; r < 6; ++r) {
          for (int c = r; c < 6; ++c) A[6 * r + c] += double(row[r]) * row[c];
          b6[r] += double(row[r]) * bi;
        }
        mse += double(diff[0]) * diff[0] + double(diff[1]) * diff[1] + double(diff[2]) * diff[2];
        ++count;
      }
      const float prev_fit = fit, prev_rmse = rmse;
      if (count == 0) break;
      fit = float(count) / std::max(n_valid_total, 1);
      rmse = std::sqrt(float(mse / count));
      if (iter == max_iter) break;
      if (std::fabs(fit - prev_fit) < rel_fit && std::fabs(rmse - prev_rmse) < rel_rmse) break;

      // damped 6x6 Cholesky solve: (A + 0.01 I) x = b
      for (int r = 0; r < 6; ++r) {
        for (int c = 0; c < r; ++c) A[6 * r + c] = A[6 * c + r];
        A[6 * r + r] += 0.01;
      }
      double L[36] = {0};
      for (int r = 0; r < 6; ++r) {
        for (int c = 0; c <= r; ++c) {
          double s2 = A[6 * r + c];
          for (int k = 0; k < c; ++k) s2 -= L[6 * r + k] * L[6 * c + k];
          L[6 * r + c] = (r == c) ? std::sqrt(s2) : s2 / L[6 * c + c];
        }
      }
      double y[6], x[6];
      for (int r = 0; r < 6; ++r) {
        double s2 = b6[r];
        for (int k = 0; k < r; ++k) s2 -= L[6 * r + k] * y[k];
        y[r] = s2 / L[6 * r + r];
      }
      for (int r = 5; r >= 0; --r) {
        double s2 = y[r];
        for (int k = r + 1; k < 6; ++k) s2 -= L[6 * k + r] * x[k];
        x[r] = s2 / L[6 * r + r];
      }

      // update = Rz(x2) Ry(x1) Rx(x0) + t, left-composed
      const double cxr = std::cos(x[0]), sxr = std::sin(x[0]);
      const double cyr = std::cos(x[1]), syr = std::sin(x[1]);
      const double czr = std::cos(x[2]), szr = std::sin(x[2]);
      double U[16] = {
          czr * cyr, czr * syr * sxr - szr * cxr, czr * syr * cxr + szr * sxr, x[3],
          szr * cyr, szr * syr * sxr + czr * cxr, szr * syr * cxr - czr * sxr, x[4],
          -syr, cyr * sxr, cyr * cxr, x[5],
          0, 0, 0, 1};
      for (int i = 0; i < n_pts; ++i) {
        float* s = cloud + 3 * i;
        const float nx = float(U[0] * s[0] + U[1] * s[1] + U[2] * s[2] + U[3]);
        const float ny = float(U[4] * s[0] + U[5] * s[1] + U[6] * s[2] + U[7]);
        const float nz = float(U[8] * s[0] + U[9] * s[1] + U[10] * s[2] + U[11]);
        s[0] = nx; s[1] = ny; s[2] = nz;
      }
      double Tn[16];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          double s2 = 0;
          for (int k = 0; k < 4; ++k) s2 += U[4 * r + k] * T[4 * k + c];
          Tn[4 * r + c] = s2;
        }
      std::memcpy(T, Tn, sizeof(T));
    }
    for (int i = 0; i < 16; ++i) out_T[16 * p + i] = float(T[i]);
    out_fit[p] = fit;
    out_rmse[p] = rmse;
  }
}

int cpu_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
