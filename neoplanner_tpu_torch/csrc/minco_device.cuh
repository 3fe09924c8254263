// Device helpers shared by the port's kernels: the MINCO basis constants, the
// banded Givens-QR solve (B5, and the forward/transposed solves inside B1),
// and the footprint SDF over a scene's primitives (B1's collision term and
// B3's closed-loop metric).
//
// Counterparts of neoplanner_tpu/plan/costs_pallas.py `_solve_entries` (:124)
// and `_scene_min_dist` (:153), and of ops/minco_pallas.py `_make_kernel`.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace neo {

constexpr float kFar = 1e4f;

// j!/(j-k)! for d^k/dt^k t^j, zero where j < k
__host__ __device__ constexpr float falling(int k, int j) {
  if (j < k) return 0.0f;
  float out = 1.0f;
  for (int s = 0; s < k; ++s) out *= static_cast<float>(j - s);
  return out;
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float sgn(float v) {
  return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// Solve the banded system held in rows[N][N + D] (A | b) in place by Givens
// QR, then back-substitute into x[N][D]. A has LBW sub-diagonals; QR fills
// the upper band to FILL. Only band entries are touched: the rotation at
// column c changes columns [c, c + FILL] of rows c and r, and entries left
// of the diagonal are never read again — the same values, for every entry
// that is read, as the full-row rotation of minco._givens_solve.
template <int N, int D, int LBW, int FILL>
__device__ __forceinline__ void banded_givens_solve(float (&rows)[N][N + D],
                                                    float (&x)[N][D]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int r = c + 1; r < cmin(c + LBW + 1, N); ++r) {
      const float a_cc = rows[c][c];
      const float a_rc = rows[r][c];
      const float denom = sqrtf(a_cc * a_cc + a_rc * a_rc);
      const bool safe = denom > 1e-20f;
      const float inv = safe ? 1.0f / denom : 0.0f;
      const float cs = safe ? a_cc * inv : 1.0f;
      const float sn = a_rc * inv;
#pragma unroll
      for (int j = c; j < cmin(c + FILL + 1, N); ++j) {
        const float rc = rows[c][j], rr = rows[r][j];
        rows[c][j] = cs * rc + sn * rr;
        rows[r][j] = cs * rr - sn * rc;
      }
#pragma unroll
      for (int j = N; j < N + D; ++j) {
        const float rc = rows[c][j], rr = rows[r][j];
        rows[c][j] = cs * rc + sn * rr;
        rows[r][j] = cs * rr - sn * rc;
      }
    }
  }
#pragma unroll
  for (int c = N - 1; c >= 0; --c) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float acc = rows[c][N + d];
#pragma unroll
      for (int j = c + 1; j < cmin(c + FILL + 1, N); ++j)
        acc = acc - rows[c][j] * x[j][d];
      x[c][d] = acc / rows[c][c];
    }
  }
}

// Minimum footprint SDF over one env's primitives at (px, py), and with
// GRAD the gradient of the argmin primitive (mapping/scene.sample). The
// primitives are six floats each [cx, cy, hx, hy, is_cyl, active], element
// e of primitive k at pr[(6 * k + e) * stride] — a thread's slice of a
// block's shared-memory table. Ties keep the first primitive, as argmin.
template <bool GRAD>
__device__ __forceinline__ float scene_min_dist(const float* pr, int stride,
                                                int n_prims, float px,
                                                float py, float* gx,
                                                float* gy) {
  float dis = kFar;
  if (GRAD) {
    *gx = 0.0f;
    *gy = 0.0f;
  }
  for (int k = 0; k < n_prims; ++k) {
    const float* p = pr + 6 * k * stride;
    if (!(p[5 * stride] > 0.5f)) continue;  // inactive: reads as kFar
    const float cx = p[0], cy = p[stride];
    const float hx = p[2 * stride], hy = p[3 * stride];
    const bool is_cyl = p[4 * stride] > 0.5f;
    const float dx = px - cx, dy = py - cy;
    const float qx = fabsf(dx) - hx, qy = fabsf(dy) - hy;
    const float qxp = fmaxf(qx, 0.0f), qyp = fmaxf(qy, 0.0f);
    const float nrm = sqrtf(qxp * qxp + qyp * qyp);
    const float r = sqrtf(dx * dx + dy * dy);
    const float dk = is_cyl ? r - hx : nrm + fminf(fmaxf(qx, qy), 0.0f);
    if (dk < dis) {
      dis = dk;
      if (GRAD) {
        if (is_cyl) {
          const float inv_r = 1.0f / fmaxf(r, 1e-9f);
          *gx = dx * inv_r;
          *gy = dy * inv_r;
        } else if (nrm > 1e-9f) {
          const float inv_n = 1.0f / fmaxf(nrm, 1e-9f);
          *gx = sgn(dx) * qxp * inv_n;
          *gy = sgn(dy) * qyp * inv_n;
        } else {
          const bool ax = qy > qx;
          *gx = ax ? 0.0f : sgn(dx);
          *gy = ax ? sgn(dy) : 0.0f;
        }
      }
    }
  }
  return dis;
}

}  // namespace neo
