// B2: the MINCO objective on the analytic scene SDF and its hand adjoint, as
// __device__ code for one problem per thread. Inlined into B1
// (lbfgs_scene.cu); there is no launch of its own.
//
// Replaces the device functions of neoplanner_tpu/plan/costs_pallas.py:
// `_system_entries` (:90), `_solve_entries` (:124, here
// neo::banded_givens_solve), `_scene_min_dist` (:153), `common_fwd` (:234),
// `fwd_nocoll` (:302), `valgrad_poly` (:330), `scene_valgrad_values` (:483)
// and `scene_value` (:499).
//
// The TPU form keeps (S, 512-lane) sample arrays in VMEM and reduces them at
// the end; here one thread streams over the M*K samples and accumulates the
// value, the duration cotangents and the coefficient cotangents as it goes,
// so nothing per-sample is stored. The adjoint is the reference's hand
// gradient (expert_planner.py:345-537): per-sample penalty cotangents, the
// transposed banded solve lam = A^-T cbar, waypoint gradients from the
// b-rows, dA/dT through d beta_k/dT = beta_{k+1}, and the sigmoid tau chain.
#pragma once

#include "minco_device.cuh"

namespace neo {

constexpr int kM = 3;                     // pieces
constexpr int kDim = 2;                   // planar trajectories
constexpr int kNW = kM - 1;               // intermediate waypoints
constexpr int kNV = kDim * kNW + kM;      // decision variables (7)
constexpr int kNS = 6 * kM;               // system size (18)

struct SceneParams {
  float t_min, t_max, v_max, safe_dis, w_e, w_t, w_f, w_c, ftol, gtol, c1;
};

__device__ __forceinline__ void powers6(float t, float (&p)[6]) {
  p[0] = 1.0f;
#pragma unroll
  for (int i = 1; i < 6; ++i) p[i] = p[i - 1] * t;
}

// A(T) (or its transpose) into the left 18 columns of rows; rhs untouched.
template <bool TRANSPOSE>
__device__ __forceinline__ void build_system(const float (&T)[kM],
                                             float (&rows)[kNS][kNS + 2]) {
#pragma unroll
  for (int i = 0; i < kNS; ++i)
#pragma unroll
    for (int j = 0; j < kNS; ++j) rows[i][j] = 0.0f;
  auto put = [&](int r, int c, float v) {
    if (TRANSPOSE)
      rows[c][r] = v;
    else
      rows[r][c] = v;
  };
  put(0, 0, 1.0f);
  put(1, 1, 1.0f);
  put(2, 2, 2.0f);
  constexpr int ks[6] = {0, 0, 1, 2, 3, 4};
#pragma unroll
  for (int i = 0; i < kM - 1; ++i) {
    float p[6];
    powers6(T[i], p);
    const int c0 = 6 * i, base = 6 * i + 3;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      const int k = ks[rr];
#pragma unroll
      for (int j = k; j < 6; ++j) put(base + rr, c0 + j, falling(k, j) * p[j - k]);
      if (rr >= 1) put(base + rr, c0 + 6 + rr - 1, -falling(rr - 1, rr - 1));
    }
  }
  float p[6];
  powers6(T[kM - 1], p);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = k; j < 6; ++j)
      put(kNS - 3 + k, kNS - 6 + j, falling(k, j) * p[j - k]);
}

// Weighted objective of decision vector x; with GRAD also its gradient g.
// head/tail: [pos; vel; acc] x (x, y), row-major. pr/stride: this thread's
// slice of the block's primitive table (see scene_min_dist).
template <bool GRAD>
__device__ __noinline__ float scene_objective(const float (&x)[kNV], const float (&head)[6],
                                 const float (&tail)[6], const float* pr,
                                 int stride, int n_prims, int K,
                                 const SceneParams& P, float (&g)[kNV]) {
  float sig[kM], T[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float s = 1.0f / (1.0f + expf(-x[kDim * kNW + m]));
    sig[m] = s;
    T[m] = P.t_min + (P.t_max - P.t_min) * s;
  }

  // ---- forward: coefficients of the banded MINCO system
  float rows[kNS][kNS + 2];
  build_system<false>(T, rows);
#pragma unroll
  for (int r = 0; r < kNS; ++r) rows[r][kNS] = rows[r][kNS + 1] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      rows[k][kNS + d] = head[k * kDim + d];
      rows[kNS - 3 + k][kNS + d] = tail[k * kDim + d];
    }
#pragma unroll
  for (int i = 0; i < kNW; ++i) {
    rows[6 * i + 3][kNS] = x[i];
    rows[6 * i + 3][kNS + 1] = x[kNW + i];
  }
  float xs[kNS][kDim];  // coeffs: piece m, power j -> xs[6m + j]
  banded_givens_solve<kNS, kDim, 4, 6>(rows, xs);

  const float gl_nodes[3] = {0.5f - 0.38729833462074170f, 0.5f,
                             0.5f + 0.38729833462074170f};
  const float gl_w[3] = {5.0f / 18.0f, 8.0f / 18.0f, 5.0f / 18.0f};
  float Tbar[kM];
  float cbar[kNS][kDim];
  if (GRAD) {
#pragma unroll
    for (int m = 0; m < kM; ++m) Tbar[m] = 0.0f;
#pragma unroll
    for (int i = 0; i < kNS; ++i) cbar[i][0] = cbar[i][1] = 0.0f;
  }

  // ---- energy: 3-point Gauss-Legendre of |jerk|^2 per piece
  float energy = 0.0f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float t = T[m] * gl_nodes[q];
      const float pw3[3] = {1.0f, t, t * t};
      float jx = 0.0f, jy = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
      for (int j = 3; j < 6; ++j) {
        jx = jx + falling(3, j) * pw3[j - 3] * xs[6 * m + j][0];
        jy = jy + falling(3, j) * pw3[j - 3] * xs[6 * m + j][1];
        if (GRAD && j >= 4) {
          sx = sx + falling(4, j) * pw3[j - 4] * xs[6 * m + j][0];
          sy = sy + falling(4, j) * pw3[j - 4] * xs[6 * m + j][1];
        }
      }
      const float jsq = jx * jx + jy * jy;
      energy = energy + gl_w[q] * T[m] * jsq;
      if (GRAD) {
        Tbar[m] += P.w_e * gl_w[q] *
                   (jsq + T[m] * 2.0f * (jx * sx + jy * sy) * gl_nodes[q]);
        const float scale = P.w_e * gl_w[q] * T[m] * 2.0f;
#pragma unroll
        for (int j = 3; j < 6; ++j) {
          cbar[6 * m + j][0] += scale * jx * falling(3, j) * pw3[j - 3];
          cbar[6 * m + j][1] += scale * jy * falling(3, j) * pw3[j - 3];
        }
      }
    }
  }
  float time_cost = 0.0f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    time_cost = time_cost + T[m];
    if (GRAD) Tbar[m] += P.w_t;
  }

  // ---- sampled feasibility and collision terms, streamed over samples
  float feas = 0.0f, coll = 0.0f;
  const float inv_km1 = 1.0f / static_cast<float>(K - 1);
#pragma unroll 1
  for (int m = 0; m < kM; ++m) {
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float frac = static_cast<float>(k) / static_cast<float>(K - 1);
      const float omg = (k == 0 || k == K - 1) ? 0.5f : 1.0f;
      const float w = omg * T[m] / static_cast<float>(K - 1);
      float pw[6];
      powers6(T[m] * frac, pw);
      float px = 0.0f, py = 0.0f, vx = 0.0f, vy = 0.0f, ax = 0.0f, ay = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float cx = xs[6 * m + j][0], cy = xs[6 * m + j][1];
        px = px + pw[j] * cx;
        py = py + pw[j] * cy;
        if (j >= 1) {
          vx = vx + falling(1, j) * pw[j - 1] * cx;
          vy = vy + falling(1, j) * pw[j - 1] * cy;
        }
        if (GRAD && j >= 2) {
          ax = ax + falling(2, j) * pw[j - 2] * cx;
          ay = ay + falling(2, j) * pw[j - 2] * cy;
        }
      }
      const float hv = fmaxf(vx * vx + vy * vy - P.v_max * P.v_max, 0.0f);
      const float hv2 = hv * hv;
      feas += w * hv * hv2;
      float gsx = 0.0f, gsy = 0.0f;
      const float dis =
          scene_min_dist<GRAD>(pr, stride, n_prims, px, py, &gsx, &gsy);
      const float hc = fmaxf(P.safe_dis - dis, 0.0f);
      const float hc2 = hc * hc;
      coll += w * hc * hc2;
      if (GRAD) {
        const float g_s = P.w_c * w * 3.0f * hc2;
        const float ppx = -g_s * gsx, ppy = -g_s * gsy;
        const float chcw = P.w_c * hc * hc2;
        const float e_s = P.w_f * w * 3.0f * hv2;
        const float pvx = e_s * 2.0f * vx, pvy = e_s * 2.0f * vy;
        Tbar[m] += (omg * inv_km1) * (P.w_f * hv * hv2 + chcw) +
                   (ppx * vx + ppy * vy + pvx * ax + pvy * ay) * frac;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          cbar[6 * m + j][0] += ppx * pw[j];
          cbar[6 * m + j][1] += ppy * pw[j];
          if (j >= 1) {
            cbar[6 * m + j][0] += falling(1, j) * pvx * pw[j - 1];
            cbar[6 * m + j][1] += falling(1, j) * pvy * pw[j - 1];
          }
        }
      }
    }
  }
  const float f =
      P.w_e * energy + P.w_t * time_cost + P.w_f * feas + P.w_c * coll;
  if (!GRAD) return f;

  // ---- adjoint: transposed banded solve lam = A^-T cbar
  build_system<true>(T, rows);
#pragma unroll
  for (int r = 0; r < kNS; ++r) {
    rows[r][kNS] = cbar[r][0];
    rows[r][kNS + 1] = cbar[r][1];
  }
  float lam[kNS][kDim];
  banded_givens_solve<kNS, kDim, 2, 6>(rows, lam);

  // waypoint gradients: the b-row cotangents
#pragma unroll
  for (int i = 0; i < kNW; ++i) {
    g[i] = lam[6 * i + 3][0];
    g[kNW + i] = lam[6 * i + 3][1];
  }
  // Abar = -lam x^T into T through d beta_k / dT = beta_{k+1}
  constexpr int ks[6] = {0, 0, 1, 2, 3, 4};
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float p[6];
    powers6(T[i], p);
    const bool last = (i == kM - 1);
    const int c0 = last ? kNS - 6 : 6 * i;
    const int base = last ? kNS - 3 : 6 * i + 3;
    const int n_rows = last ? 3 : 6;
    float acc = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      if (rr >= n_rows) break;
      const int k = last ? rr : ks[rr];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) {
        const float dA = falling(k + 1, j) * p[j - k - 1];
        const float lx = lam[base + rr][0] * xs[c0 + j][0] +
                         lam[base + rr][1] * xs[c0 + j][1];
        acc = acc - dA * lx;
      }
    }
    Tbar[i] += acc;
  }
  // tau chain
#pragma unroll
  for (int m = 0; m < kM; ++m)
    g[kDim * kNW + m] = Tbar[m] * (P.t_max - P.t_min) * sig[m] * (1.0f - sig[m]);
  return f;
}

}  // namespace neo
