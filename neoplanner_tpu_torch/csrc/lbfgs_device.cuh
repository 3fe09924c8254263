// The L-BFGS loop of one trajectory problem per thread, shared by B1
// (lbfgs_scene.cu, the scene SDF) and B6 (lbfgs_grid.cu, the ESDF window):
// the port of neoplanner_tpu/plan/solve_pallas.py `lbfgs_in_kernel` (:49).
//
// Semantics are those of ops/lbfgs.minimize: two-loop recursion over a ring
// of kHist pairs, backtracking line search t0 * 0.5^k for k < max_ls taking
// the first Armijo step (else the best finite candidate), a strict decrease
// accepted even without Armijo, the curvature-guarded history update, NaN
// guards, and the ftol / gtol / dead-line-search stop. What the TPU loop
// needed for SIMD lanes goes: no one-hot selects over the ring buffers
// (plain indexed loads), no f32 loop masks, no all-lane exits; each thread
// stops at its own convergence and the line search at its first Armijo step.
#pragma once

#include "objective.cuh"

namespace neo {

constexpr int kHist = 10;

// Minimize the objective over query from x (updated in place); writes the
// final value to *f_out and the iterations spent to *it_out.
template <class Query>
__device__ __forceinline__ void lbfgs_solve(float (&x)[kNV],
                                            const float (&hd)[6],
                                            const float (&tl)[6],
                                            const Query& query, int K,
                                            int max_iters, int max_ls,
                                            const SolveParams& P,
                                            float* f_out, int* it_out) {
  float g[kNV];
  float f = objective<true>(x, hd, tl, query, K, P, g);
  float gmax = 0.0f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) gmax = fmaxf(gmax, fabsf(g[i]));
  bool done = isnan(f) || gmax <= P.gtol;

  float s_hist[kHist][kNV], y_hist[kHist][kNV], rho[kHist], alphas[kHist];
  int head_i = 0, count = 0, it = 0;
  float d[kNV], xt[kNV], g_new[kNV], unused[kNV];

  for (int itc = 0; itc < max_iters && !done; ++itc) {
    // ---- two-loop recursion
    float q[kNV];
#pragma unroll
    for (int i = 0; i < kNV; ++i) q[i] = g[i];
    for (int ii = 0; ii < kHist; ++ii) {
      const int idx = ((head_i - 1 - ii) % kHist + kHist) % kHist;
      float alpha = 0.0f;
      if (ii < count) {
        float sq = 0.0f;
#pragma unroll
        for (int i = 0; i < kNV; ++i) sq += s_hist[idx][i] * q[i];
        alpha = rho[idx] * sq;
#pragma unroll
        for (int i = 0; i < kNV; ++i) q[i] = q[i] - alpha * y_hist[idx][i];
      }
      alphas[idx] = alpha;
    }
    float gamma = 1.0f;
    if (count > 0) {
      const int nw = ((head_i - 1) % kHist + kHist) % kHist;
      float sy = 0.0f, yy = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        sy += s_hist[nw][i] * y_hist[nw][i];
        yy += y_hist[nw][i] * y_hist[nw][i];
      }
      gamma = sy / fmaxf(yy, 1e-20f);
    }
#pragma unroll
    for (int i = 0; i < kNV; ++i) d[i] = gamma * q[i];
    for (int ii = 0; ii < count; ++ii) {
      const int idx = ((head_i - count + ii) % kHist + kHist) % kHist;
      float yr = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) yr += y_hist[idx][i] * d[i];
      const float beta = rho[idx] * yr;
#pragma unroll
      for (int i = 0; i < kNV; ++i)
        d[i] = d[i] + s_hist[idx][i] * (alphas[idx] - beta);
    }
    float gtd = 0.0f, gg = 0.0f, g1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      d[i] = -d[i];
      gtd += g[i] * d[i];
      gg += g[i] * g[i];
      g1 += fabsf(g[i]);
    }
    if (gtd >= 0.0f || isnan(gtd)) {  // not a descent direction
#pragma unroll
      for (int i = 0; i < kNV; ++i) d[i] = -g[i];
      gtd = -gg;
    }
    const float t0 = (it == 0) ? fminf(1.0f, 1.0f / fmaxf(g1, 1e-12f)) : 1.0f;

    // ---- backtracking line search, stopped at the first Armijo step
    bool ls_ok = false;
    float t_cur = t0, t_sel = 0.0f, f_try = INFINITY, t_best = 0.0f;
    float f_best = INFINITY;
    for (int k = 0; k < max_ls && !ls_ok; ++k) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) xt[i] = x[i] + t_cur * d[i];
      const float fk = objective<false>(xt, hd, tl, query, K, P,
                                            unused);
      if (fk <= f + P.c1 * t_cur * gtd) {
        ls_ok = true;
        t_sel = t_cur;
        f_try = fk;
      }
      const float safe = isnan(fk) ? INFINITY : fk;
      if (safe < f_best) {
        f_best = safe;
        t_best = t_cur;
      }
      t_cur *= 0.5f;
    }
    if (!ls_ok) {
      t_sel = t_best;
      f_try = f_best;
    }
    const bool accept = ls_ok || (f_try < f);
#pragma unroll
    for (int i = 0; i < kNV; ++i) xt[i] = accept ? x[i] + t_sel * d[i] : x[i];
    const float f_new = objective<true>(xt, hd, tl, query, K, P, g_new);

    // ---- curvature-guarded history update
    float ys = 0.0f, gmax_new = 0.0f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      ys += (g_new[i] - g[i]) * (xt[i] - x[i]);
      gmax_new = fmaxf(gmax_new, fabsf(g_new[i]));
    }
    if (accept && ys > 1e-10f) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        s_hist[head_i][i] = xt[i] - x[i];
        y_hist[head_i][i] = g_new[i] - g[i];
      }
      rho[head_i] = 1.0f / fmaxf(ys, 1e-20f);
      head_i = (head_i + 1) % kHist;
      count = min(count + 1, kHist);
    }
    const float f_drop = (f - f_new) / fmaxf(fmaxf(fabsf(f), fabsf(f_new)), 1.0f);
    done = (f_drop <= P.ftol && accept) || gmax_new <= P.gtol || !accept ||
           isnan(f_new);
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      x[i] = xt[i];
      g[i] = g_new[i];
    }
    f = f_new;
    ++it;
  }
  *f_out = f;
  *it_out = it;
}

}  // namespace neo
