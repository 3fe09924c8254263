// The L-BFGS loop of one trajectory problem per warp, shared by B1
// (lbfgs_scene.cu, the scene SDF) and B6 (lbfgs_grid.cu, the ESDF window):
// the port of neoplanner_tpu/plan/solve_pallas.py `lbfgs_in_kernel` (:49).
//
// Semantics are those of ops/lbfgs.minimize: two-loop recursion over a ring
// of `hist` pairs (the history H, 1..kMaxHist, a run-time count),
// backtracking line search t0 * 0.5^k for k < max_ls taking the first
// Armijo step (else the best finite candidate), a strict decrease
// accepted even without Armijo, the curvature-guarded history update, NaN
// guards, and the ftol / gtol / dead-line-search stop. What the TPU loop
// needed for SIMD lanes goes: no one-hot selects over the ring buffers
// (plain indexed loads), no f32 loop masks, no all-lane exits; each warp
// stops at its own convergence and the line search at its first Armijo step.
//
// Every lane of the warp runs this loop on the same values: the vectors
// of 3M - 2 (x, g, the direction) are registers (7 at M = 3; past M = 5
// some are spilled to local memory, ptxas_report.py), and warp_objective
// hands every lane the same f and g bit for bit. So every branch here —
// Armijo, accept, done, the descent-direction reset, the NaN guards — is
// decided alike on all lanes and never splits the warp around
// warp_objective's syncs. The ring of (s, y, rho) and the two-loop
// recursion's alphas live in the warp's slice of shared memory (read as
// broadcasts, written by lane 0), not in per-thread local memory, beside
// warp_objective's scratch; the launch sizes that slice for H
// (warp_floats).
#pragma once

#include "objective.cuh"

namespace neo {

constexpr int kMaxHist = 32;
// floats of the ring in a warp's shared memory: s and y (hist x kNV), rho
// and the alphas (hist each)
__host__ __device__ constexpr int ring_floats(int hist) {
  return 2 * hist * kNV + 2 * hist;
}
// a warp's shared memory: the ring, then warp_objective's scratch
// (plan/solve.py `warp_floats` mirrors the count)
__host__ __device__ constexpr int warp_floats(int hist) {
  return ring_floats(hist) + kScratchFloats;
}

// Minimize the objective over query from x (updated in place); writes the
// final value to *f_out and the iterations spent to *it_out. Called by all
// 32 lanes of a warp with the same arguments; ring is the warp's own
// warp_floats(hist) of shared memory.
template <class Query>
__device__ __forceinline__ void lbfgs_solve(float (&x)[kNV],
                                            const float (&hd)[6],
                                            const float (&tl)[6],
                                            const Query& query, int K,
                                            int max_iters, int max_ls,
                                            int hist, const SolveParams& P,
                                            float* ring,
                                            int lane, float* f_out,
                                            int* it_out) {
  float* s_hist = ring;                  // [hist][kNV]
  float* y_hist = ring + hist * kNV;     // [hist][kNV]
  float* rho = ring + 2 * hist * kNV;    // [hist]
  float* alphas = rho + hist;            // [hist], by steps back
  float* scratch = ring + ring_floats(hist);  // warp_objective's
  float g[kNV], xt[kNV], d[kNV], g_new[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) xt[i] = x[i];
  float f = 0.0f;
  int head_i = 0, count = 0, it = 0;
  bool first = true, accept = false, ls_ok = false;

  // One value-and-gradient evaluation a pass, at the start point first and
  // then at each iteration's new point, so that the loop holds one copy of
  // each objective form. After a first-Armijo step the line search's last
  // evaluation was at that very point, and its coefficients are reused.
  for (;;) {
    const float f_new = warp_objective<true>(xt, hd, tl, query, K, P, lane,
                                             scratch, g_new, ls_ok);
    float gmax_new = 0.0f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) gmax_new = fmaxf(gmax_new, fabsf(g_new[i]));
    bool done;
    if (first) {
      done = isnan(f_new) || gmax_new <= P.gtol;
      first = false;
    } else {
      // ---- curvature-guarded history update
      float ys = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) ys += (g_new[i] - g[i]) * (xt[i] - x[i]);
      if (accept && ys > 1e-10f) {
        __syncwarp();  // every lane is done reading the slot's old pair
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kNV; ++i) {
            s_hist[head_i * kNV + i] = xt[i] - x[i];
            y_hist[head_i * kNV + i] = g_new[i] - g[i];
          }
          rho[head_i] = 1.0f / fmaxf(ys, 1e-20f);
        }
        __syncwarp();
        head_i = (head_i + 1) % hist;
        count = min(count + 1, hist);
      }
      const float f_drop =
          (f - f_new) / fmaxf(fmaxf(fabsf(f), fabsf(f_new)), 1.0f);
      done = (f_drop <= P.ftol && accept) || gmax_new <= P.gtol || !accept ||
             isnan(f_new);
      ++it;
    }
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      x[i] = xt[i];
      g[i] = g_new[i];
    }
    f = f_new;
    if (done || it >= max_iters) break;

    // ---- two-loop recursion; pair ii steps back is ring slot
    // head_i-1-ii, its alpha at alphas[ii]
    float q[kNV];
#pragma unroll
    for (int i = 0; i < kNV; ++i) q[i] = g[i];
#pragma unroll 1
    for (int ii = 0; ii < count; ++ii) {
      const int idx = (head_i - 1 - ii + hist) % hist;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) sq += s_hist[idx * kNV + i] * q[i];
      const float alpha = rho[idx] * sq;
#pragma unroll
      for (int i = 0; i < kNV; ++i)
        q[i] = q[i] - alpha * y_hist[idx * kNV + i];
      if (lane == 0) alphas[ii] = alpha;
    }
    __syncwarp();  // the alphas, for every lane
    float gamma = 1.0f;
    if (count > 0) {
      const int nw = (head_i - 1 + hist) % hist;
      float sy = 0.0f, yy = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        sy += s_hist[nw * kNV + i] * y_hist[nw * kNV + i];
        yy += y_hist[nw * kNV + i] * y_hist[nw * kNV + i];
      }
      gamma = sy / fmaxf(yy, 1e-20f);
    }
#pragma unroll
    for (int i = 0; i < kNV; ++i) d[i] = gamma * q[i];
#pragma unroll 1
    for (int ii = count - 1; ii >= 0; --ii) {  // oldest pair first
      const int idx = (head_i - 1 - ii + hist) % hist;
      float yr = 0.0f;
#pragma unroll
      for (int i = 0; i < kNV; ++i) yr += y_hist[idx * kNV + i] * d[i];
      const float beta = rho[idx] * yr;
#pragma unroll
      for (int i = 0; i < kNV; ++i)
        d[i] = d[i] + s_hist[idx * kNV + i] * (alphas[ii] - beta);
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
    ls_ok = false;
    float t_cur = t0, t_sel = 0.0f, f_try = INFINITY, t_best = 0.0f;
    float f_best = INFINITY;
    for (int k = 0; k < max_ls && !ls_ok; ++k) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) xt[i] = __fmaf_rn(t_cur, d[i], x[i]);
      const float fk = warp_objective<false>(xt, hd, tl, query, K, P, lane,
                                             scratch, g_new);
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
    accept = ls_ok || (f_try < f);
    if (!ls_ok) {  // at a first-Armijo step xt is already x + t_sel d
#pragma unroll
      for (int i = 0; i < kNV; ++i)
        xt[i] = accept ? __fmaf_rn(t_sel, d[i], x[i]) : x[i];
    }
  }
  *f_out = f;
  *it_out = it;
}

}  // namespace neo
