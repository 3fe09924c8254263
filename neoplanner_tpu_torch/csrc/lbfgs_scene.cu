// B1: the whole L-BFGS solve of one scene-backend trajectory problem per
// thread, with the objective and its hand adjoint (B2, scene_objective.cuh)
// inlined.
//
// Replaces neoplanner_tpu/plan/solve_pallas.py `_make_solver_kernel` (:223)
// and `lbfgs_in_kernel` (:49), launched by `_solve_batch` (:300). Python
// wrapper: plan/solve.py `solve_scene`; plain version: ops/lbfgs.minimize on
// plan/costs.objective.
//
// Semantics are those of ops/lbfgs.minimize: two-loop recursion over a ring
// of HIST pairs, backtracking line search t0 * 0.5^k for k < max_ls taking
// the first Armijo step (else the best finite candidate), a strict decrease
// accepted even without Armijo, the curvature-guarded history update, NaN
// guards, and the ftol / gtol / dead-line-search stop. A problem whose skip
// flag is set returns its start point with f = 0 and iters = 0 (the lazy
// retry bank of plan/expert.warm_start_plan).
//
// Bound on the H100: operations, and per-thread latency. Each objective
// evaluation is ~M*K*n_prims SDF tests (24 primitives x 72 samples) plus two
// 18x18 banded solves, all sequential in one thread; the data read is a few
// hundred bytes per problem. What the TPU kernel needed for SIMD lanes goes:
// no one-hot selects over the ring buffers (plain indexed loads), no f32 loop
// masks, no all-lane exits — each thread stops at its own convergence, and
// the line search stops at its first Armijo step. A problem's primitives are
// staged in the thread's own slice of shared memory, strided by the block
// size so that a warp's 32 loads of one field hit 32 banks.
#include <string.h>

#include "scene_objective.cuh"

namespace {

constexpr int kHist = 10;
constexpr int kBlock = 64;

using neo::kNV;

__global__ void __launch_bounds__(kBlock)
    lbfgs_scene_kernel(const float* __restrict__ x0,
                       const float* __restrict__ head,
                       const float* __restrict__ tail,
                       const float* __restrict__ prims,
                       const int* __restrict__ env_of,
                       const int* __restrict__ skip, float* __restrict__ x_out,
                       float* __restrict__ f_out, int* __restrict__ it_out,
                       int n_problems, int n_prims, int K, int max_iters,
                       int max_ls, neo::SceneParams P) {
  extern __shared__ float smem[];  // [n_prims * 6][blockDim.x]
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  if (p >= n_problems) return;
  const int stride = blockDim.x;

  float x[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) x[i] = x0[p * kNV + i];
  if (skip[p] != 0) {
#pragma unroll
    for (int i = 0; i < kNV; ++i) x_out[p * kNV + i] = x[i];
    f_out[p] = 0.0f;
    it_out[p] = 0;
    return;
  }
  const float* src = prims + static_cast<long long>(env_of[p]) * n_prims * 6;
  for (int i = 0; i < n_prims * 6; ++i) smem[i * stride + tid] = src[i];
  const float* pr = smem + tid;
  float hd[6], tl[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    hd[i] = head[p * 6 + i];
    tl[i] = tail[p * 6 + i];
  }

  float g[kNV];
  float f = neo::scene_objective<true>(x, hd, tl, pr, stride, n_prims, K, P, g);
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
      const float fk = neo::scene_objective<false>(xt, hd, tl, pr, stride,
                                                   n_prims, K, P, unused);
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
    const float f_new = neo::scene_objective<true>(xt, hd, tl, pr, stride,
                                                   n_prims, K, P, g_new);

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
#pragma unroll
  for (int i = 0; i < kNV; ++i) x_out[p * kNV + i] = x[i];
  f_out[p] = f;
  it_out[p] = it;
}

}  // namespace

extern "C" int neo_lbfgs_scene_solve(const void* x0, const void* head,
                                     const void* tail, const void* prims,
                                     const void* env_of, const void* skip,
                                     void* x_out, void* f_out, void* it_out,
                                     int n_problems, int n_prims, int K,
                                     int max_iters, int max_ls,
                                     const float* host_params, void* stream) {
  neo::SceneParams P;
  static_assert(sizeof(neo::SceneParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const size_t smem = static_cast<size_t>(n_prims) * 6 * kBlock * sizeof(float);
  const dim3 block(kBlock);
  const dim3 grid((n_problems + kBlock - 1) / kBlock);
  lbfgs_scene_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(head),
      static_cast<const float*>(tail), static_cast<const float*>(prims),
      static_cast<const int*>(env_of), static_cast<const int*>(skip),
      static_cast<float*>(x_out), static_cast<float*>(f_out),
      static_cast<int*>(it_out), n_problems, n_prims, K, max_iters, max_ls, P);
  return static_cast<int>(cudaGetLastError());
}
