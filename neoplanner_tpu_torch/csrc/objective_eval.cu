// B2s and B7: one evaluation of the trajectory objective per problem, the
// value alone (the line search's candidates) or the value and its gradient
// (the accepted point), over the scene SDF (B2s) or a per-env ESDF window
// (B7). The per-evaluation solve (plan/solve.py `solve_per_eval`) drives
// them from ops/lbfgs.minimize, as the JAX package's per-evaluation branch
// of plan/expert.solve_one (expert.py:148-167, :193-204) does.
//
// Replaces:
// - B2s, neoplanner_tpu/plan/costs_pallas.py `_make_kernels` (:514):
//   `fwd_kernel` (called at :591) and `valgrad_kernel` (called at :609);
// - B7, neoplanner_tpu/plan/costs_pallas_grid.py K1 `_make_k1` (:79, called
//   at :129), K2 `_make_k2` (:183, called at :272) and K3 `_make_k3` (:94,
//   called at :162), with the XLA glue between them (`_window_coords` :304,
//   the out-of-map FAR and the hinge cotangents, :322-356).
// Python wrappers: plan/objective.py; plain versions: plan/costs.objective,
// with autograd for the gradient.
//
// Design: one thread per problem calls neo::objective<GRAD, Query>
// (objective.cuh), the thread form of the B2 device code whose warp form B1
// and B6 inline (both forms call the same per-sample, energy and adjoint
// functions), with the scene query or the window query (window_query.cuh). A null g_out selects the forward
// kernel. B7's chain K1 -> K2 -> K3 was three programs only because the
// TPU's tiles split the MINCO algebra (flat 512-lane tiles) from the window
// sampling (env-tiled one-hot MXU matmuls): here one thread streams over its
// samples, each tap four indexed loads, and accumulates the value and the
// cotangents as it goes, so the positions, distances and collision
// cotangents that crossed HBM between K1, K2 and K3 are never stored. The
// scene kernel stages each thread's primitives in its own slice of shared
// memory, strided by the block size.
//
// Bound on the H100: operations — per problem ~M*K samples (x 24
// primitives, or 4 window taps) and one (value) or two (value and
// gradient) 18x18 banded solves, from ~100 bytes of input. One thread per
// problem is the simple form, kept here; the warp form of B1 and B6 (a
// warp per problem, the samples over its lanes) is the faster one.
#include <string.h>

#include "objective.cuh"
#include "window_query.cuh"

namespace {

constexpr int kBlock = 64;

using neo::kNV;

template <bool GRAD, class Query>
__device__ __forceinline__ void evaluate(int p, const float* __restrict__ x,
                                         const float* __restrict__ head,
                                         const float* __restrict__ tail,
                                         const Query& query, int K,
                                         const neo::SolveParams& P,
                                         float* __restrict__ f_out,
                                         float* __restrict__ g_out) {
  float xv[kNV], hd[6], tl[6], g[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) xv[i] = x[p * kNV + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    hd[i] = head[p * 6 + i];
    tl[i] = tail[p * 6 + i];
  }
  f_out[p] = neo::objective<GRAD>(xv, hd, tl, query, K, P, g);
  if (GRAD) {
#pragma unroll
    for (int i = 0; i < kNV; ++i) g_out[p * kNV + i] = g[i];
  }
}

template <bool GRAD>
__global__ void __launch_bounds__(kBlock)
    objective_scene_kernel(const float* __restrict__ x,
                           const float* __restrict__ head,
                           const float* __restrict__ tail,
                           const float* __restrict__ prims,
                           const int* __restrict__ env_of,
                           float* __restrict__ f_out,
                           float* __restrict__ g_out, int n_problems,
                           int n_prims, int K, neo::SolveParams P) {
  extern __shared__ float smem[];  // [n_prims * 6][blockDim.x]
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  if (p >= n_problems) return;
  const int stride = blockDim.x;
  const float* src = prims + static_cast<long long>(env_of[p]) * n_prims * 6;
  for (int i = 0; i < n_prims * 6; ++i) smem[i * stride + tid] = src[i];
  const neo::SceneQuery query{smem + tid, stride, n_prims};
  evaluate<GRAD>(p, x, head, tail, query, K, P, f_out, g_out);
}

template <bool GRAD>
__global__ void __launch_bounds__(kBlock)
    objective_grid_kernel(const float* __restrict__ x,
                          const float* __restrict__ head,
                          const float* __restrict__ tail,
                          const float* __restrict__ win,
                          const float* __restrict__ worg,
                          const int* __restrict__ env_of,
                          float* __restrict__ f_out,
                          float* __restrict__ g_out, int n_problems, int Hw,
                          int Ww, int K, neo::SolveParams P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_problems) return;
  const neo::WindowQuery query =
      neo::window_query(win, worg, env_of[p], Hw, Ww);
  evaluate<GRAD>(p, x, head, tail, query, K, P, f_out, g_out);
}

neo::SolveParams params(const float* host_params) {
  neo::SolveParams P;
  static_assert(sizeof(neo::SolveParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  return P;
}

}  // namespace

extern "C" int neo_objective_scene(const void* x, const void* head,
                                   const void* tail, const void* prims,
                                   const void* env_of, void* f_out,
                                   void* g_out, int n_problems, int n_prims,
                                   int K, const float* host_params,
                                   void* stream) {
  const neo::SolveParams P = params(host_params);
  const size_t smem = static_cast<size_t>(n_prims) * 6 * kBlock * sizeof(float);
  const dim3 block(kBlock);
  const dim3 grid((n_problems + kBlock - 1) / kBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* hp = static_cast<const float*>(head);
  const auto* tp = static_cast<const float*>(tail);
  const auto* pr = static_cast<const float*>(prims);
  const auto* ep = static_cast<const int*>(env_of);
  auto* fp = static_cast<float*>(f_out);
  auto* gp = static_cast<float*>(g_out);
  if (gp != nullptr)
    objective_scene_kernel<true><<<grid, block, smem, s>>>(
        xp, hp, tp, pr, ep, fp, gp, n_problems, n_prims, K, P);
  else
    objective_scene_kernel<false><<<grid, block, smem, s>>>(
        xp, hp, tp, pr, ep, fp, gp, n_problems, n_prims, K, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neo_objective_grid(const void* x, const void* head,
                                  const void* tail, const void* win,
                                  const void* worg, const void* env_of,
                                  void* f_out, void* g_out, int n_problems,
                                  int Hw, int Ww, int K,
                                  const float* host_params, void* stream) {
  const neo::SolveParams P = params(host_params);
  const dim3 block(kBlock);
  const dim3 grid((n_problems + kBlock - 1) / kBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* hp = static_cast<const float*>(head);
  const auto* tp = static_cast<const float*>(tail);
  const auto* wp = static_cast<const float*>(win);
  const auto* op = static_cast<const float*>(worg);
  const auto* ep = static_cast<const int*>(env_of);
  auto* fp = static_cast<float*>(f_out);
  auto* gp = static_cast<float*>(g_out);
  if (gp != nullptr)
    objective_grid_kernel<true><<<grid, block, 0, s>>>(
        xp, hp, tp, wp, op, ep, fp, gp, n_problems, Hw, Ww, K, P);
  else
    objective_grid_kernel<false><<<grid, block, 0, s>>>(
        xp, hp, tp, wp, op, ep, fp, gp, n_problems, Hw, Ww, K, P);
  return static_cast<int>(cudaGetLastError());
}
