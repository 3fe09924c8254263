// B1: the whole L-BFGS solve of one scene-backend trajectory problem per
// thread, with the objective and its hand adjoint (B2, objective.cuh) inlined.
//
// Replaces neoplanner_tpu/plan/solve_pallas.py `_make_solver_kernel` (:223)
// and `lbfgs_in_kernel` (:49), launched by `_solve_batch` (:300). Python
// wrapper: plan/solve.py `solve_scene`; plain version: ops/lbfgs.minimize on
// plan/costs.objective. The loop is lbfgs_device.cuh's, shared with B6; the
// distance query is the scene SDF. A problem whose skip flag is set returns
// its start point with f = 0 and iters = 0 (the lazy retry bank of
// plan/expert.warm_start_plan).
//
// Bound on the H100: operations, and per-thread latency. Each objective
// evaluation is ~M*K*n_prims SDF tests (24 primitives x 72 samples) plus two
// 18x18 banded solves, all sequential in one thread; the data read is a few
// hundred bytes per problem. A problem's primitives are staged in the
// thread's own slice of shared memory, strided by the block size so that a
// warp's 32 loads of one field hit 32 banks.
#include <string.h>

#include "lbfgs_device.cuh"

namespace {

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
                       int max_ls, neo::SolveParams P) {
  extern __shared__ float smem[];  // [n_prims * 6][blockDim.x]
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  if (p >= n_problems) return;
  const int stride = blockDim.x;

  float x[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) x[i] = x0[p * kNV + i];
  float f = 0.0f;
  int it = 0;
  if (skip[p] == 0) {
    const float* src = prims + static_cast<long long>(env_of[p]) * n_prims * 6;
    for (int i = 0; i < n_prims * 6; ++i) smem[i * stride + tid] = src[i];
    float hd[6], tl[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      hd[i] = head[p * 6 + i];
      tl[i] = tail[p * 6 + i];
    }
    const neo::SceneQuery query{smem + tid, stride, n_prims};
    neo::lbfgs_solve(x, hd, tl, query, K, max_iters, max_ls, P, &f, &it);
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
  neo::SolveParams P;
  static_assert(sizeof(neo::SolveParams) == 11 * sizeof(float), "layout");
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
