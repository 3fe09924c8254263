// B1: the whole L-BFGS solve of one scene-backend trajectory problem per
// warp, with the objective and its hand adjoint (B2, objective.cuh) inlined.
//
// Replaces neoplanner_tpu/plan/solve_pallas.py `_make_solver_kernel` (:223)
// and `lbfgs_in_kernel` (:49), launched by `_solve_batch` (:300). Python
// wrapper: plan/solve.py `solve_scene`; plain version: ops/lbfgs.minimize on
// plan/costs.objective. The loop is lbfgs_device.cuh's, shared with B6; the
// distance query is the scene SDF. A problem whose skip flag is set returns
// its start point with f = 0 and iters = 0 (the lazy retry bank of
// plan/expert.warm_start_plan). Built once per piece count M (NEO_M); the
// L-BFGS history H (1..32) is a launch argument, and the launch sizes each
// warp's shared memory for it, opted in past 48 KB a block.
//
// Bound on the H100: operations, and one problem's chain of dependent
// steps. A solve is ~50-120 objective evaluations in sequence, each M*K
// samples (72 at M = 3) against 24 primitive slots and one or two 6M x 6M
// banded Givens solves, from a few hundred bytes of input. Design: one warp per problem,
// kWarps problems per block, so that B = 1024 problems keep 1024 warps on
// all 132 SMs. A piece's samples go over the lanes, and each sum is taken
// in sample order by one lane (objective.cuh warp_objective, as in B2s);
// each Givens rotation is one step of the lanes that hold its columns; the
// serial remainder is the rotations' chain, one square root and divide per
// rotation (62 forward, 33 transposed at M = 3), which takes most of a
// solve; the forward solve is skipped where the line search's last
// evaluation was at the accepted point. The env's primitive table is
// staged once in the warp's slice of shared memory and
// read as broadcasts (all lanes test the same primitive at once); the
// L-BFGS ring sits beside it. A skipped problem's warp writes its start
// point and exits, so the lazy retry launch costs about one warp's solve,
// as the first launch does, whatever its skipped share.
#include <string.h>

#include "lbfgs_device.cuh"

namespace {

constexpr int kWarps = 4;  // problems per block, one warp each
constexpr int kBlock = 32 * kWarps;

using neo::kNV;

__global__ void __launch_bounds__(kBlock, 2)
    lbfgs_scene_kernel(const float* __restrict__ x0,
                       const float* __restrict__ head,
                       const float* __restrict__ tail,
                       const float* __restrict__ prims,
                       const int* __restrict__ env_of,
                       const int* __restrict__ skip, float* __restrict__ x_out,
                       float* __restrict__ f_out, int* __restrict__ it_out,
                       int n_problems, int n_prims, int K, int max_iters,
                       int max_ls, int hist, neo::SolveParams P) {
  // per warp: the L-BFGS ring and the objective's scratch, then the env's
  // primitives [n_prims][6]
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_problems) return;  // the whole warp
  float* ring = smem + warp * (neo::warp_floats(hist) + 6 * n_prims);
  float* pr = ring + neo::warp_floats(hist);

  float x[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) x[i] = x0[p * kNV + i];
  float f = 0.0f;
  int it = 0;
  if (skip[p] == 0) {
    const float* src = prims + static_cast<long long>(env_of[p]) * n_prims * 6;
    for (int i = lane; i < n_prims * 6; i += 32) pr[i] = src[i];
    __syncwarp();
    float hd[6], tl[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      hd[i] = head[p * 6 + i];
      tl[i] = tail[p * 6 + i];
    }
    const neo::SceneQuery query{pr, n_prims};
    neo::lbfgs_solve(x, hd, tl, query, K, max_iters, max_ls, hist, P, ring,
                     lane, &f, &it);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kNV; ++i) x_out[p * kNV + i] = x[i];
    f_out[p] = f;
    it_out[p] = it;
  }
}

}  // namespace

extern "C" int neo_lbfgs_scene_solve(const void* x0, const void* head,
                                     const void* tail, const void* prims,
                                     const void* env_of, const void* skip,
                                     void* x_out, void* f_out, void* it_out,
                                     int n_problems, int n_prims, int K,
                                     int max_iters, int max_ls, int hist,
                                     const float* host_params, void* stream) {
  if (hist < 1 || hist > neo::kMaxHist)
    return static_cast<int>(cudaErrorInvalidValue);
  neo::SolveParams P;
  static_assert(sizeof(neo::SolveParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const size_t smem = static_cast<size_t>(neo::warp_floats(hist) +
                                          6 * n_prims) *
                      kWarps * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lbfgs_scene_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kBlock);
  const dim3 grid((n_problems + kWarps - 1) / kWarps);
  lbfgs_scene_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(head),
      static_cast<const float*>(tail), static_cast<const float*>(prims),
      static_cast<const int*>(env_of), static_cast<const int*>(skip),
      static_cast<float*>(x_out), static_cast<float*>(f_out),
      static_cast<int*>(it_out), n_problems, n_prims, K, max_iters, max_ls,
      hist, P);
  return static_cast<int>(cudaGetLastError());
}
