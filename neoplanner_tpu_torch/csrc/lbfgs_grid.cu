// B6: the whole L-BFGS solve of one sensed-grid trajectory problem per
// warp, on a per-env ESDF window, with the objective and its hand adjoint
// (B2, objective.cuh) inlined.
//
// Replaces neoplanner_tpu/plan/solve_pallas_grid.py
// `_make_grid_solver_kernel` (:46), launched by `_solve_grid_batch` (:276).
// Python wrapper: plan/solve.py `solve_grid`; plain version:
// ops/lbfgs.minimize on plan/costs.objective over mapping/esdf.GridWindow.
// The loop is lbfgs_device.cuh's, shared with B1; only the distance query
// differs. A skipped problem returns its start point with f = 0, iters 0.
//
// The window taps are csrc/window_query.cuh's (shared with B7): the TPU
// kernel's `sample` (:60-130) with a tap as four indexed loads through the
// read-only cache, unchanged.
//
// Bound on the H100: operations and one problem's chain of dependent
// steps, as B1: ~100 objective evaluations of 72 samples (four window
// loads each) and one or two 18x18 banded solves, in sequence, from a 36 KB
// f32 window that the problems of one env share (it stays in L1/L2).
// Design: B1's, one warp per problem with the samples over its lanes and
// the Givens rotations by columns; the ring in the warp's shared memory.
// A skipped problem's warp exits at once, so the lazy bank needs no
// ordering of its live problems.
#include <string.h>

#include "lbfgs_device.cuh"
#include "window_query.cuh"

namespace {

constexpr int kWarps = 4;  // problems per block, one warp each
constexpr int kBlock = 32 * kWarps;

using neo::kNV;

__global__ void __launch_bounds__(kBlock, 2)
    lbfgs_grid_kernel(const float* __restrict__ x0,
                      const float* __restrict__ head,
                      const float* __restrict__ tail,
                      const float* __restrict__ win,
                      const float* __restrict__ worg,
                      const int* __restrict__ env_of,
                      const int* __restrict__ skip, float* __restrict__ x_out,
                      float* __restrict__ f_out, int* __restrict__ it_out,
                      int n_problems, int Hw, int Ww, int K, int max_iters,
                      int max_ls, neo::SolveParams P) {
  __shared__ float rings[kWarps][neo::kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_problems) return;  // the whole warp
  float x[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) x[i] = x0[p * kNV + i];
  float f = 0.0f;
  int it = 0;
  if (skip[p] == 0) {
    const neo::WindowQuery query =
        neo::window_query(win, worg, env_of[p], Hw, Ww);
    float hd[6], tl[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      hd[i] = head[p * 6 + i];
      tl[i] = tail[p * 6 + i];
    }
    neo::lbfgs_solve(x, hd, tl, query, K, max_iters, max_ls, P, rings[warp],
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

extern "C" int neo_lbfgs_grid_solve(const void* x0, const void* head,
                                    const void* tail, const void* win,
                                    const void* worg, const void* env_of,
                                    const void* skip, void* x_out,
                                    void* f_out, void* it_out, int n_problems,
                                    int Hw, int Ww, int K, int max_iters,
                                    int max_ls, const float* host_params,
                                    void* stream) {
  neo::SolveParams P;
  static_assert(sizeof(neo::SolveParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const dim3 block(kBlock);
  const dim3 grid((n_problems + kWarps - 1) / kWarps);
  lbfgs_grid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(head),
      static_cast<const float*>(tail), static_cast<const float*>(win),
      static_cast<const float*>(worg), static_cast<const int*>(env_of),
      static_cast<const int*>(skip), static_cast<float*>(x_out),
      static_cast<float*>(f_out), static_cast<int*>(it_out), n_problems, Hw,
      Ww, K, max_iters, max_ls, P);
  return static_cast<int>(cudaGetLastError());
}
