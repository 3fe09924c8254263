// B6: the whole L-BFGS solve of one sensed-grid trajectory problem per
// thread, on a per-env ESDF window, with the objective and its hand adjoint
// (B2, objective.cuh) inlined.
//
// Replaces neoplanner_tpu/plan/solve_pallas_grid.py
// `_make_grid_solver_kernel` (:46), launched by `_solve_grid_batch` (:276).
// Python wrapper: plan/solve.py `solve_grid`; plain version:
// ops/lbfgs.minimize on plan/costs.objective over mapping/esdf.GridWindow.
// The loop is lbfgs_device.cuh's, shared with B1; only the distance query
// differs. A skipped problem returns its start point with f = 0, iters 0.
//
// The window taps keep the TPU kernel's semantics (`sample`, :60-130):
// u/v = (world - window origin) / res - 0.5, clipped to [0, Hw - 1.001];
// the bilinear value of the four neighbouring cells; a sample outside the
// MAP (worg[3:7]) reads FAR (free); the derivative is zero where the clip
// bites. The one-hot MXU tap matmuls and the lane stacking of the TPU form
// were workarounds for a machine without gathers and do not carry over:
// here a tap is four indexed loads.
//
// Bound on the H100: operations and per-thread latency, as B1: ~100
// objective evaluations of 72 samples (four window loads each) plus two
// 18x18 banded solves, in sequence in one thread, from a 36 KB f32 window
// that several problems of one env share (it stays in L1/L2). Design: one
// thread per problem; the wrapper clusters the live problems of the lazy
// bank into leading warps, so skipped problems cost warps nothing.
#include <string.h>

#include "lbfgs_device.cuh"

namespace {

constexpr int kBlock = 64;

using neo::kNV;

struct WindowQuery {
  const float* win;  // (Hw, Ww) row-major, row = y
  float ox, oy, res, mx0, my0, mx1, my1, umax, vmax;
  int Ww;

  template <bool GRAD>
  __device__ __forceinline__ float dist(float px, float py, float* gx,
                                        float* gy) const {
    const float uraw = (py - oy) / res - 0.5f;
    const float vraw = (px - ox) / res - 0.5f;
    const float u = fminf(fmaxf(uraw, 0.0f), umax);
    const float v = fminf(fmaxf(vraw, 0.0f), vmax);
    const int r0 = static_cast<int>(floorf(u));
    const int c0 = static_cast<int>(floorf(v));
    const float fr = u - static_cast<float>(r0);
    const float fc = v - static_cast<float>(c0);
    const float* w = win + r0 * Ww + c0;
    const float d00 = __ldg(w), d01 = __ldg(w + 1);
    const float d10 = __ldg(w + Ww), d11 = __ldg(w + Ww + 1);
    const float top = d00 * (1.0f - fc) + d01 * fc;
    const float bot = d10 * (1.0f - fc) + d11 * fc;
    const bool out_map = px < mx0 || py < my0 || px >= mx1 || py >= my1;
    if (GRAD) {
      const bool iny = uraw > 0.0f && uraw < umax;
      const bool inx = vraw > 0.0f && vraw < vmax;
      const float ddu = bot - top;
      const float ddv = (d01 - d00) * (1.0f - fr) + (d11 - d10) * fr;
      *gx = (out_map || !inx) ? 0.0f : ddv / res;
      *gy = (out_map || !iny) ? 0.0f : ddu / res;
    }
    return out_map ? neo::kFar : top * (1.0f - fr) + bot * fr;
  }
};

__global__ void __launch_bounds__(kBlock)
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
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_problems) return;
  float x[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) x[i] = x0[p * kNV + i];
  float f = 0.0f;
  int it = 0;
  if (skip[p] == 0) {
    const long long e = env_of[p];
    const float* o = worg + e * 7;
    const WindowQuery query{win + e * Hw * Ww, o[0], o[1], o[2], o[3], o[4],
                            o[5], o[6],
                            // the clip bounds of esdf.sample_bilinear,
                            // rounded from double as the reference does
                            static_cast<float>(Hw - 1.001),
                            static_cast<float>(Ww - 1.001), Ww};
    float hd[6], tl[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      hd[i] = head[p * 6 + i];
      tl[i] = tail[p * 6 + i];
    }
    neo::lbfgs_solve(x, hd, tl, query, K, max_iters, max_ls, P, &f, &it);
  }
#pragma unroll
  for (int i = 0; i < kNV; ++i) x_out[p * kNV + i] = x[i];
  f_out[p] = f;
  it_out[p] = it;
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
  const dim3 grid((n_problems + kBlock - 1) / kBlock);
  lbfgs_grid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(head),
      static_cast<const float*>(tail), static_cast<const float*>(win),
      static_cast<const float*>(worg), static_cast<const int*>(env_of),
      static_cast<const int*>(skip), static_cast<float*>(x_out),
      static_cast<float*>(f_out), static_cast<int*>(it_out), n_problems, Hw,
      Ww, K, max_iters, max_ls, P);
  return static_cast<int>(cudaGetLastError());
}
