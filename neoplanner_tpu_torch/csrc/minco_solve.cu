// B5: batched banded Givens-QR solve of the 18x18 MINCO system, 2 rhs.
//
// Replaces neoplanner_tpu/ops/minco_pallas.py `_make_kernel` (:37), launched
// by `_solve_batch` (:81). Python wrapper: ops/minco.py `banded_solve`.
//
// Design: one warp per problem, kWarps problems a block, on the warp form of
// the solve that the objective kernels run (neo::warp_givens_solve: the
// system by columns in the warp's shared memory, a lane a column, the
// rotations of column c in registers). The block's threads first load its
// problems' contiguous kWarps x 1,440 B of aug together, 16 B a lane where
// the rows allow it, and scatter each value into its warp's column layout;
// after one barrier each warp solves, and its 36 outputs, contiguous in
// out, go out as one coalesced store of the warp. A warp past the last
// problem returns as a whole warp after the barrier.
//
// Bound on the H100: device memory by the bytes (~2 flops per byte read),
// but what the card can reach is the warp's dependent chain: 62 rotations
// (LBW = 4; 33 at LBW = 2), each with an IEEE square root and a divide, 18
// column syncs and 18 divides of the back substitution. kWarps = 2 spreads
// N = 512 over 256 blocks and N = 1024 over 512, every SM busy.
//
// LBW = 4 is the forward band of A, LBW = 2 the transposed band of A^T.
#include <cuda_runtime.h>
#include <stdint.h>

#include "minco_device.cuh"

namespace {

constexpr int kN = 18;
constexpr int kD = 2;
constexpr int kW = kN + kD;            // columns of aug = [A | b]
constexpr int kS = kN + 1;             // column stride in shared memory
constexpr int kAug = kN * kW;          // floats of one problem's aug (360)
constexpr int kOut = kN * kD;          // floats of one solution (36)
constexpr int kWarps = 2;              // problems a block, one warp each
constexpr int kBlock = 32 * kWarps;
static_assert(kAug % 4 == 0, "a problem's aug is whole float4s");

// value i of the block's aug, at row-major (row, j) of problem w, into that
// warp's column layout
__device__ __forceinline__ void put(float* sys, int i, float v) {
  const int w = i / kAug, rem = i - w * kAug;
  const int row = rem / kW, j = rem - row * kW;
  sys[w * (kW * kS) + j * kS + row] = v;
}

template <int LBW>
__global__ void __launch_bounds__(kBlock)
    minco_banded_solve_kernel(const float* __restrict__ aug,
                              float* __restrict__ out, int n_problems) {
  __shared__ float sys[kWarps * kW * kS];
  __shared__ float diag[kWarps][kN];
  __shared__ float sol[kWarps][kOut];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kWarps;
  const int n_here = min(kWarps, n_problems - p0);
  const float* a = aug + static_cast<long long>(p0) * kAug;
  const int n_vals = n_here * kAug;
  if ((reinterpret_cast<uintptr_t>(aug) & 15) == 0) {
    for (int q = tid; q < n_vals / 4; q += kBlock) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a) + q);
      put(sys, 4 * q, v.x);
      put(sys, 4 * q + 1, v.y);
      put(sys, 4 * q + 2, v.z);
      put(sys, 4 * q + 3, v.w);
    }
  } else {
    for (int i = tid; i < n_vals; i += kBlock) put(sys, i, __ldg(a + i));
  }
  __syncthreads();
  if (warp >= n_here) return;  // the whole warp: no problem left
  neo::warp_givens_solve<kN, kD, LBW, 6>(sys + warp * (kW * kS), diag[warp],
                                         lane, sol[warp]);
  float* o = out + static_cast<long long>(p0 + warp) * kOut;
  for (int i = lane; i < kOut; i += 32) o[i] = sol[warp][i];
}

}  // namespace

extern "C" int neo_minco_banded_solve(const void* aug, void* out,
                                      int n_problems, int lower_bw,
                                      void* stream) {
  if (n_problems <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_problems + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lower_bw == 4) {
    minco_banded_solve_kernel<4><<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(aug), static_cast<float*>(out), n_problems);
  } else if (lower_bw == 2) {
    minco_banded_solve_kernel<2><<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(aug), static_cast<float*>(out), n_problems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
