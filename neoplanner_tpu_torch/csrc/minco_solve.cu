// B5: batched banded Givens-QR solve of the (6M)x(6M) MINCO system, 2 rhs.
//
// Replaces neoplanner_tpu/ops/minco_pallas.py `_make_kernel` (:37), launched
// by `_solve_batch` (:81). Python wrapper: ops/minco.py `banded_solve`.
// Built once per piece count M (NEO_M, 2..16) into that M's library
// (_cuda.load_pieces), n = 6M.
//
// Design: one warp per problem, kWarps problems a block, on the warp form of
// the solve that the objective kernels run (neo::warp_givens_solve: the
// band of each column and the right-hand sides in the warp's shared
// memory, column j on lane j % 32, the rotations of column c in
// registers). Each warp loads its problem's n (n + 2) floats of aug, 16 B
// a lane where the rows allow it and kLoads loads in flight a lane before
// their values are scattered into its layout (entries outside the band
// are never read by the solve), then solves, and its 2n outputs,
// contiguous in out, go out as one coalesced store of the warp. No barrier
// spans the block, so a warp past the last problem returns at once (staged
// by the whole block behind one barrier, with the scatter's index
// arithmetic between the loads, the loads' round trips did not overlap:
// 2,866 cycles a block at M = 3 on the H100, by clock64).
//
// Bound on the H100: device memory by the bytes. The solve needs of each
// row only its band and its right-hand sides: in 32 B sectors ~1.3 KB a
// problem at M = 3 and 8.6 KB at M = 16 with the solution, of the dense
// aug's 1,440 and 37,632 B that this kernel reads whole. What the card
// can reach at small M is the warp's dependent chain: per column
// up to LBW rotations, each with an IEEE square root and a divide, n column
// syncs and n divides of the back substitution. kWarps = 2 spreads
// N = 512 over 256 blocks and N = 1024 over 512, every SM busy.
//
// LBW = 4 is the forward band of A, LBW = 2 the transposed band of A^T.
#include <cuda_runtime.h>
#include <stdint.h>

#include "minco_device.cuh"

#ifndef NEO_M
#define NEO_M 3
#endif

namespace {

constexpr int kN = 6 * NEO_M;
constexpr int kD = 2;
constexpr int kFill = 6;               // upper band of R: LBW + UBW
constexpr int kW = kN + kD;            // columns of aug = [A | b]
constexpr int kAug = kN * kW;          // floats of one problem's aug
constexpr int kOut = kN * kD;          // floats of one solution
constexpr int kWarps = 2;              // problems a block, one warp each
constexpr int kBlock = 32 * kWarps;
constexpr int kLoads = 3;              // staging loads in flight a lane
// blocks an SM that __launch_bounds__ asks for: up to M = 3, 29 caps the
// kernel at 35 registers (65,536 / (64 x 29)), where the compiler's own
// choice is 39; at M = 3 on the H100 the cap gives 32, no spill and the
// same time (0.0112 against 0.0111 ms at N = 1024). Past M = 3 the
// compiler's choice stands.
constexpr int kMinBlocks = kN + kD <= 20 ? 29 : 1;
static_assert(kAug % 4 == 0, "a problem's aug is whole float4s");

template <int LBW>
using Band = neo::BandLayout<kN, kD, LBW, kFill>;

// value i of a problem's aug, at row-major (row, j), into its warp's band
// layout; a value outside the band goes to the slot past the layout, which
// the solve never reads (a store either way: no branch)
template <int LBW>
__device__ __forceinline__ void put(float* sys, int i, float v) {
  const int row = i / kW, j = i - row * kW;
  const int off = row - j + kFill;
  sys[j >= kN ? Band<LBW>::rhs(row, j - kN)
              : (off >= 0 && off < Band<LBW>::kBW ? Band<LBW>::at(row, j)
                                                   : Band<LBW>::kFloats)] = v;
}

template <int LBW>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    minco_banded_solve_kernel(const float* __restrict__ aug,
                              float* __restrict__ out, int n_problems) {
  __shared__ float sys[kWarps * (Band<LBW>::kFloats + 1)];
  __shared__ float diag[kWarps][kN];
  __shared__ float sol[kWarps][kOut];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps;
  if (p0 + warp >= n_problems) return;  // the whole warp: no problem left
  float* ws = sys + warp * (Band<LBW>::kFloats + 1);
  const float* a = aug + static_cast<long long>(p0 + warp) * kAug;
  if ((reinterpret_cast<uintptr_t>(aug) & 15) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    constexpr int n4 = kAug / 4;
    for (int q0 = lane; q0 < n4; q0 += 32 * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * 32;
        if (q < n4) v[u] = __ldg(a4 + q);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * 32;
        if (q < n4) {
          put<LBW>(ws, 4 * q, v[u].x);
          put<LBW>(ws, 4 * q + 1, v[u].y);
          put<LBW>(ws, 4 * q + 2, v[u].z);
          put<LBW>(ws, 4 * q + 3, v[u].w);
        }
      }
    }
  } else {
    for (int i = lane; i < kAug; i += 32) put<LBW>(ws, i, __ldg(a + i));
  }
  neo::warp_givens_solve<kN, kD, LBW, kFill>(ws, diag[warp], lane,
                                             sol[warp]);
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
