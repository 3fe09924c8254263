// B5: batched banded Givens-QR solve of the 18x18 MINCO system, 2 rhs.
//
// Replaces neoplanner_tpu/ops/minco_pallas.py `_make_kernel` (:37), launched
// by `_solve_batch` (:81). Python wrapper: ops/minco.py `banded_solve`.
//
// Bound on the H100: device memory (~2 flops per byte read; see the wrapper).
// Design: one thread per problem, the whole factorisation on compile-time
// indices in registers and local memory; a thread past the end returns.
// LBW = 4 is the forward band of A, LBW = 2 the transposed band of A^T.
#include "minco_device.cuh"

namespace {

constexpr int kN = 18;
constexpr int kD = 2;
constexpr int kW = kN + kD;

template <int LBW>
__global__ void __launch_bounds__(128)
    minco_banded_solve_kernel(const float* __restrict__ aug,
                              float* __restrict__ out, int n_problems) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_problems) return;
  const float* a = aug + static_cast<long long>(p) * kN * kW;
  float rows[kN][kW];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < kW; ++j) rows[i][j] = a[i * kW + j];
  float x[kN][kD];
  neo::banded_givens_solve<kN, kD, LBW, 6>(rows, x);
  float* o = out + static_cast<long long>(p) * kN * kD;
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int d = 0; d < kD; ++d) o[i * kD + d] = x[i][d];
}

}  // namespace

extern "C" int neo_minco_banded_solve(const void* aug, void* out,
                                      int n_problems, int lower_bw,
                                      void* stream) {
  const dim3 block(128);
  const dim3 grid((n_problems + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lower_bw == 4) {
    minco_banded_solve_kernel<4><<<grid, block, 0, s>>>(
        static_cast<const float*>(aug), static_cast<float*>(out), n_problems);
  } else if (lower_bw == 2) {
    minco_banded_solve_kernel<2><<<grid, block, 0, s>>>(
        static_cast<const float*>(aug), static_cast<float*>(out), n_problems);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
