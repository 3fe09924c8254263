// B9 (fused): log-odds -> binarize -> truncated EDT -> bf16, per env.
//
// Replaces neoplanner_tpu/ops/edt_pallas.py `_make_fused_trunc_kernel`
// (:153), launched by `_fused_trunc_flat` (:187) through
// `rebuild_truncated_lite` (:203). Python wrapper: ops/edt.py
// `rebuild_truncated_lite`; plain version: the pass chain of the same
// module (binarize, `_row_distance_sq`, `_pass2_banded`, sqrt, clamp, bf16).
//
// With truncation radius R (cells):
//   pass 1 (rows):    g2[i,j] = min_{|d|<=R, occ(i,j+d)} d^2, else (R+1)^2
//   pass 2 (columns): d2[i,j] = min(R^2, min_{|d|<=R} d^2 + g2[i+d,j])
//   out = bf16(min(sqrt(d2) * res, max_dist))
// All of it is integer arithmetic held exactly in f32, then one correctly
// rounded sqrt, one multiply and a round-to-nearest-even bf16 store, so the
// kernel and its plain version agree bit for bit.
//
// The TPU kernel held a whole (H, W) f32 grid in VMEM and did 4R rolls. A
// 192 x 256 f32 grid (196 KB) does not fit one block's default shared
// memory, so a block here takes a tile of kTile output rows of one env and
// stages the tile plus an R-row halo on each side: the binarized rows as
// bytes, then their pass-1 results as uint16 (at most (R+1)^2). Halo rows
// outside the grid read (R+1)^2, as the TPU kernel's masked rolls do.
//
// Bound on the H100: device memory at R = 20 is ~2x below the operations:
// 6 B per cell (f32 in, bf16 out) against ~4(2R+1) integer min/add per cell;
// the halo re-reads 2R/kTile of the grid from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    edt_trunc_kernel(const float* __restrict__ lo, __nv_bfloat16* __restrict__ out,
                     int H, int W, int R, float thr, float res,
                     float max_dist) {
  extern __shared__ unsigned char smem[];
  const int rows = kTile + 2 * R;
  unsigned char* occ = smem;                                    // [rows][W]
  uint16_t* g2 = reinterpret_cast<uint16_t*>(
      smem + ((rows * W + 1) & ~1));                            // [rows][W]
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * kTile - R;  // grid row of staged row 0
  const float* src = lo + static_cast<long long>(e) * H * W;
  const int far2 = (R + 1) * (R + 1);

  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int gr = row0 + i / W;
    occ[i] = (gr >= 0 && gr < H) ? (src[gr * W + i % W] > thr) : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int rr = i / W, c = i % W;
    const int gr = row0 + rr;
    int g = far2;
    if (gr >= 0 && gr < H) {
      const unsigned char* o = occ + rr * W;
      if (o[c]) {
        g = 0;
      } else {
        for (int d = 1; d <= R; ++d) {
          if ((c + d < W && o[c + d]) || (c - d >= 0 && o[c - d])) {
            g = d * d;
            break;
          }
        }
      }
    }
    g2[i] = static_cast<uint16_t>(g);
  }
  __syncthreads();
  const int r2 = R * R;
  for (int i = threadIdx.x; i < kTile * W; i += blockDim.x) {
    const int ti = i / W, c = i % W;
    const int gr = row0 + R + ti;
    if (gr >= H) continue;
    const uint16_t* col = g2 + (R + ti) * W + c;
    int best = min(static_cast<int>(col[0]), r2);
    for (int d = 1; d <= R && d * d < best; ++d)
      best = min(best, d * d + min(static_cast<int>(col[d * W]),
                                   static_cast<int>(col[-d * W])));
    best = min(best, r2);
    const float dist = __fmul_rn(__fsqrt_rn(static_cast<float>(best)), res);
    out[static_cast<long long>(e) * H * W + gr * W + c] =
        __float2bfloat16_rn(fminf(dist, max_dist));
  }
}

}  // namespace

extern "C" int neo_edt_trunc_lite(const void* logodds, void* out, int n_envs,
                                  int H, int W, int R, const float* host_params,
                                  void* stream) {
  // host_params: [threshold, resolution, max_dist]
  const int rows = kTile + 2 * R;
  const size_t smem = ((static_cast<size_t>(rows) * W + 1) & ~size_t(1)) +
                      static_cast<size_t>(rows) * W * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_trunc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((H + kTile - 1) / kTile, n_envs);
  edt_trunc_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logodds), static_cast<__nv_bfloat16*>(out), H,
      W, R, host_params[0], host_params[1], host_params[2]);
  return static_cast<int>(cudaGetLastError());
}
