// B9 (fused): log-odds -> binarize -> truncated EDT -> bf16, per env; and
// B9 (banded): occupancy -> truncated EDT -> f32, the same device code with
// an f32 store.
//
// B9 fused replaces neoplanner_tpu/ops/edt_pallas.py
// `_make_fused_trunc_kernel` (:153), launched by `_fused_trunc_flat` (:187)
// through `rebuild_truncated_lite` (:203). Python wrapper: ops/edt.py
// `rebuild_truncated_lite`; plain version: the pass chain of the same
// module (binarize, `_row_distance_sq`, `_pass2_banded`, sqrt, clamp, bf16).
//
// B9 banded replaces edt_pallas.py `_make_banded_kernel` (:56), launched by
// `pass2_banded` (:98) for `ops/edt.edt_truncated` (:105-109), with the row
// pass and the sqrt/clamp of `edt_truncated` in the same launch (as B9
// fused does). The TPU kernel padded the rows outside the map with 1e9 and
// clamped g2 at R^2; here they read (R+1)^2, which never wins against the
// R^2 ceiling either. Python wrapper: ops/edt.py `edt_truncated`; plain
// version: `_truncated_plain` there.
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
// Bound on the H100: device memory, 6 B per cell (f32 in, bf16 out; 8 B for
// B9 banded's f32 out) against the ~20 operations per cell that a truncated
// transform needs; this kernel does ~4(2R+1) integer min/add per cell, and
// the halo re-reads 2R/kTile of the grid from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = 256;

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename OutT>
__global__ void __launch_bounds__(kBlock)
    edt_trunc_kernel(const float* __restrict__ lo, OutT* __restrict__ out,
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
    store(out + static_cast<long long>(e) * H * W + gr * W + c,
          fminf(dist, max_dist));
  }
}

template <typename OutT>
int launch(const void* grid, void* out, int n_envs, int H, int W, int R,
           const float* host_params, void* stream) {
  // host_params: [threshold, resolution, max_dist]
  const int rows = kTile + 2 * R;
  const size_t smem = ((static_cast<size_t>(rows) * W + 1) & ~size_t(1)) +
                      static_cast<size_t>(rows) * W * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_trunc_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_dim((H + kTile - 1) / kTile, n_envs);
  edt_trunc_kernel<OutT><<<grid_dim, kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<OutT*>(out), H, W, R,
      host_params[0], host_params[1], host_params[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int neo_edt_trunc_lite(const void* logodds, void* out, int n_envs,
                                  int H, int W, int R, const float* host_params,
                                  void* stream) {
  return launch<__nv_bfloat16>(logodds, out, n_envs, H, W, R, host_params,
                               stream);
}

extern "C" int neo_edt_banded(const void* grid, void* out, int n_envs, int H,
                              int W, int R, const float* host_params,
                              void* stream) {
  return launch<float>(grid, out, n_envs, H, W, R, host_params, stream);
}
