// The ESDF kernels B9 exact, B9 fused and B9 banded: one kernel template.
//
//   edt_kernel<float, false>          B9 exact   (csrc/edt_exact.cu)
//   edt_kernel<__nv_bfloat16, true>   B9 fused   (csrc/edt_trunc.cu)
//   edt_kernel<float, true>           B9 banded  (csrc/edt_trunc.cu)
//
// With g2[i,j] the squared distance in cells from (i,j) to the nearest
// occupied cell of row i (cells > thr are occupied), the field is
//   exact:      d2[i,j] = min_k (i-k)^2 + g2[k,j];  out = FAR where no row
//               has an occupied cell, else min(sqrt(d2) * res, FAR)
//   truncated:  d2[i,j] = min(R^2, min_k (i-k)^2 + g2[k,j]);
//               out = min(sqrt(d2) * res, max_dist)
// The truncated d2 equals the plain banded chain of ops/edt.py
// (_pass2_banded over g2 clamped at (R+1)^2, clamped at R^2) cell for
// cell: the row k that attains an exact d2 < R^2 lies within R rows and has
// g2 < R^2, so the band keeps it; where the exact d2 >= R^2 both read R^2.
// So the truncated kernels run the exact column pass over the rows with
// g2 < R^2 and clamp. Integers throughout, then one correctly rounded sqrt
// and one multiply (the build has no --use_fast_math), so every kernel
// equals its plain version bit for bit.
//
// Design: one block per (env, tile of output rows). The exact kernel's tile
// is the whole grid; a truncated kernel's tile is up to kEdtTileRows rows
// plus an R-row halo above and below (one tile, no halo, on grids of up
// to kEdtTileRows rows, as both truncated paths' are).
//  1. Binarise. The block reads each staged row once, 16 B a lane where the
//     rows are 16-byte aligned, and keeps it as occupancy bits in shared
//     memory: one 32-bit word per 32 cells (a 448-cell row is 14 words,
//     1/32 of its f32 bytes). The bits stay in the block, so no pass over
//     device memory writes them and no column strip reads a row again.
//  2. Row pass, per warp and strip of 32 columns (lane <-> column): for
//     each staged row, the distances from the strip's edges to the nearest
//     occupied cell left and right of it (__clz / __ffs over the
//     neighbouring words, at most ceil(R/32) each side in the truncated
//     kernels), a row record of 4 B. Any lane's 1-D distance is then O(1)
//     from the strip's word of the row's bits and that record.
//  3. Column pass, on every warp: each lane builds the lower envelope of
//     the parabolas (i - q)^2 + g2[q] of its column (Felzenszwalb-
//     Huttenlocher) over the rows q that can win. The envelope is a set of
//     rows, kept as a bitmask (one bit a row, 4 B a lane per 32 rows); the
//     top two entries live in registers with h = q^2 + g2[q]. A parabola is
//     dropped when its successor overtakes it no later than it overtook its
//     predecessor, by cross-multiplying the intersections in integers
//     (32-bit within the exact kernel's limits, 64-bit in the truncated
//     ones): no division, and no boundary array. The sweep down the
//     output rows advances along the envelope while the next parabola is no
//     higher, writes the row (a warp stores 32 adjacent cells), and needs
//     O(1) amortised per cell whatever the distances.
// Shared memory per block: 4 B per staged row per word of a row, plus
// 8 B per staged row per warp. Up to kEdtMaxWarps warps a block, as many as
// balance the strips over the warps and fit 227 KB; the launch bound holds
// a thread to 32 registers, so that four blocks of 14 warps (a 448-cell
// row's strips) share an SM.
//
// Bound on the H100: device memory, each cell read once as f32 and written
// once (8 B a cell for B9 exact and B9 banded, 6 B for B9 fused's bf16).
// The kernels run a few times above it, held by the column pass's
// instructions rather than by bytes (PERF.md section 6); hence the
// warp-uniform shortcut for empty strip words in edt_dist.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace neo {

constexpr int kEdtMaxWarps = 16;
constexpr int kEdtTileRows = 256;      // output rows of a truncated tile
constexpr int kEdtSmemMax = 232448;    // the H100's 227 KB a block
constexpr uint32_t kEdtFar = 0x7fff;   // row record: nothing within reach
constexpr int kEdtOpen = 1 << 14;      // exact: any d at or past it is none

__device__ __forceinline__ void edt_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void edt_store(float* p, float v) { *p = v; }

// The lane's 1-D distance in a row from the strip's word of its bits and
// the row record (left | right << 16).
__device__ __forceinline__ int edt_dist(uint32_t word, uint32_t lr,
                                        int lane) {
  const int out = min(lane + static_cast<int>(lr & 0xffffu),
                      static_cast<int>(lr >> 16) - lane);
  if (!word) return out;                    // most strips of a sparse row
  const uint32_t lo = word << (31 - lane);  // bits <= lane, at the top
  const uint32_t hi = word >> lane;         // bits >= lane, at the bottom
  return min(lo ? __clz(lo) : out, hi ? __ffs(hi) - 1 : out);
}

// The next envelope row above x (-1: none); stk: the lane's words, stride 32.
__device__ __forceinline__ int edt_next(const uint32_t* stk, int x, int hw) {
  int w = (x + 1) >> 5;
  if (w >= hw) return -1;
  uint32_t m = stk[w * 32] & (~0u << ((x + 1) & 31));
  while (!m) {
    if (++w >= hw) return -1;
    m = stk[w * 32];
  }
  return 32 * w + __ffs(m) - 1;
}

// The next envelope row below x (-1: none).
__device__ __forceinline__ int edt_prev(const uint32_t* stk, int x) {
  int w = x >> 5;
  uint32_t m = stk[w * 32] & ((1u << (x & 31)) - 1u);
  while (!m) {
    if (--w < 0) return -1;
    m = stk[w * 32];
  }
  return 32 * w + 31 - __clz(m);
}

__host__ __device__ inline int edt_smem_words(int rows, int W, int warps) {
  const int nwp = ((W + 31) / 32) | 1;
  return rows * nwp + warps * (rows + 32 * ((rows + 31) / 32));
}

// One block per (env, tile); T output rows a tile; R the truncation radius
// (0 for exact); dlim: the 1-D distances that can win are those below it;
// r2: R^2; cap: FAR (exact) or max_dist.
template <typename OutT, bool kTrunc>
__global__ void __launch_bounds__(kEdtMaxWarps * 32, 4)
    edt_kernel(const float* __restrict__ grid, OutT* __restrict__ out, int H,
               int W, int T, int R, int dlim, int r2, float thr, float res,
               float cap) {
  // the envelope test's products: below 2^31 on the exact kernel's grids
  // (H, W <= 1024: |h| < 2 * 1023^2, row gaps < 1024), 64-bit otherwise
  using Wide = typename std::conditional<kTrunc, long long, int>::type;
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = (W + 31) >> 5;
  const int nwp = nw | 1;           // odd: lanes on adjacent rows, other banks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long e = blockIdx.x;
  const int out0 = blockIdx.y * T;
  const int out1 = min(H, out0 + T);
  const int r0 = kTrunc ? max(0, out0 - R) : 0;
  const int rows = (kTrunc ? min(H, out1 + R) : H) - r0;
  const int hw = (rows + 31) >> 5;
  uint32_t* bits = smem;                                      // [rows][nwp]
  uint32_t* lr = smem + rows * nwp + warp * (rows + 32 * hw);  // [rows]
  uint32_t* stk = lr + rows + lane;                              // [hw][32]
  const float* src = grid + (e * H + r0) * W;

  // 1. binarise the staged rows, one warp a row
  const bool vec = (W & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(grid) & 15) == 0;
  for (int li = warp; li < rows; li += n_warps) {
    const float* row = src + static_cast<long long>(li) * W;
    uint32_t* brow = bits + li * nwp;
    if (vec) {
#pragma unroll 4
      for (int c0 = 0; c0 < W; c0 += 128) {
        const int c = c0 + 4 * lane;
        uint32_t nib = 0;
        if (c < W) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
          nib = (v.x > thr ? 1u : 0u) | (v.y > thr ? 2u : 0u) |
                (v.z > thr ? 4u : 0u) | (v.w > thr ? 8u : 0u);
        }
        uint32_t word = nib << (4 * (lane & 7));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        const int w = (c0 >> 5) + (lane >> 3);
        if ((lane & 7) == 0 && w < nw) brow[w] = word;
      }
    } else {
      for (int c0 = 0; c0 < W; c0 += 32) {
        const int c = c0 + lane;
        const uint32_t m = __ballot_sync(0xffffffffu, c < W && row[c] > thr);
        if (lane == 0) brow[c0 >> 5] = m;
      }
    }
  }
  __syncthreads();

  const int nb = kTrunc ? (R + 31) >> 5 : nw;   // words searched each side
  for (int s = warp; s < nw; s += n_warps) {
    // 2. the strip's row records, a row a lane
    for (int li = lane; li < rows; li += 32) {
      const uint32_t* b = bits + li * nwp;
      uint32_t left = kEdtFar, right = kEdtFar;
      for (int w = s - 1, stop = max(0, s - nb); w >= stop; --w) {
        const uint32_t x = b[w];
        if (x) {
          left = 32 * (s - w) - 31 + __clz(x);
          break;
        }
      }
      for (int w = s + 1, stop = min(nw - 1, s + nb); w <= stop; ++w) {
        const uint32_t x = b[w];
        if (x) {
          right = 32 * (w - s) + __ffs(x) - 1;
          break;
        }
      }
      lr[li] = left | (right << 16);
    }
    for (int w = 0; w < hw; ++w) stk[w * 32] = 0;
    __syncwarp();

    // 3a. the lower envelope of the lane's column
    int t1 = -1, h1 = 0, t0 = -1, h0 = 0;   // top and the entry below it
    for (int q = 0; q < rows; ++q) {
      const int d = edt_dist(bits[q * nwp + s], lr[q], lane);
      if (d >= dlim) continue;
      const int hq = q * q + d * d;
      while (t0 >= 0 && static_cast<Wide>(hq - h1) * (t1 - t0) <=
                            static_cast<Wide>(h1 - h0) * (q - t1)) {
        stk[(t1 >> 5) * 32] &= ~(1u << (t1 & 31));
        t1 = t0;
        h1 = h0;
        t0 = edt_prev(stk, t0);
        if (t0 >= 0) {
          const int d0 = edt_dist(bits[t0 * nwp + s], lr[t0], lane);
          h0 = t0 * t0 + d0 * d0;
        }
      }
      stk[(q >> 5) * 32] |= 1u << (q & 31);
      t0 = t1;
      h0 = h1;
      t1 = q;
      h1 = hq;
    }

    // 3b. the sweep down the output rows
    int p = edt_next(stk, -1, hw), hp = 0, p2 = -1, hp2 = 0;
    if (p >= 0) {
      const int dp = edt_dist(bits[p * nwp + s], lr[p], lane);
      hp = p * p + dp * dp;
      p2 = edt_next(stk, p, hw);
      if (p2 >= 0) {
        const int d2_ = edt_dist(bits[p2 * nwp + s], lr[p2], lane);
        hp2 = p2 * p2 + d2_ * d2_;
      }
    }
    const int j = 32 * s + lane;
    OutT* dst = out + (e * H + r0) * W + j;
    for (int li = out0 - r0; li < out1 - r0; ++li) {
      while (p2 >= 0 && hp2 - 2 * li * p2 <= hp - 2 * li * p) {
        p = p2;
        hp = hp2;
        p2 = edt_next(stk, p2, hw);
        if (p2 >= 0) {
          const int dn = edt_dist(bits[p2 * nwp + s], lr[p2], lane);
          hp2 = p2 * p2 + dn * dn;
        }
      }
      float v;
      if (kTrunc) {
        const int d2 = p >= 0 ? min(hp - 2 * li * p + li * li, r2) : r2;
        v = fminf(__fmul_rn(__fsqrt_rn(static_cast<float>(d2)), res), cap);
      } else {
        v = p >= 0 ? fminf(__fmul_rn(__fsqrt_rn(static_cast<float>(
                                         hp - 2 * li * p + li * li)),
                                     res),
                           cap)
                   : cap;
      }
      if (j < W) edt_store(dst + static_cast<long long>(li) * W, v);
    }
    __syncwarp();                   // lr and stk are the next strip's
  }
}

// host_params: [threshold, resolution, cap]; R: the truncation radius in
// cells (truncated kernels), ignored by the exact one.
template <typename OutT, bool kTrunc>
int edt_launch(const void* grid, void* out, int n_envs, int H, int W, int R,
               const float* host_params, void* stream) {
  if (n_envs <= 0 || H <= 0 || W <= 0) return 0;
  if (!kTrunc && (H > 1024 || W > 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (W + 31) / 32;
  int tiles = 1, T = H, rows = H;
  if (kTrunc) {
    tiles = (H + kEdtTileRows - 1) / kEdtTileRows;
    T = (H + tiles - 1) / tiles;
    rows = T + 2 * R < H ? T + 2 * R : H;
  }
  const int rounds = (nw + kEdtMaxWarps - 1) / kEdtMaxWarps;
  int warps = (nw + rounds - 1) / rounds;
  while (warps > 1 && 4 * edt_smem_words(rows, W, warps) > kEdtSmemMax)
    --warps;
  const int smem = 4 * edt_smem_words(rows, W, warps);
  if (smem > kEdtSmemMax || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_kernel<OutT, kTrunc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int dlim = kTrunc ? R : kEdtOpen;
  edt_kernel<OutT, kTrunc><<<dim3(n_envs, tiles), 32 * warps, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<OutT*>(out), H, W, T,
      kTrunc ? R : 0, dlim, kTrunc ? R * R : 0, host_params[0],
      host_params[1], host_params[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace neo
