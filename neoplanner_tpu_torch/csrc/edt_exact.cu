// B9 (exact): occupancy -> exact 2-D EDT in meters (f32), per env.
//
// Replaces neoplanner_tpu/ops/edt_pallas.py `_pass2_kernel` (:32), launched
// by `pass2` (:119) for `ops/edt.edt_sq_cells` (:64-71), with the row pass
// and the sqrt/FAR step of `ops/edt.edt` (:116) in the same launch. Python
// wrapper: ops/edt.py `edt`; plain version: `_edt_plain` there
// (`_row_distance_sq`, `_pass2`, sqrt, FAR).
//
//   pass 1 (rows):    g2[i,j] = (j - nearest occupied column of row i)^2,
//                     1e9 where row i has no occupied cell
//   pass 2 (columns): d2[i,j] = min_k (i-k)^2 + g2[k,j]
//   out = FAR (1e4) where d2 >= 1e9, else min(sqrt(d2) * res, FAR)
//
// Integer arithmetic throughout, then one correctly rounded sqrt and one
// multiply (the build has no --use_fast_math), so the field equals the
// reference's f32 chain bit for bit: there a column with an occupied row
// ends at its exact integer (1e9 + (i-k)^2 rounds in f32, but such a
// candidate never wins), and a column of 1e9 rows at exactly 1e9 (k = i),
// which reads FAR.
//
// Design: one block per (env, strip of 32 columns), one warp per row at a
// time. Pass 1 loads the whole row at once (up to 1024 cells, every load
// in flight together) and finds each strip column's nearest occupied cell
// from one warp ballot per 32-cell chunk. The strip's H x 32 g2 values
// stay in shared memory. Pass 2, one
// thread per column of the strip: the lower envelope of the parabolas
// (i - q)^2 + g2[q] over the column's rows q that have an occupied cell
// (Felzenszwalb-Huttenlocher), with each parabola's first output row
// ceil(((q^2 + g2[q]) - (p^2 + g2[p])) / (2 (q - p))) in integers (stored
// as int16 and capped at H, which changes no output row), then one sweep
// down the rows: O(H) per column, O(1) per cell, whatever the distances.
// A column without such a row is FAR throughout.
//
// Bound on the H100: device memory. The least work of an exact transform
// is O(1) per cell (~20 operations) against 8 B per cell (f32 in, f32 out);
// this kernel re-reads each grid row once per strip from L2 in pass 1 (14
// times at W = 448), and the envelopes are built on one warp of eight.
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;
constexpr int kMaxChunks = 32;     // rows of up to kMaxChunks * kStrip cells
constexpr int kBlock = 256;
constexpr int kNone = 1000000000;  // the reference's 1e9: no occupied cell

__global__ void __launch_bounds__(kBlock)
    edt_exact_kernel(const float* __restrict__ grid, float* __restrict__ out,
                     int H, int W, float thr, float res, float far) {
  extern __shared__ int smem[];
  int* g2 = smem;                                          // [H][kStrip]
  short* v = reinterpret_cast<short*>(g2 + H * kStrip);    // [H][kStrip]
  short* z = v + H * kStrip;                               // [H][kStrip]
  __shared__ int top[kStrip];      // each column's envelope top (-1: none)
  const int e = blockIdx.y;
  const int j0 = blockIdx.x * kStrip;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int j = j0 + lane;
  const float* src = grid + static_cast<long long>(e) * H * W;

  for (int i = warp; i < H; i += n_warps) {
    const float* row = src + static_cast<long long>(i) * W;
    bool occ[kMaxChunks];          // all of the row's loads in flight at once
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      const int c = ch * kStrip + lane;
      occ[ch] = ch * kStrip < W && c < W && row[c] > thr;
    }
    unsigned strip = 0;
    int left = -1, right = -1;     // nearest occupied outside the strip
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      const int c0 = ch * kStrip;
      const unsigned m = __ballot_sync(0xffffffffu, occ[ch]);
      if (c0 < j0) {
        if (m) left = c0 + 31 - __clz(m);
      } else if (c0 == j0) {
        strip = m;
      } else if (m && right < 0) {
        right = c0 + __ffs(m) - 1;
      }
    }
    const unsigned lo = strip & (0xffffffffu >> (31 - lane));   // bits <= lane
    const unsigned hi = strip & (0xffffffffu << lane);          // bits >= lane
    const int dl = lo ? lane - (31 - __clz(lo)) : (left >= 0 ? j - left : -1);
    const int dr = hi ? (__ffs(hi) - 1) - lane : (right >= 0 ? right - j : -1);
    const int d = dl < 0 ? dr : (dr < 0 ? dl : min(dl, dr));
    g2[i * kStrip + lane] = d < 0 ? kNone : d * d;
  }
  __syncthreads();

  // the envelope of each column, built by warp 0 (a chain per column)
  const int* f = g2 + lane;        // this column's g2, v and z: stride kStrip
  short* vc = v + lane;
  short* zc = z + lane;
  if (warp == 0 && j < W) {
    int k = -1;                    // top of the envelope
    for (int q = 0; q < H; ++q) {
      const int fq = f[q * kStrip];
      if (fq >= kNone) continue;
      int s = 0;                   // q's first row on the envelope
      while (k >= 0) {
        const int p = vc[k * kStrip];
        const int num = (q * q + fq) - (p * p + f[p * kStrip]);
        const int den = 2 * (q - p);
        if (num > zc[k * kStrip] * den) {   // ceil(num / den) > z[k]
          s = min((num + den - 1) / den, H);
          break;
        }
        --k;                       // p is nowhere below q: drop it
      }
      ++k;
      vc[k * kStrip] = static_cast<short>(q);
      zc[k * kStrip] = static_cast<short>(s);
    }
    top[lane] = k;
  }
  __syncthreads();

  // the output rows, a run of rows per warp: find the envelope's parabola
  // at the run's first row by bisection, then follow it down
  if (j >= W) return;
  const int k = top[lane];
  const int rows = (H + n_warps - 1) / n_warps;
  const int i0 = warp * rows, i1 = min(H, i0 + rows);
  float* dst = out + static_cast<long long>(e) * H * W + j;
  if (k < 0) {
    for (int i = i0; i < i1; ++i) dst[static_cast<long long>(i) * W] = far;
    return;
  }
  int c = 0;                       // the last c with z[c] <= i0
  for (int lo = 0, hi = k; lo <= hi;) {
    const int mid = (lo + hi) >> 1;
    if (zc[mid * kStrip] <= i0) {
      c = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  for (int i = i0; i < i1; ++i) {
    while (c < k && zc[(c + 1) * kStrip] <= i) ++c;
    const int p = vc[c * kStrip];
    const int d2 = (i - p) * (i - p) + f[p * kStrip];
    dst[static_cast<long long>(i) * W] =
        fminf(__fmul_rn(__fsqrt_rn(static_cast<float>(d2)), res), far);
  }
}

}  // namespace

extern "C" int neo_edt_exact(const void* grid, void* out, int n_envs, int H,
                             int W, const float* host_params, void* stream) {
  // host_params: [threshold, resolution, far]
  const size_t smem = static_cast<size_t>(H) * kStrip *
                      (sizeof(int) + 2 * sizeof(short));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_dim((W + kStrip - 1) / kStrip, n_envs);
  edt_exact_kernel<<<grid_dim, kBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<float*>(out), H, W,
      host_params[0], host_params[1], host_params[2]);
  return static_cast<int>(cudaGetLastError());
}
