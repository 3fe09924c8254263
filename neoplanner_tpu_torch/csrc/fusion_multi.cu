// B8 v3: dense polar depth fusion of F frames per env into the (H, W)
// log-odds grid in one pass, with one clip per frame over carve and hits.
//
// Replaces neoplanner_tpu/mapping/occupancy_pallas.py `_make_kernel_v3`
// (:299), launched by `_fuse_call_v3` (:419) from
// `insert_depth_2d_dense_multi` (:512). Python wrapper: mapping/fusion.py
// `insert_depth_2d_dense_multi`; plain version: `_fuse_multi_plain` there.
//
// What it computes, per env, frame after frame in order:
//   cell = clip((cell + carve_f(cell)) + k_f(cell) * l_hit, l_min, l_max)
// carve_f is B8 v2's test against frame f's carve table (l_miss where the
// cell lies in front of the column's carve range, else 0) and k_f the
// number of frame f's columns whose hit falls in the cell. One clip per
// frame over the summed update, as the reference; B8 v2 clips after the
// carve and again after the hits, so F chained v2 calls differ near the
// clamp bounds and this kernel is not a loop over v2.
//
// Design: one block per (env, band of whole grid rows), 256 threads, each
// holding its 8 cells of the band in registers across all F frames: the
// grid is read once and written once per call. Per frame the block stages
// the carve table and the scalars in shared memory and counts the frame's
// hits that fall in the band with shared-memory integer atomics (one
// counter per band cell); each thread then applies carve and count to its
// cells and zeroes their counters for the next frame. The TPU kernel got
// the counts from a bf16 one-hot matrix product (it has no scatter) and
// walked an 8-aligned row window around the camera; that window was VMEM
// tiling: a cell beyond the sensor reach never carves and never holds a
// hit, and clipping a clipped cell changes nothing, so covering the whole
// grid gives the same result. The arithmetic uses round-to-nearest
// intrinsics in the reference's order, (cell + carve) + float(k) * l_hit,
// so no FMA contraction moves a cell and kernel and plain version agree bit
// for bit.
//
// Bound on the H100: device memory. The grid is read and written once
// (2 x 4 B per cell, 2 x 196 KB per env at 192 x 256) against ~25 flops per
// cell and frame; the F tables, scalars and hit cells add 8 B per column
// and frame.
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPerThread = 8;
constexpr int kBandCells = kBlock * kPerThread;

struct FuseParams {
  float fx, res, half_w, l_hit, l_miss, l_min, l_max;
};

// logodds/out (B, H, W); tabs (B, F, Wcam) carve range per image column;
// sc (B, F, 8) [x of column 0's center, y of row 0's center, cam x, cam y,
// cos(yaw), sin(yaw), 0, 0]; hit (B, F, Wcam) cell index row * W + col of
// each column's hit in its env's grid, -1 for none
__global__ void __launch_bounds__(kBlock)
    fuse_multi_kernel(const float* __restrict__ lo,
                      const float* __restrict__ tabs,
                      const float* __restrict__ sc,
                      const int* __restrict__ hit, float* __restrict__ out,
                      int F, int H, int W, int Wcam, int band_rows,
                      FuseParams P) {
  extern __shared__ int smem[];  // [band_rows * W] counts, [Wcam] table, [8]
  int* cnt = smem;
  float* tab = reinterpret_cast<float*>(smem + band_rows * W);
  float* s = tab + Wcam;
  const int tid = threadIdx.x;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * band_rows;
  const int cell0 = row0 * W;
  const int n_cells = min(band_rows, H - row0) * W;
  const long long base = static_cast<long long>(e) * H * W + cell0;

  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kBlock;
    v[j] = i < n_cells ? lo[base + i] : 0.0f;
  }
  for (int i = tid; i < n_cells; i += kBlock) cnt[i] = 0;
  __syncthreads();  // every counter is zero before any frame's hits land

  for (int f = 0; f < F; ++f) {
    const long long fr = static_cast<long long>(e) * F + f;
    for (int i = tid; i < Wcam; i += kBlock) {
      tab[i] = tabs[fr * Wcam + i];
      const int h = hit[fr * Wcam + i];
      if (h >= cell0 && h < cell0 + n_cells) atomicAdd(&cnt[h - cell0], 1);
    }
    if (tid < 8) s[tid] = sc[fr * 8 + tid];
    __syncthreads();
    const float cp = s[4], sp = s[5];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = tid + j * kBlock;
      if (i >= n_cells) continue;
      const int r = row0 + i / W, c = i % W;
      const float dx = __fsub_rn(
          __fadd_rn(s[0], __fmul_rn(static_cast<float>(c), P.res)), s[2]);
      const float dy = __fsub_rn(
          __fadd_rn(s[1], __fmul_rn(static_cast<float>(r), P.res)), s[3]);
      const float dcx = __fadd_rn(__fmul_rn(cp, dx), __fmul_rn(sp, dy));
      const float dcy = __fadd_rn(__fmul_rn(-sp, dx), __fmul_rn(cp, dy));
      const float r_cell = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                __fmul_rn(dy, dy)));
      const float u = __fsub_rn(P.half_w, __fdiv_rn(__fmul_rn(P.fx, dcy),
                                                    fmaxf(dcx, 1e-6f)));
      const float uf = floorf(__fadd_rn(u, 0.5f));
      float carve = 0.0f;
      if (dcx > 1e-6f && uf >= 0.0f && uf <= static_cast<float>(Wcam - 1)) {
        const float rcarve = tab[static_cast<int>(uf)];
        if (r_cell > 0.0f && r_cell < __fsub_rn(rcarve, P.res))
          carve = P.l_miss;
      }
      const int k = cnt[i];
      cnt[i] = 0;
      const float nv = __fadd_rn(__fadd_rn(v[j], carve),
                                 __fmul_rn(static_cast<float>(k), P.l_hit));
      v[j] = fminf(fmaxf(nv, P.l_min), P.l_max);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kBlock;
    if (i < n_cells) out[base + i] = v[j];
  }
}

}  // namespace

extern "C" int neo_fuse_depth_multi(const void* logodds, const void* tabs,
                                    const void* sc, const void* hit,
                                    void* out, int n_envs, int n_frames,
                                    int H, int W, int Wcam,
                                    const float* host_params, void* stream) {
  FuseParams P;
  static_assert(sizeof(FuseParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const int band_rows = kBandCells / W;
  if (band_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(band_rows) * W + Wcam + 8) * 4;
  const dim3 grid((H + band_rows - 1) / band_rows, n_envs);
  fuse_multi_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<const int*>(hit),
      static_cast<float*>(out), n_frames, H, W, Wcam, band_rows, P);
  return static_cast<int>(cudaGetLastError());
}
