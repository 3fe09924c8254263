// B8 v2: dense polar depth fusion of one frame per env into the (H, W)
// log-odds grid.
//
// Replaces neoplanner_tpu/mapping/occupancy_pallas.py `_make_kernel_v2`
// (:176), launched by `_fuse_call_v2` (:263), with the hit scatter
// `_scatter_hits` (:494). Python wrapper: mapping/fusion.py
// `insert_depth_2d_dense`; plain version: `_fuse_plain` there.
//
// Carve: every cell computes its own polar coordinates against the camera
// (range r_cell, image column u from the camera-frame tangent) and tests
// itself against the env's per-column carve table: r_cell < r_carve(u) - res
// adds l_miss, then the cell is clipped to [l_min, l_max]. Hits: the wrapper
// computes each column's hit cell (flat index, -1 for none); a second launch
// adds l_hit there with an atomic clip-add (min(old + l_hit, l_max) by
// compare-and-swap). Every add is the same positive l_hit onto a value that
// is already clipped, so a cell hit k times ends at k sequential adds, then
// clip, whatever the order of the atomics: the update is deterministic and
// equals the reference's scatter-add followed by the clip.
//
// The TPU kernel's 8-aligned row window and 128-lane column halves were VMEM
// tiling; a cell beyond the sensor reach never passes the carve test, so
// here one thread covers one cell of the whole grid (the same result; the
// CPU test holds the plain version, which also covers the whole grid,
// against the TPU kernel in interpret mode). The carve arithmetic uses
// round-to-nearest intrinsics in the reference's operation order (no FMA
// contraction), so kernel and plain version agree bit for bit.
//
// Bound on the H100: device memory. The carve reads and writes 4 B per cell
// (2 x 196 KB per env at 192 x 256) against ~25 flops per cell; the table
// (160 floats) sits in shared memory. The hit launch touches 160 cells per
// env.
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kBlock = 256;

struct FuseParams {
  float fx, res, half_w, l_hit, l_miss, l_min, l_max;
};

// sc (B, 8): [x of column 0's center, y of row 0's center, cam x, cam y,
// cos(yaw), sin(yaw), 0, 0]; tabs (B, Wcam) r_carve per image column
__global__ void __launch_bounds__(kBlock)
    fuse_carve_kernel(const float* __restrict__ lo,
                      const float* __restrict__ tabs,
                      const float* __restrict__ sc, float* __restrict__ out,
                      int H, int W, int Wcam, FuseParams P) {
  extern __shared__ float tab[];  // [Wcam]
  const int e = blockIdx.y;
  for (int i = threadIdx.x; i < Wcam; i += blockDim.x)
    tab[i] = tabs[static_cast<long long>(e) * Wcam + i];
  __syncthreads();
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= H * W) return;
  const int r = cell / W, c = cell % W;
  const float* s = sc + e * 8;
  const float cp = s[4], sp = s[5];
  const float dx = __fsub_rn(__fadd_rn(s[0], __fmul_rn(static_cast<float>(c),
                                                       P.res)), s[2]);
  const float dy = __fsub_rn(__fadd_rn(s[1], __fmul_rn(static_cast<float>(r),
                                                       P.res)), s[3]);
  const float dcx = __fadd_rn(__fmul_rn(cp, dx), __fmul_rn(sp, dy));
  const float dcy = __fadd_rn(__fmul_rn(-sp, dx), __fmul_rn(cp, dy));
  const float r_cell = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)));
  const float u = __fsub_rn(P.half_w, __fdiv_rn(__fmul_rn(P.fx, dcy),
                                                fmaxf(dcx, 1e-6f)));
  const float uf = floorf(__fadd_rn(u, 0.5f));
  const long long idx = static_cast<long long>(e) * H * W + cell;
  float v = lo[idx];
  if (dcx > 1e-6f && uf >= 0.0f && uf <= static_cast<float>(Wcam - 1)) {
    const float rcarve = tab[static_cast<int>(uf)];
    if (r_cell > 0.0f && r_cell < __fsub_rn(rcarve, P.res))
      v = __fadd_rn(v, P.l_miss);
  }
  out[idx] = fminf(fmaxf(v, P.l_min), P.l_max);
}

// hit (B * Wcam) flat grid index of each column's hit cell, -1 for none
__global__ void __launch_bounds__(kBlock)
    fuse_hits_kernel(const long long* __restrict__ hit, float* __restrict__ out,
                     int n, FuseParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long h = hit[i];
  if (h < 0) return;
  unsigned int* a = reinterpret_cast<unsigned int*>(out + h);
  unsigned int old = *a, seen;
  do {
    seen = old;
    const float nv = fminf(fmaxf(__fadd_rn(__uint_as_float(seen), P.l_hit),
                                 P.l_min), P.l_max);
    old = atomicCAS(a, seen, __float_as_uint(nv));
  } while (old != seen);
}

}  // namespace

extern "C" int neo_fuse_depth_dense(const void* logodds, const void* tabs,
                                    const void* sc, const void* hit,
                                    void* out, int n_envs, int H, int W,
                                    int Wcam, const float* host_params,
                                    void* stream) {
  FuseParams P;
  static_assert(sizeof(FuseParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H * W + kBlock - 1) / kBlock, n_envs);
  fuse_carve_kernel<<<grid, kBlock, Wcam * sizeof(float), st>>>(
      static_cast<const float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<float*>(out), H, W, Wcam, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = n_envs * Wcam;
  fuse_hits_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      static_cast<const long long*>(hit), static_cast<float*>(out), n, P);
  return static_cast<int>(cudaGetLastError());
}
