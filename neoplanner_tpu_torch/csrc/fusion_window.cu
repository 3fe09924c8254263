// B8 v1: windowed dense polar depth fusion of one frame per env, for maps
// that the whole-grid v2 kernel does not take (W % 128 != 0 or H % 8 != 0).
//
// Replaces neoplanner_tpu/mapping/occupancy_pallas.py `_make_kernel` (:51),
// launched by `_fuse_call` (:121) from `_fuse_flat`'s v1 branch (:653-676),
// with the hit scatter `_scatter_hits` (:494). Python wrapper:
// mapping/fusion.py `insert_depth_2d_dense`; plain version:
// `_fuse_window_plain` there.
//
// The reference cut a (ch, cw) window at (r0, c0) out of each env's grid
// around the camera (a host dynamic_slice), ran the carve on it and wrote it
// back (dynamic_update_slice). Here the kernel updates the window in place
// on the full grid: one thread per window cell, the carve table in shared
// memory. Each window cell computes its polar coordinates from the WINDOW's
// origin (sc[0], sc[1]: the world centre of cell (r0, c0)), as v1 does:
// ox + c * res is not the map-wide origin + (c0 + c) * res of v2, so a cell
// on a carve radius can fall the other way than under v2. The arithmetic is
// v1's, in v1's order, with round-to-nearest intrinsics (no FMA
// contraction) and v1's round-half-to-even column index (jnp.round; v2
// takes floor(u + 0.5)); every window cell is clipped, updated or not.
// Then a second launch adds the hits (csrc/fusion_hits.cuh).
//
// Bound on the H100: device memory. The carve reads and writes 4 B per
// window cell (114 x 114 cells per env with a 4 m camera) against ~25 flops
// per cell; the table (Wcam floats) sits in shared memory.
#include <cuda_runtime.h>
#include <string.h>

#include "fusion_hits.cuh"

namespace {

constexpr int kBlock = 256;

struct WindowParams {
  float fx, res, half_w, l_hit, l_miss, l_min, l_max;
};

// sc (B, 8): [x, y of the window's cell (0, 0) centre, cam x, cam y,
// cos(yaw), sin(yaw), 0, 0]; org (B, 2) int32 [r0, c0]; tabs (B, Wcam)
__global__ void __launch_bounds__(kBlock)
    fuse_window_kernel(float* __restrict__ grid, const float* __restrict__ tabs,
                       const float* __restrict__ sc,
                       const int* __restrict__ org, int H, int W, int ch,
                       int cw, int Wcam, WindowParams P) {
  extern __shared__ float tab[];  // [Wcam]
  const int e = blockIdx.y;
  for (int i = threadIdx.x; i < Wcam; i += blockDim.x)
    tab[i] = tabs[static_cast<long long>(e) * Wcam + i];
  __syncthreads();
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= ch * cw) return;
  const int r = cell / cw, c = cell % cw;
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
  const float uf = rintf(u);
  const long long idx = static_cast<long long>(e) * H * W +
                        static_cast<long long>(org[2 * e] + r) * W +
                        org[2 * e + 1] + c;
  float v = grid[idx];
  if (dcx > 1e-6f && uf >= 0.0f && uf <= static_cast<float>(Wcam - 1)) {
    const float rcarve = tab[static_cast<int>(uf)];
    if (r_cell > 0.0f && r_cell < __fsub_rn(rcarve, P.res))
      v = __fadd_rn(v, P.l_miss);
  }
  grid[idx] = fminf(fmaxf(v, P.l_min), P.l_max);
}

}  // namespace

extern "C" int neo_fuse_depth_window(void* logodds, const void* tabs,
                                     const void* sc, const void* org,
                                     const void* hit, int n_envs, int H,
                                     int W, int ch, int cw, int Wcam,
                                     const float* host_params, void* stream) {
  WindowParams P;
  static_assert(sizeof(WindowParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_dim((ch * cw + kBlock - 1) / kBlock, n_envs);
  fuse_window_kernel<<<grid_dim, kBlock, Wcam * sizeof(float), st>>>(
      static_cast<float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<const int*>(org), H, W, ch,
      cw, Wcam, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_hits(static_cast<const long long*>(hit),
                                      static_cast<float*>(logodds),
                                      n_envs * Wcam, P.l_hit, P.l_min,
                                      P.l_max, st));
}
