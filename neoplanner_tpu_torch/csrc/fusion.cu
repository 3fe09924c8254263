// B8 v2: dense polar depth fusion of one frame per env into the (H, W)
// log-odds grid, carve and hits in one launch.
//
// Replaces neoplanner_tpu/mapping/occupancy_pallas.py `_make_kernel_v2`
// (:176), launched by `_fuse_call_v2` (:263), with the hit scatter
// `_scatter_hits` (:494). Python wrapper: mapping/fusion.py
// `insert_depth_2d_dense`; plain version: `_fuse_plain` there.
//
// Every cell tests itself against the env's per-column carve table
// (r_cell < r_carve(u) - res adds l_miss), is clipped to [l_min, l_max],
// then takes l_hit once for each image column whose hit falls in it, with a
// clip after each add. The TPU kernel's 8-aligned row window and 128-lane
// column halves were VMEM tiling; a cell beyond the sensor reach never
// passes the carve test, so the whole grid gives the same result.
//
// Design and bound: csrc/fusion_tile.cuh (fuse_tile_kernel<false, int64>,
// F = 1): a block per env and 32 x 32 tile of cells, which carves only
// where the frame's camera reaches the tile and adds the tile's hits in the
// same pass. Bound on the H100: device memory (the grid read and written
// once).
#include <cuda_runtime.h>
#include <string.h>

#include "fusion_tile.cuh"

// hit (B, Wcam) int64: env * H * W + row * W + col of each column's hit
// cell, negative for none
extern "C" int neo_fuse_depth_dense(const void* logodds, const void* tabs,
                                    const void* sc, const void* hit,
                                    void* out, int n_envs, int H, int W,
                                    int Wcam, const float* host_params,
                                    void* stream) {
  FuseParams P;
  static_assert(sizeof(FuseParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  return static_cast<int>(launch_fuse_tile<false>(
      static_cast<const float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<const long long*>(hit),
      static_cast<float*>(out), n_envs, 1, H, W, Wcam, P,
      static_cast<cudaStream_t>(stream)));
}
