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
// carve and again after each hit, so F chained v2 calls differ near the
// clamp bounds and this kernel is not a loop over v2. The TPU kernel got
// the counts from a bf16 one-hot matrix product (it has no scatter) and
// walked an 8-aligned row window around the camera; that window was VMEM
// tiling: a cell beyond the sensor reach never carves and never holds a
// hit, and clipping a clipped cell changes nothing, so covering the whole
// grid gives the same result.
//
// Design and bound: csrc/fusion_tile.cuh (fuse_tile_kernel<true, int32>):
// a block per env and 32 x 32 tile of cells, held in registers across the
// F frames; each frame carves only the tiles its camera reaches. Bound on
// the H100: device memory (the grid read and written once).
#include <cuda_runtime.h>
#include <string.h>

#include "fusion_tile.cuh"

// tabs (B, F, Wcam), sc (B, F, 8); hit (B, F, Wcam) int32: row * W + col
// of each column's hit cell in its env's grid, negative for none
extern "C" int neo_fuse_depth_multi(const void* logodds, const void* tabs,
                                    const void* sc, const void* hit,
                                    void* out, int n_envs, int n_frames,
                                    int H, int W, int Wcam,
                                    const float* host_params, void* stream) {
  FuseParams P;
  static_assert(sizeof(FuseParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  return static_cast<int>(launch_fuse_tile<true>(
      static_cast<const float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<const int*>(hit),
      static_cast<float*>(out), n_envs, n_frames, H, W, Wcam, P,
      static_cast<cudaStream_t>(stream)));
}
