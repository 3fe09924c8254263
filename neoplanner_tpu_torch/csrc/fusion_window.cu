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
// back (dynamic_update_slice), then scattered the hits onto the grid. Here
// one launch updates the window in place on the full grid and adds the hits,
// those outside the window too: every window cell is clipped after its
// carve, then each hit cell takes l_hit once per hit with a clip after each
// add. The arithmetic is v1's, in v1's order, with round-to-nearest
// intrinsics (no FMA contraction) and v1's round-half-to-even column index.
//
// Design and bound: csrc/fusion_tile.cuh (fuse_tile_kernel<false, int64,
// true>): a block per env over its window's 32 x 32 tiles, carving only the
// 8 x 16 strips that the frame's camera reaches, the table staged once per
// env and the hits counted per tile in shared memory. Bound on the H100:
// device memory (the window read and written once).
#include <cuda_runtime.h>
#include <string.h>

#include "fusion_tile.cuh"

// sc (B, 8): [x, y of the window's cell (0, 0) centre, cam x, cam y,
// cos(yaw), sin(yaw), 0, 0]; org (B, 2) int32 [r0, c0]; tabs (B, Wcam);
// hit (B, Wcam) int64: env * H * W + row * W + col of each column's hit
// cell, negative for none
extern "C" int neo_fuse_depth_window(void* logodds, const void* tabs,
                                     const void* sc, const void* org,
                                     const void* hit, int n_envs, int H,
                                     int W, int ch, int cw, int Wcam,
                                     const float* host_params, void* stream) {
  FuseParams P;
  static_assert(sizeof(FuseParams) == 7 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  return static_cast<int>(launch_fuse_window(
      static_cast<float*>(logodds), static_cast<const float*>(tabs),
      static_cast<const float*>(sc), static_cast<const long long*>(hit),
      static_cast<const int*>(org), n_envs, H, W, ch, cw, Wcam, P,
      static_cast<cudaStream_t>(stream)));
}
