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
// fused does). Python wrapper: ops/edt.py `edt_truncated`; plain version:
// `_truncated_plain` there.
//
// With truncation radius R (cells):
//   pass 1 (rows):    g2[i,j] = min_{|d|<=R, occ(i,j+d)} d^2, else (R+1)^2
//   pass 2 (columns): d2[i,j] = min(R^2, min_{|d|<=R} d^2 + g2[i+d,j])
//   out = bf16(min(sqrt(d2) * res, max_dist))   (f32 for B9 banded)
// The TPU kernels padded the rows outside the map and did 4R rolls over a
// whole grid in VMEM. These run edt.cuh `edt_kernel<OutT, true>`: the exact
// column pass over the rows with g2 < R^2, clamped at R^2, which is the
// same integer cell for cell (edt.cuh), on tiles of up to 256 output rows
// with an R-row halo. Design and bound: edt.cuh.
#include <cuda_bf16.h>

#include "edt.cuh"

extern "C" int neo_edt_trunc_lite(const void* logodds, void* out, int n_envs,
                                  int H, int W, int R, const float* host_params,
                                  void* stream) {
  // host_params: [threshold, resolution, max_dist]
  return neo::edt_launch<__nv_bfloat16, true>(logodds, out, n_envs, H, W, R,
                                              host_params, stream);
}

extern "C" int neo_edt_banded(const void* grid, void* out, int n_envs, int H,
                              int W, int R, const float* host_params,
                              void* stream) {
  return neo::edt_launch<float, true>(grid, out, n_envs, H, W, R, host_params,
                                      stream);
}
