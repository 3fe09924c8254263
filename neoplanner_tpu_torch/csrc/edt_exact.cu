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
// The reference's f32 chain holds these integers exactly: a column with an
// occupied row ends at its exact integer (1e9 + (i-k)^2 rounds in f32, but
// such a candidate never wins), and a column of 1e9 rows at exactly 1e9,
// which reads FAR. The kernel (edt.cuh `edt_kernel<float, false>`: one
// block per env, the grid's bits in shared memory, a lower envelope per
// column on every warp) computes the same integers and FAR where no row of
// the env has an occupied cell. Design and bound: edt.cuh.
#include "edt.cuh"

extern "C" int neo_edt_exact(const void* grid, void* out, int n_envs, int H,
                             int W, const float* host_params, void* stream) {
  // host_params: [threshold, resolution, far]
  return neo::edt_launch<float, false>(grid, out, n_envs, H, W, 0,
                                       host_params, stream);
}
