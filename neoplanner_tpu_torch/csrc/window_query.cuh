// The bilinear ESDF window query, shared by B6 (lbfgs_grid.cu, the whole
// grid solve) and B7 (objective_eval.cu, one grid objective evaluation).
//
// Semantics of the TPU kernels' window sampling
// (neoplanner_tpu/plan/solve_pallas_grid.py `sample`, :60-130, and
// plan/costs_pallas_grid.py `_window_coords` :304 with K2 `_make_k2` :183):
// u/v = (world - window origin) / res - 0.5, clipped to [0, Hw - 1.001];
// the bilinear value of the four neighbouring cells; a sample outside the
// MAP (worg[3:7]) reads FAR (free); the derivative is zero where the clip
// bites or outside the map. The one-hot MXU tap matmuls of the TPU form
// were a workaround for a machine without gathers: here a tap is four
// indexed loads, through the read-only cache (several problems of one env
// share its window).
#pragma once

#include "minco_device.cuh"

namespace neo {

struct WindowQuery {
  const float* win;  // (Hw, Ww) row-major, row = y
  float ox, oy, res, mx0, my0, mx1, my1, umax, vmax;
  int Ww;

  template <bool GRAD>
  __device__ __forceinline__ float dist(float px, float py, float* gx,
                                        float* gy) const {
    const float uraw = (py - oy) / res - 0.5f;
    const float vraw = (px - ox) / res - 0.5f;
    const float u = fminf(fmaxf(uraw, 0.0f), umax);
    const float v = fminf(fmaxf(vraw, 0.0f), vmax);
    const int r0 = static_cast<int>(floorf(u));
    const int c0 = static_cast<int>(floorf(v));
    const float fr = u - static_cast<float>(r0);
    const float fc = v - static_cast<float>(c0);
    const float* w = win + r0 * Ww + c0;
    const float d00 = __ldg(w), d01 = __ldg(w + 1);
    const float d10 = __ldg(w + Ww), d11 = __ldg(w + Ww + 1);
    // explicit roundings, as objective.cuh's (B6 and B7 must agree)
    const float top = __fmaf_rn(d01, fc, __fmul_rn(d00, 1.0f - fc));
    const float bot = __fmaf_rn(d11, fc, __fmul_rn(d10, 1.0f - fc));
    const bool out_map = px < mx0 || py < my0 || px >= mx1 || py >= my1;
    if (GRAD) {
      const bool iny = uraw > 0.0f && uraw < umax;
      const bool inx = vraw > 0.0f && vraw < vmax;
      const float ddu = bot - top;
      const float ddv =
          __fmaf_rn(d11 - d10, fr, __fmul_rn(d01 - d00, 1.0f - fr));
      *gx = (out_map || !inx) ? 0.0f : ddv / res;
      *gy = (out_map || !iny) ? 0.0f : ddu / res;
    }
    return out_map ? kFar : __fmaf_rn(bot, fr, __fmul_rn(top, 1.0f - fr));
  }
};

// The query of env e: its window win[e] (Hw, Ww) and its row of worg (E, 7)
// [x0, y0, res, map_x0, map_y0, map_x1, map_y1].
__device__ __forceinline__ WindowQuery window_query(const float* win,
                                                    const float* worg,
                                                    long long e, int Hw,
                                                    int Ww) {
  const float* o = worg + e * 7;
  return WindowQuery{win + e * Hw * Ww, o[0], o[1], o[2], o[3], o[4], o[5],
                     o[6],
                     // the clip bounds of esdf.sample_bilinear, rounded
                     // from double as the reference does
                     static_cast<float>(Hw - 1.001),
                     static_cast<float>(Ww - 1.001), Ww};
}

}  // namespace neo
