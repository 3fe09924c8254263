// Device helpers shared by the port's kernels: the MINCO basis constants, the
// banded Givens-QR solve in one warp's form (B5's solve, and the forward
// and transposed solves of the objective inside B1, B6, B2s and B7), and
// the footprint SDF over a scene's primitives (the collision term of B1 and
// B2s, and B3's closed-loop metric).
//
// Counterparts of neoplanner_tpu/plan/costs_pallas.py `_solve_entries` (:124)
// and `_scene_min_dist` (:153), and of ops/minco_pallas.py `_make_kernel`.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace neo {

constexpr float kFar = 1e4f;

// j!/(j-k)! for d^k/dt^k t^j, zero where j < k
__host__ __device__ constexpr float falling(int k, int j) {
  if (j < k) return 0.0f;
  float out = 1.0f;
  for (int s = 0; s < k; ++s) out *= static_cast<float>(j - s);
  return out;
}

__device__ __forceinline__ float sgn(float v) {
  return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// The Givens steps below, and the B2 device code that calls them
// (objective.cuh), write every add that takes a product as an explicit
// __fmaf_rn / __fadd_rn: the compiler may fuse a plain multiply and add
// differently in different kernels, and the objective must round alike in
// every kernel that inlines it.

// One Givens rotation's (cs, sn) from the pivot a_cc and the entry a_rc.
__device__ __forceinline__ void givens(float a_cc, float a_rc, float* cs,
                                       float* sn) {
  const float denom = sqrtf(__fmaf_rn(a_cc, a_cc, __fmul_rn(a_rc, a_rc)));
  const bool safe = denom > 1e-20f;
  // divide unconditionally (by 1 where unsafe) and select: no branch
  const float q = 1.0f / (safe ? denom : 1.0f);
  const float inv = safe ? q : 0.0f;
  *cs = safe ? __fmul_rn(a_cc, inv) : 1.0f;
  *sn = __fmul_rn(a_rc, inv);
}

// Rows c and r of a rotation: (cs rc + sn rr, cs rr - sn rc).
__device__ __forceinline__ float rot_c(float cs, float sn, float rc,
                                       float rr) {
  return __fmaf_rn(cs, rc, __fmul_rn(sn, rr));
}
__device__ __forceinline__ float rot_r(float cs, float sn, float rc,
                                       float rr) {
  return __fmaf_rn(cs, rr, __fmul_rn(-sn, rc));
}

// Column c's pass of warp_givens_solve; GUARD for the last LBW columns,
// whose rotations stop at row N - 1 (the others need no test per rotation).
template <int N, int D, int LBW, int FILL, bool GUARD>
__device__ __forceinline__ void givens_column(float* sys, float* diag,
                                              float* own, int lane, int c) {
  constexpr int S = N + 1;
  __syncwarp();  // column c's rows as the previous columns left them
  const float* pc = sys + c * S;
  float a_cc = pc[c], own_c = own[c], a_r[LBW], own_r[LBW];
#pragma unroll
  for (int t = 0; t < LBW; ++t) {
    const bool in = !GUARD || c + 1 + t < N;
    a_r[t] = in ? pc[c + 1 + t] : 0.0f;
    own_r[t] = in ? own[c + 1 + t] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < LBW; ++t) {
    if (!GUARD || c + 1 + t < N) {
      float cs, sn;
      givens(a_cc, a_r[t], &cs, &sn);
      a_cc = rot_c(cs, sn, a_cc, a_r[t]);
      const float nr = rot_r(cs, sn, own_c, own_r[t]);
      own_c = rot_c(cs, sn, own_c, own_r[t]);
      own_r[t] = nr;
    }
  }
  const bool band = lane < N + D && lane > c && (lane <= c + FILL || lane >= N);
  if (band) {
    own[c] = own_c;
#pragma unroll
    for (int t = 0; t < LBW; ++t)
      if (!GUARD || c + 1 + t < N) own[c + 1 + t] = own_r[t];
  }
  if (lane == c) diag[c] = own_c;
}

// Solve the banded system A x = b (A with LBW sub-diagonals, D right-hand
// sides) by Givens QR, then back-substitute: for each column c in order,
// rows c + 1 .. c + LBW rotated into row c, each rotation touching only the
// band columns [c, c + FILL] (QR fills the upper band to FILL) and the
// right-hand sides; entries left of the diagonal are never read again. For
// every entry that is read these are the values of the full-row rotations
// of ops/minco.py `_givens_solve`, in its order. One warp runs it, on the
// system held by columns in the warp's shared memory: column j (j < N: A's;
// N + d: right-hand side d) at sys[j * (N + 1) + row], lane j owning column
// j (the odd stride puts a row of 32 columns in 32 banks). Column c's pass loads A[c][c] and the LBW
// entries below it, and each lane its own column's rows c .. c + LBW, then
// runs the column's rotations in registers — A[c][c] carried on every lane,
// the owner's own update bit for bit — and each lane in the band
// [c, c + FILL] or holding a right-hand side writes its rows back.
// The owner of column c writes only the diagonal, to diag[c] (its entries
// below the diagonal are never read again), so no lane writes column c while
// another may still be loading it, and one sync per column suffices. Lanes
// 0 .. D-1 then back-substitute one right-hand side each into sol[N][D],
// the last FILL values in registers. The loops run at run time, so the
// code stays a few hundred instructions: unrolled over (c, r) the two
// solves were thousands, fetched anew at each evaluation.
template <int N, int D, int LBW, int FILL>
__device__ __forceinline__ void warp_givens_solve(float* sys, float* diag,
                                                  int lane, float* sol) {
  static_assert(N + D <= 32 && LBW < N, "one column per lane");
  constexpr int S = N + 1;
  float* own = sys + (lane < N + D ? lane : N + D - 1) * S;
  int c = 0;
#pragma unroll 1
  for (; c < N - LBW; ++c)
    givens_column<N, D, LBW, FILL, false>(sys, diag, own, lane, c);
#pragma unroll 1
  for (; c < N; ++c)
    givens_column<N, D, LBW, FILL, true>(sys, diag, own, lane, c);
  __syncwarp();
  if (lane < D) {
    float xw[FILL];  // x[c + 1 .. c + FILL] of this right-hand side
#pragma unroll
    for (int t = 0; t < FILL; ++t) xw[t] = 0.0f;
#pragma unroll 1
    for (int c = N - 1; c >= 0; --c) {
      float acc = sys[(N + lane) * S + c];
#pragma unroll
      for (int t = 0; t < FILL; ++t)
        if (c + 1 + t < N) acc = __fmaf_rn(-sys[(c + 1 + t) * S + c], xw[t], acc);
      const float xc = acc / diag[c];
      sol[c * D + lane] = xc;
#pragma unroll
      for (int t = FILL - 1; t > 0; --t) xw[t] = xw[t - 1];
      xw[0] = xc;
    }
  }
  __syncwarp();
}

// Minimum footprint SDF over one env's primitives at (px, py), and with
// GRAD the gradient of the argmin primitive (mapping/scene.sample). The
// primitives are six floats each [cx, cy, hx, hy, is_cyl, active], element
// e of primitive k at pr[(6 * k + e) * stride]: stride 1 for a warp's own
// table in shared memory (B1, B2s), the block size for a thread's slice of
// a block's table (B3). Ties keep the first primitive, as argmin.
template <bool GRAD>
__device__ __forceinline__ float scene_min_dist(const float* pr, int stride,
                                                int n_prims, float px,
                                                float py, float* gx,
                                                float* gy) {
  float dis = kFar;
  if (GRAD) {
    *gx = 0.0f;
    *gy = 0.0f;
  }
  for (int k = 0; k < n_prims; ++k) {
    const float* p = pr + 6 * k * stride;
    if (!(p[5 * stride] > 0.5f)) continue;  // inactive: reads as kFar
    const float cx = p[0], cy = p[stride];
    const float hx = p[2 * stride], hy = p[3 * stride];
    const bool is_cyl = p[4 * stride] > 0.5f;
    const float dx = px - cx, dy = py - cy;
    const float qx = fabsf(dx) - hx, qy = fabsf(dy) - hy;
    const float qxp = fmaxf(qx, 0.0f), qyp = fmaxf(qy, 0.0f);
    const float nrm = sqrtf(__fmaf_rn(qxp, qxp, __fmul_rn(qyp, qyp)));
    const float r = sqrtf(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    const float dk = is_cyl ? r - hx : nrm + fminf(fmaxf(qx, qy), 0.0f);
    if (dk < dis) {
      dis = dk;
      if (GRAD) {
        if (is_cyl) {
          const float inv_r = 1.0f / fmaxf(r, 1e-9f);
          *gx = dx * inv_r;
          *gy = dy * inv_r;
        } else if (nrm > 1e-9f) {
          const float inv_n = 1.0f / fmaxf(nrm, 1e-9f);
          *gx = sgn(dx) * qxp * inv_n;
          *gy = sgn(dy) * qyp * inv_n;
        } else {
          const bool ax = qy > qx;
          *gx = ax ? 0.0f : sgn(dx);
          *gy = ax ? sgn(dy) : 0.0f;
        }
      }
    }
  }
  return dis;
}

}  // namespace neo
