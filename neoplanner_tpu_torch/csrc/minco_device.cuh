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

// warp_givens_solve's layout of a system in a warp's shared memory: the N
// columns of A, column j holding only its band, rows j - FILL .. j + LBW
// (kBW floats: QR fills the upper band to FILL, and the LBW entries below
// the diagonal are read once), kStride apart, then the D right-hand sides,
// N rows each. A row outside 0 .. N - 1 is never read. Lane j reads row c
// of its column at j (kStride - 1) + c + FILL: kStride is even, so that
// the lanes' columns fall in 32 distinct banks.
template <int N, int D, int LBW, int FILL>
struct BandLayout {
  static constexpr int kBW = FILL + LBW + 1;
  static constexpr int kStride = kBW + (kBW & 1);
  static constexpr int kRhs = N * kStride;
  static constexpr int kFloats = kRhs + D * N;
  static constexpr int kCols = (N + D + 31) / 32;  // columns a lane owns
  // A[r][j], j < N and r in j - FILL .. j + LBW
  __host__ __device__ static constexpr int at(int r, int j) {
    return j * kStride + r - j + FILL;
  }
  // row r of right-hand side d
  __host__ __device__ static constexpr int rhs(int r, int d) {
    return kRhs + d * N + r;
  }
};

// Column c's pass of warp_givens_solve; GUARD for the last LBW columns,
// whose rotations stop at row N - 1 (the others need no test per rotation).
template <int N, int D, int LBW, int FILL, bool GUARD>
__device__ __forceinline__ void givens_column(float* sys, float* diag,
                                              int lane, int c,
                                              const int (&base)[
                                                  BandLayout<N, D, LBW,
                                                             FILL>::kCols]) {
  using L = BandLayout<N, D, LBW, FILL>;
  constexpr int C = L::kCols;
  __syncwarp();  // column c's rows as the previous columns left them
  const float* pc = sys + L::at(c, c);
  // rows c .. c + LBW of column c and of this lane's columns (a lane past
  // the last column reads the last one's; only the lanes in the band write)
  int col[C];
  float a_cc = pc[0], a_r[LBW], own_c[C], own_r[C][LBW];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    col[k] = base[k] + c;
    own_c[k] = sys[col[k]];
  }
#pragma unroll
  for (int t = 0; t < LBW; ++t) {
    const bool in = !GUARD || c + 1 + t < N;
    a_r[t] = in ? pc[1 + t] : 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) own_r[k][t] = in ? sys[col[k] + 1 + t] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < LBW; ++t) {
    if (!GUARD || c + 1 + t < N) {
      float cs, sn;
      givens(a_cc, a_r[t], &cs, &sn);
      a_cc = rot_c(cs, sn, a_cc, a_r[t]);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float nr = rot_r(cs, sn, own_c[k], own_r[k][t]);
        own_c[k] = rot_c(cs, sn, own_c[k], own_r[k][t]);
        own_r[k][t] = nr;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = lane + 32 * k;
    if (j < N + D && j > c && (j <= c + FILL || j >= N)) {
      sys[col[k]] = own_c[k];
#pragma unroll
      for (int t = 0; t < LBW; ++t)
        if (!GUARD || c + 1 + t < N) sys[col[k] + 1 + t] = own_r[k][t];
    }
  }
  if (lane == (c & 31)) diag[c] = a_cc;
}

// Solve the banded system A x = b (A with LBW sub-diagonals, D right-hand
// sides) by Givens QR, then back-substitute: for each column c in order,
// rows c + 1 .. c + LBW rotated into row c, each rotation touching only the
// band columns [c, c + FILL] (QR fills the upper band to FILL) and the
// right-hand sides; entries left of the diagonal are never read again. For
// every entry that is read these are the values of the full-row rotations
// of ops/minco.py `_givens_solve`, in its order. One warp runs it, on the
// system in BandLayout in the warp's shared memory, column j owned by lane
// j % 32 (ceil((N + D) / 32) columns a lane, their offsets kept across the
// passes). Column c's pass loads A[c][c] and the LBW entries below it on
// every lane, and each lane rows c .. c + LBW of its own columns; then the
// rotations run in registers — A[c][c] carried on every lane, each (cs,
// sn) applied to the lane's columns as it comes — and the lanes whose
// columns lie in the band (c, c + FILL] or on the right-hand side write
// them back; the owner of column c writes the final pivot to diag[c]. No
// lane writes column c while another may still be loading it, so one sync
// per column suffices. Lanes 0 .. D-1 then back-substitute one right-hand
// side each into sol[N][D], the last FILL values in registers. Where
// N + D <= 32 each lane owns one column and every value goes through the
// operations, in the order, of the one-column-a-lane dense form. The loops
// run at run time, so the code stays a few hundred instructions.
template <int N, int D, int LBW, int FILL>
__device__ __forceinline__ void warp_givens_solve(float* sys, float* diag,
                                                  int lane, float* sol) {
  static_assert(LBW < N && D <= 32, "a band below the diagonal, D lanes");
  using L = BandLayout<N, D, LBW, FILL>;
  // offset of row 0 of this lane's columns (a lane past the last column
  // takes the last one's)
  int base[L::kCols];
#pragma unroll
  for (int k = 0; k < L::kCols; ++k) {
    const int j = min(lane + 32 * k, N + D - 1);
    base[k] = j < N ? L::at(0, j) : L::rhs(0, j - N);
  }
  int c = 0;
#pragma unroll 1
  for (; c < N - LBW; ++c)
    givens_column<N, D, LBW, FILL, false>(sys, diag, lane, c, base);
#pragma unroll 1
  for (; c < N; ++c)
    givens_column<N, D, LBW, FILL, true>(sys, diag, lane, c, base);
  __syncwarp();
  if (lane < D) {
    float xw[FILL];  // x[c + 1 .. c + FILL] of this right-hand side
#pragma unroll
    for (int t = 0; t < FILL; ++t) xw[t] = 0.0f;
#pragma unroll 1
    for (int c = N - 1; c >= 0; --c) {
      float acc = sys[L::rhs(c, lane)];
#pragma unroll
      for (int t = 0; t < FILL; ++t)
        if (c + 1 + t < N)
          acc = __fmaf_rn(-sys[L::at(c, c + 1 + t)], xw[t], acc);
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
