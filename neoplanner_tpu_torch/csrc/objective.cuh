// B2: the MINCO objective and its hand adjoint, as __device__ code over any
// distance query: warp_objective, one problem per warp. B1 (lbfgs_scene.cu,
// the scene SDF) and B6 (lbfgs_grid.cu, the bilinear ESDF window taps) run
// it inside their L-BFGS loop, B2s and B7 (objective_eval.cu) once per
// launch, so the fused and the per-evaluation solvers evaluate the same
// objective bit for bit. The per-sample terms (polynomial, hinges, distance
// query and per-sample cotangents), the energy quadrature, the system
// entries and the adjoint's gradient are one function each. There is no
// launch of its own.
//
// A query is a type with
//   template <bool GRAD> float dist(float px, float py, float* gx, float* gy)
// returning the distance at a sample and, with GRAD, its gradient.
//
// Replaces the device functions of neoplanner_tpu/plan/costs_pallas.py:
// `_system_entries` (:90), `_solve_entries` (:124, here
// neo::warp_givens_solve), `_scene_min_dist`
// (:153), `common_fwd` (:234), `fwd_nocoll` (:302), `valgrad_poly` (:330),
// `scene_valgrad_values` (:483) and `scene_value` (:499).
//
// The TPU form keeps (S, 512-lane) sample arrays in VMEM and reduces them at
// the end; here the samples are streamed, and the value, the duration
// cotangents and the coefficient cotangents accumulated as they go, so
// nothing per sample is stored. The adjoint is the reference's hand
// gradient (expert_planner.py:345-537): per-sample penalty cotangents, the
// transposed banded solve lam = A^-T cbar, waypoint gradients from the
// b-rows, dA/dT through d beta_k/dT = beta_{k+1}, and the sigmoid tau chain.
#pragma once

#include "minco_device.cuh"

// The piece count M is fixed per build: each M in 2..16 has its own
// library, compiled with -DNEO_M=M (_cuda.load_pieces).
#ifndef NEO_M
#define NEO_M 3
#endif

namespace neo {

constexpr int kM = NEO_M;                 // pieces
static_assert(kM >= 2 && kM <= 16, "M in 2..16");
constexpr int kDim = 2;                   // planar trajectories
constexpr int kNW = kM - 1;               // intermediate waypoints
constexpr int kNV = kDim * kNW + kM;      // decision variables (3M - 2)
constexpr int kNS = 6 * kM;               // system size (6M)
constexpr int kFill = 6;                  // upper band of R (LBW + UBW)
using FwdBand = BandLayout<kNS, kDim, 4, kFill>;  // A
using AdjBand = BandLayout<kNS, kDim, 2, kFill>;  // A^T

struct SolveParams {
  float t_min, t_max, v_max, safe_dis, w_e, w_t, w_f, w_c, ftol, gtol, c1;
};

// The weighted sum of the cost terms.
__device__ __forceinline__ float weighted(const SolveParams& P, float energy,
                                          float time_cost, float feas,
                                          float coll) {
  return __fmaf_rn(P.w_c, coll,
                   __fmaf_rn(P.w_f, feas,
                             __fmaf_rn(P.w_e, energy,
                                       __fmul_rn(P.w_t, time_cost))));
}

__device__ __forceinline__ void powers6(float t, float (&p)[6]) {
  p[0] = 1.0f;
#pragma unroll
  for (int i = 1; i < 6; ++i) p[i] = __fmul_rn(p[i - 1], t);
}

// The piece durations T and their sigmoids from the decision vector's taus.
__device__ __forceinline__ void durations(const float (&x)[kNV],
                                          const SolveParams& P,
                                          float (&sig)[kM], float (&T)[kM]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float s = 1.0f / __fadd_rn(1.0f, expf(-x[kDim * kNW + m]));
    sig[m] = s;
    T[m] = __fmaf_rn(P.t_max - P.t_min, s, P.t_min);
  }
}

// T[i] for a run-time i, by selects (no local-memory indexing)
__device__ __forceinline__ float piece_value(const float (&T)[kM], int i) {
  float v = T[0];
#pragma unroll
  for (int m = 1; m < kM; ++m) v = i == m ? T[m] : v;
  return v;
}

// put(r, c, v) for the nonzero entries of A(T) (minco.build_system) in
// group g: 0 the head rows, 1 .. kM - 1 the continuity rows of piece
// g - 1, kM the tail rows; any other g puts nothing. Lane g of a warp
// takes group g, so the groups are written side by side.
template <class Put>
__device__ __forceinline__ void system_entries(const float (&T)[kM], int g,
                                               Put&& put) {
  if (g == 0) {
    put(0, 0, 1.0f);
    put(1, 1, 1.0f);
    put(2, 2, 2.0f);
  } else if (g < kM) {
    const int i = g - 1;
    float p[6];
    powers6(piece_value(T, i), p);
    const int c0 = 6 * i, base = 6 * i + 3;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      // derivative order of row rr: 0, 0, 1, 2, 3, 4 (arithmetic, so that
      // the j loop's bounds fold and every power index stays a constant)
      const int k = rr > 0 ? rr - 1 : 0;
#pragma unroll
      for (int j = k; j < 6; ++j)
        put(base + rr, c0 + j, __fmul_rn(falling(k, j), p[j - k]));
      if (rr >= 1) put(base + rr, c0 + 6 + rr - 1, -falling(rr - 1, rr - 1));
    }
  } else if (g == kM) {
    float p[6];
    powers6(T[kM - 1], p);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = k; j < 6; ++j)
        put(kNS - 3 + k, kNS - 6 + j, __fmul_rn(falling(k, j), p[j - k]));
  }
}

// put(r, bx, by) for every nonzero row of the forward right-hand side: the
// head and tail states and the intermediate waypoints.
template <class Put>
__device__ __forceinline__ void rhs_entries(const float (&x)[kNV],
                                            const float (&head)[6],
                                            const float (&tail)[6],
                                            Put&& put) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(k, head[k * kDim], head[k * kDim + 1]);
    put(kNS - 3 + k, tail[k * kDim], tail[k * kDim + 1]);
  }
#pragma unroll
  for (int i = 0; i < kNW; ++i) put(6 * i + 3, x[i], x[kNW + i]);
}

// The energy, a 3-point Gauss-Legendre of |jerk|^2 per piece, from the
// coefficients xs[6m + j][d] at xs[(6m + j) * kDim + d]; with GRAD lane 0
// starts the sums with its cotangents: cbar[6m + j][d] at sums[(6m + j) *
// kDim + d] and Tbar[m] + w_t at sums[sum_tbar + m].
template <bool GRAD>
__device__ __forceinline__ float energy_terms(const float* xs,
                                              const float (&T)[kM],
                                              const SolveParams& P, int lane,
                                              float* sums, int sum_tbar) {
  const float gl_nodes[3] = {0.5f - 0.38729833462074170f, 0.5f,
                             0.5f + 0.38729833462074170f};
  const float gl_w[3] = {5.0f / 18.0f, 8.0f / 18.0f, 5.0f / 18.0f};
  float energy = 0.0f;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float* c = xs + 6 * m * kDim;
    float Te = 0.0f, ce[6][kDim] = {};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float t = T[m] * gl_nodes[q];
      const float pw3[3] = {1.0f, t, t * t};
      float jx = 0.0f, jy = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
      for (int j = 3; j < 6; ++j) {
        const float b3 = __fmul_rn(falling(3, j), pw3[j - 3]);
        jx = __fmaf_rn(b3, c[j * kDim], jx);
        jy = __fmaf_rn(b3, c[j * kDim + 1], jy);
        if (GRAD && j >= 4) {
          const float b4 = __fmul_rn(falling(4, j), pw3[j - 4]);
          sx = __fmaf_rn(b4, c[j * kDim], sx);
          sy = __fmaf_rn(b4, c[j * kDim + 1], sy);
        }
      }
      const float jsq = __fmaf_rn(jx, jx, __fmul_rn(jy, jy));
      energy = __fmaf_rn(__fmul_rn(gl_w[q], T[m]), jsq, energy);
      if (GRAD) {
        const float js = __fmaf_rn(jx, sx, __fmul_rn(jy, sy));
        const float dt = __fmaf_rn(__fmul_rn(__fmul_rn(T[m], 2.0f), js),
                                   gl_nodes[q], jsq);
        Te = __fmaf_rn(__fmul_rn(P.w_e, gl_w[q]), dt, Te);
        const float scale = __fmul_rn(__fmul_rn(P.w_e, gl_w[q]),
                                      __fmul_rn(T[m], 2.0f));
#pragma unroll
        for (int j = 3; j < 6; ++j) {
          const float b3 = __fmul_rn(falling(3, j), pw3[j - 3]);
          ce[j][0] = __fmaf_rn(__fmul_rn(scale, jx), b3, ce[j][0]);
          ce[j][1] = __fmaf_rn(__fmul_rn(scale, jy), b3, ce[j][1]);
        }
      }
    }
    if (GRAD && lane == 0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        sums[(6 * m + j) * kDim] = ce[j][0];
        sums[(6 * m + j) * kDim + 1] = ce[j][1];
      }
      sums[sum_tbar + m] = Te + P.w_t;
    }
  }
  return energy;
}

// What one sample adds to the sums, which warp_objective adds in sample
// order, one fused multiply-add a step: feas += whv * hv2, coll += whc *
// hc2, and with the gradient Tbar[m] += tbar and, for each power j of piece
// m, cbar[6m + j][d] += pp_d * pw[j], then += (j * pv_d) * pw[j - 1].
struct SampleTerms {
  float whv, hv2, whc, hc2;  // the hinge terms: w * h and h^2
  float tbar;                // the sample's share of Tbar[m]
  float pp[kDim], pv[kDim];  // position and velocity cotangents
  float pw[6];               // (T[m] * k / (K - 1))^j
};

// Sample k of K on a piece of duration Tm with coefficients c[j][d] (power
// j): its position, velocity (and acceleration), the hinges, the distance
// query and, with GRAD, the per-sample cotangents.
template <bool GRAD, class Query>
__device__ __forceinline__ SampleTerms sample_terms(const float (&c)[6][kDim],
                                                    float Tm, int k, int K,
                                                    const Query& query,
                                                    const SolveParams& P) {
  SampleTerms t;
  const float inv_km1 = 1.0f / static_cast<float>(K - 1);
  const float frac = static_cast<float>(k) / static_cast<float>(K - 1);
  const float omg = (k == 0 || k == K - 1) ? 0.5f : 1.0f;
  const float w = omg * Tm / static_cast<float>(K - 1);
  powers6(Tm * frac, t.pw);
  float px = 0.0f, py = 0.0f, vx = 0.0f, vy = 0.0f, ax = 0.0f, ay = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float cx = c[j][0], cy = c[j][1];
    px = __fmaf_rn(t.pw[j], cx, px);
    py = __fmaf_rn(t.pw[j], cy, py);
    if (j >= 1) {
      const float b1 = __fmul_rn(falling(1, j), t.pw[j - 1]);
      vx = __fmaf_rn(b1, cx, vx);
      vy = __fmaf_rn(b1, cy, vy);
    }
    if (GRAD && j >= 2) {
      const float b2 = __fmul_rn(falling(2, j), t.pw[j - 2]);
      ax = __fmaf_rn(b2, cx, ax);
      ay = __fmaf_rn(b2, cy, ay);
    }
  }
  const float hv = fmaxf(__fsub_rn(__fmaf_rn(vx, vx, __fmul_rn(vy, vy)),
                                   __fmul_rn(P.v_max, P.v_max)),
                         0.0f);
  t.hv2 = __fmul_rn(hv, hv);
  t.whv = __fmul_rn(w, hv);
  float gsx = 0.0f, gsy = 0.0f;
  const float dis = query.template dist<GRAD>(px, py, &gsx, &gsy);
  const float hc = fmaxf(P.safe_dis - dis, 0.0f);
  t.hc2 = __fmul_rn(hc, hc);
  t.whc = __fmul_rn(w, hc);
  if (GRAD) {
    const float g_s = __fmul_rn(__fmul_rn(P.w_c, w), __fmul_rn(3.0f, t.hc2));
    const float ppx = __fmul_rn(-g_s, gsx), ppy = __fmul_rn(-g_s, gsy);
    const float chcw = __fmul_rn(__fmul_rn(P.w_c, hc), t.hc2);
    const float e_s = __fmul_rn(__fmul_rn(P.w_f, w), __fmul_rn(3.0f, t.hv2));
    const float pvx = __fmul_rn(__fmul_rn(e_s, 2.0f), vx);
    const float pvy = __fmul_rn(__fmul_rn(e_s, 2.0f), vy);
    const float hinge = __fmaf_rn(__fmul_rn(P.w_f, hv), t.hv2, chcw);
    const float pdot = __fmaf_rn(
        pvy, ay, __fmaf_rn(pvx, ax, __fmaf_rn(ppy, vy, __fmul_rn(ppx, vx))));
    t.tbar = __fmaf_rn(pdot, frac, __fmul_rn(__fmul_rn(omg, inv_km1), hinge));
    t.pp[0] = ppx;
    t.pp[1] = ppy;
    t.pv[0] = pvx;
    t.pv[1] = pvy;
  }
  return t;
}

// The gradient g from the adjoint lam = A^-T cbar: the waypoints' b-row
// cotangents, Abar = -lam xs^T into Tbar through d beta_k / dT = beta_{k+1},
// and the sigmoid tau chain. lam and xs as warp_givens_solve leaves them in
// shared memory: row r, dimension d at [r * kDim + d].
__device__ __forceinline__ void adjoint_gradient(
    const float* lam, const float* xs, const float (&T)[kM],
    const float (&sig)[kM], float (&Tbar)[kM], const SolveParams& P,
    float (&g)[kNV]) {
#pragma unroll
  for (int i = 0; i < kNW; ++i) {
    g[i] = lam[(6 * i + 3) * kDim];
    g[kNW + i] = lam[(6 * i + 3) * kDim + 1];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float p[6];
    powers6(T[i], p);
    const bool last = (i == kM - 1);
    const int c0 = last ? kNS - 6 : 6 * i;
    const int base = last ? kNS - 3 : 6 * i + 3;
    const int n_rows = last ? 3 : 6;
    float acc = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      if (rr >= n_rows) break;
      const int k = last ? rr : (rr > 0 ? rr - 1 : 0);
      const float* lr = lam + (base + rr) * kDim;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) {
        const float dA = __fmul_rn(falling(k + 1, j), p[j - k - 1]);
        const float* xj = xs + (c0 + j) * kDim;
        const float lx = __fmaf_rn(lr[0], xj[0], __fmul_rn(lr[1], xj[1]));
        acc = __fmaf_rn(-dA, lx, acc);
      }
    }
    Tbar[i] += acc;
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
    g[kDim * kNW + m] = __fmul_rn(__fmul_rn(Tbar[m], P.t_max - P.t_min),
                                  __fmul_rn(sig[m], 1.0f - sig[m]));
}

// The scene SDF query: one env's primitives in the warp's shared memory,
// [n_prims][6] (scene_min_dist at stride 1).
struct SceneQuery {
  const float* pr;
  int n_prims;
  template <bool GRAD>
  __device__ __forceinline__ float dist(float px, float py, float* gx,
                                        float* gy) const {
    return scene_min_dist<GRAD>(pr, 1, n_prims, px, py, gx, gy);
  }
};

// A warp's shared-memory scratch for warp_objective: 32 sample records of
// kTermStride floats (the SampleTerms fields, then the constants 1 and 0);
// the sums (cbar by row and dimension, Tbar, feas, coll); the banded system
// (BandLayout, sized for the forward band), its diagonal, the forward
// solution xs (the coefficients) and the adjoint's lam. plan/objective.py
// `scratch_floats` mirrors the count.
enum : int {
  kWhv, kHv2, kWhc, kHc2, kTbar, kPp, kPv = kPp + kDim, kPw = kPv + kDim,
  kOne = kPw + 6, kZero, kTermStride  // 17, odd: one record per lane hits
};                                    // 32 distinct banks
constexpr int kSumTbar = 2 * kNS, kSumFeas = kSumTbar + kM,
              kSumColl = kSumFeas + 1;
constexpr int kSumOff = 32 * kTermStride;
constexpr int kSysOff = kSumOff + kSumColl + 1;
constexpr int kDiagOff = kSysOff + FwdBand::kFloats;
constexpr int kSolOff = kDiagOff + kNS;
constexpr int kLamOff = kSolOff + kNS * kDim;
constexpr int kScratchFloats = kLamOff + kNS * kDim;
static_assert(AdjBand::kFloats <= FwdBand::kFloats, "the adjoint fits");

// A(T) (or its transpose) into sys in warp_givens_solve's band layout: the
// band and the right-hand sides zeroed, then lane g puts group g's entries
// (system_entries). The caller then sets the right-hand sides.
template <bool TRANSPOSE>
__device__ __forceinline__ void store_system(const float (&T)[kM], int lane,
                                             float* sys) {
  using L = BandLayout<kNS, kDim, TRANSPOSE ? 2 : 4, kFill>;
  for (int i = lane; i < L::kFloats; i += 32) sys[i] = 0.0f;
  __syncwarp();
  system_entries(T, lane, [&](int r, int c, float v) {
    sys[TRANSPOSE ? L::at(c, r) : L::at(r, c)] = v;
  });
}

// The weighted objective of decision vector x, one problem per warp (B1,
// B6, B2s, B7); with GRAD also its gradient g. head/tail: [pos; vel; acc]
// x (x, y), row-major. Every lane passes the same x, head and tail and gets
// back the same f and g. The two banded solves run by columns over the
// lanes (warp_givens_solve). The samples
// of each piece go over the lanes (lane l takes k = l, l + 32, ...), each
// writing its SampleTerms to a record in scratch; then one lane per sum —
// lanes 0-11 cbar[6m + j][d] (j = lane % 6, d = lane / 6), 12 Tbar[m], 13
// feas, 14 coll — adds the records in sample order with fused
// multiply-adds, starting from the energy's share. So no sum depends on
// how the samples were spread, and no atomics: a repeat launch reproduces
// every bit. The energy quadrature and the adjoint's gradient are a few
// hundred operations on values every lane holds: each lane computes them
// itself, reading the coefficients and lam from the scratch. With have_xs
// the scratch already holds the coefficients of this x (the previous
// evaluation was at the same x), and the forward solve is skipped.
template <bool GRAD, class Query>
__device__ __forceinline__ float warp_objective(const float (&x)[kNV],
                                                const float (&head)[6],
                                                const float (&tail)[6],
                                                const Query& query, int K,
                                                const SolveParams& P,
                                                int lane, float* scratch,
                                                float (&g)[kNV],
                                                bool have_xs = false) {
  float* sums = scratch + kSumOff;
  float* sys = scratch + kSysOff;
  float* diag = scratch + kDiagOff;
  float* sol = scratch + kSolOff;
  float* lam = scratch + kLamOff;
  float sig[kM], T[kM];
  durations(x, P, sig, T);

  // ---- forward: coefficients of the banded MINCO system
  if (!have_xs) {
    store_system<false>(T, lane, sys);
    if (lane == 0)
      rhs_entries(x, head, tail, [&](int r, float bx, float by) {
        sys[FwdBand::rhs(r, 0)] = bx;
        sys[FwdBand::rhs(r, 1)] = by;
      });
    warp_givens_solve<kNS, kDim, 4, kFill>(sys, diag, lane, sol);
  }

  // ---- energy: on every lane; with the gradient its share starts the
  // sums
  const float energy = energy_terms<GRAD>(sol, T, P, lane, sums, kSumTbar);

  // ---- sampled terms: this lane's sum adds fma(r[f1x], r[f1y], .) and,
  // with the gradient, fma(s2 * r[f2x], r[f2y], .) for each record r
  // (cbar's two steps; Tbar's add is an fma by 1; zeros where a sum has no
  // second step: fma(0, 0, a) is a, for feas and coll never -0)
  const int cj = lane % 6, cd = lane / 6;
  const bool is_cbar = GRAD && lane < 2 * 6, is_tbar = GRAD && lane == 12;
  int f1x = kZero, f1y = kZero, f2x = kZero, f2y = kZero;
  float s2 = 0.0f;
  if (is_cbar) {
    f1x = kPp + cd;
    f1y = kPw + cj;
    if (cj >= 1) {
      f2x = kPv + cd;
      f2y = kPw + cj - 1;
      s2 = static_cast<float>(cj);
    }
  } else if (is_tbar) {
    f1x = kTbar;
    f1y = kOne;
  } else if (lane == 13) {
    f1x = kWhv;
    f1y = kHv2;
  } else if (lane == 14) {
    f1x = kWhc;
    f1y = kHc2;
  }
  float* rec = scratch + lane * kTermStride;
  rec[kOne] = 1.0f;
  rec[kZero] = 0.0f;
  __syncwarp();
  float carry = 0.0f;  // feas and coll run over all pieces
#pragma unroll 1
  for (int m = 0; m < kM; ++m) {
    float c[6][kDim];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      c[j][0] = sol[(6 * m + j) * kDim];
      c[j][1] = sol[(6 * m + j) * kDim + 1];
    }
    const float Tm = piece_value(T, m);
    const int slot = is_cbar ? (6 * m + cj) * kDim + cd
                             : (is_tbar ? kSumTbar + m : -1);
    float a = slot >= 0 ? sums[slot] : carry;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      if (lane < n) {
        const SampleTerms t = sample_terms<GRAD>(c, Tm, k0 + lane, K, query,
                                                 P);
        rec[kWhv] = t.whv;
        rec[kHv2] = t.hv2;
        rec[kWhc] = t.whc;
        rec[kHc2] = t.hc2;
        if (GRAD) {
          rec[kTbar] = t.tbar;
#pragma unroll
          for (int d = 0; d < kDim; ++d) {
            rec[kPp + d] = t.pp[d];
            rec[kPv + d] = t.pv[d];
          }
#pragma unroll
          for (int j = 0; j < 6; ++j) rec[kPw + j] = t.pw[j];
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float* r = scratch + i * kTermStride;
        a = __fmaf_rn(r[f1x], r[f1y], a);
        if (GRAD) a = __fmaf_rn(__fmul_rn(s2, r[f2x]), r[f2y], a);
      }
      __syncwarp();
    }
    if (slot >= 0)
      sums[slot] = a;
    else
      carry = a;
  }
  if (lane == 13) sums[kSumFeas] = carry;
  if (lane == 14) sums[kSumColl] = carry;
  __syncwarp();
  const float feas = sums[kSumFeas], coll = sums[kSumColl];
  float time_cost = 0.0f;
#pragma unroll
  for (int m = 0; m < kM; ++m) time_cost = time_cost + T[m];
  const float f = weighted(P, energy, time_cost, feas, coll);
  if (!GRAD) return f;

  // ---- adjoint: transposed banded solve lam = A^-T cbar
  float Tbar[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) Tbar[m] = sums[kSumTbar + m];
  store_system<true>(T, lane, sys);
  for (int i = lane; i < kNS * kDim; i += 32)
    sys[AdjBand::rhs(i / kDim, i % kDim)] = sums[i];
  warp_givens_solve<kNS, kDim, 2, kFill>(sys, diag, lane, lam);
  adjoint_gradient(lam, sol, T, sig, Tbar, P, g);
  return f;
}

}  // namespace neo
