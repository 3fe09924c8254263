// B2s and B7: one evaluation of the trajectory objective per problem, the
// value alone (the line search's candidates) or the value and its gradient
// (the accepted point), over the scene SDF (B2s) or a per-env ESDF window
// (B7). The per-evaluation solve (plan/solve.py `solve_per_eval`) drives
// them from ops/lbfgs.minimize, as the JAX package's per-evaluation branch
// of plan/expert.solve_one (expert.py:148-167, :193-204) does.
//
// Replaces:
// - B2s, neoplanner_tpu/plan/costs_pallas.py `_make_kernels` (:514):
//   `fwd_kernel` (called at :591) and `valgrad_kernel` (called at :609);
// - B7, neoplanner_tpu/plan/costs_pallas_grid.py K1 `_make_k1` (:79, called
//   at :129), K2 `_make_k2` (:183, called at :272) and K3 `_make_k3` (:94,
//   called at :162), with the XLA glue between them (`_window_coords` :304,
//   the out-of-map FAR and the hinge cotangents, :322-356).
// Python wrappers: plan/objective.py; plain versions: plan/costs.objective,
// with autograd for the gradient.
//
// Design: one warp per problem, kWarps problems per block, each warp
// calling neo::warp_objective<GRAD, Query> (objective.cuh), the form that
// B1 and B6 run inside their L-BFGS loop, on its own kScratchFloats of
// shared memory: a piece's samples go over the lanes, each sum is then
// taken in sample order by one lane, and each Givens rotation of the two
// banded solves is one step of the lanes that hold its columns. A null
// g_out selects the value kernel. The launches of the lazy banks (3072
// scene and 1536 window problems, and four line-search candidates of each
// for the value) give the card thousands of warps, where one thread per
// problem left most SMs empty and ran each problem's 72 samples (x 24
// primitives) in one thread. B7's chain K1 -> K2 -> K3 was three programs
// only because the TPU's tiles split the MINCO algebra (flat 512-lane
// tiles) from the window sampling (env-tiled one-hot MXU matmuls): here a
// tap is four indexed loads through the read-only cache, and the
// positions, distances and collision cotangents that crossed HBM between
// K1, K2 and K3 are never stored. The scene kernel stages the env's
// primitive table once per warp in the warp's shared memory (stride 1,
// read as broadcasts: all lanes test the same primitive at once), after
// the scratch. A warp past the last problem leaves at once: no barrier
// spans the block, so a ragged last block never splits a warp around
// warp_objective's syncs. Lane 0 stores f and g; every lane holds them
// alike, and no sum takes atomics, so a repeat launch reproduces every bit.
//
// Bound on the H100: operations, and one warp's chain per evaluation — per
// problem ~M*K samples (x 24 primitives, or 4 window taps) from ~100 bytes
// of input, then the banded solves' rotations, one IEEE square root and
// divide each (62 forward, and 33 transposed with the gradient), in
// sequence, every lane issuing every rotation. An SM interleaves its
// resident warps' chains, so a launch takes about one chain per wave of
// resident warps. __launch_bounds__(128, 4) holds the value-and-gradient
// kernels to 128 registers (ptxas: 114 scene, 126 window; 16 warps an SM)
// and leaves the value kernels at the compiler's 52 / 58 (32-36 warps an
// SM); no kernel spills. Measured on the H100 at the lazy banks' shapes
// (PERF.md): more blocks an SM (40-48 registers) spill and ran no faster,
// and 2 or 8 warps a block changed nothing. The value kernels' candidates
// fill 1-3 waves. Where a whole bank's 6144 window candidates (the expert
// loop's first launch) fill 1.5 waves, the earlier kernel, one thread per
// problem, ran 2-4% faster; at the retries' 4096 the warp form takes 25%
// less time, at 2048 55% less, and on the scene less at every size.
#include <string.h>

#include "objective.cuh"
#include "window_query.cuh"

namespace {

constexpr int kWarps = 4;      // problems per block, one warp each
constexpr int kBlock = 32 * kWarps;
constexpr int kMinBlocks = 4;  // per SM: at most 128 registers a thread

using neo::kNV;

template <bool GRAD, class Query>
__device__ __forceinline__ void evaluate(int p, int lane,
                                         const float* __restrict__ x,
                                         const float* __restrict__ head,
                                         const float* __restrict__ tail,
                                         const Query& query, int K,
                                         const neo::SolveParams& P,
                                         float* scratch,
                                         float* __restrict__ f_out,
                                         float* __restrict__ g_out) {
  float xv[kNV], hd[6], tl[6], g[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) xv[i] = x[p * kNV + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    hd[i] = head[p * 6 + i];
    tl[i] = tail[p * 6 + i];
  }
  const float f =
      neo::warp_objective<GRAD>(xv, hd, tl, query, K, P, lane, scratch, g);
  if (lane == 0) {
    f_out[p] = f;
    if (GRAD) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) g_out[p * kNV + i] = g[i];
    }
  }
}

template <bool GRAD>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    objective_scene_kernel(const float* __restrict__ x,
                           const float* __restrict__ head,
                           const float* __restrict__ tail,
                           const float* __restrict__ prims,
                           const int* __restrict__ env_of,
                           float* __restrict__ f_out,
                           float* __restrict__ g_out, int n_problems,
                           int n_prims, int K, neo::SolveParams P) {
  // per warp: warp_objective's scratch, then the env's primitives
  // [n_prims][6]
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_problems) return;  // the whole warp
  float* scratch = smem + warp * (neo::kScratchFloats + 6 * n_prims);
  float* pr = scratch + neo::kScratchFloats;
  const float* src = prims + static_cast<long long>(env_of[p]) * n_prims * 6;
  for (int i = lane; i < n_prims * 6; i += 32) pr[i] = src[i];
  __syncwarp();
  const neo::SceneQuery query{pr, n_prims};
  evaluate<GRAD>(p, lane, x, head, tail, query, K, P, scratch, f_out, g_out);
}

template <bool GRAD>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    objective_grid_kernel(const float* __restrict__ x,
                          const float* __restrict__ head,
                          const float* __restrict__ tail,
                          const float* __restrict__ win,
                          const float* __restrict__ worg,
                          const int* __restrict__ env_of,
                          float* __restrict__ f_out,
                          float* __restrict__ g_out, int n_problems, int Hw,
                          int Ww, int K, neo::SolveParams P) {
  __shared__ float scratch[kWarps][neo::kScratchFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_problems) return;  // the whole warp
  const neo::WindowQuery query =
      neo::window_query(win, worg, env_of[p], Hw, Ww);
  evaluate<GRAD>(p, lane, x, head, tail, query, K, P, scratch[warp], f_out,
                 g_out);
}

neo::SolveParams params(const float* host_params) {
  neo::SolveParams P;
  static_assert(sizeof(neo::SolveParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  return P;
}

// The scene kernel's launch: its dynamic shared memory, raised past the
// default 48 KB where the primitive table needs it.
template <bool GRAD>
int launch_scene(const float* x, const float* head, const float* tail,
                 const float* prims, const int* env_of, float* f_out,
                 float* g_out, int n_problems, int n_prims, int K,
                 const neo::SolveParams& P, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(neo::kScratchFloats + 6 * n_prims) *
                      kWarps * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        objective_scene_kernel<GRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_problems + kWarps - 1) / kWarps);
  objective_scene_kernel<GRAD><<<grid, kBlock, smem, s>>>(
      x, head, tail, prims, env_of, f_out, g_out, n_problems, n_prims, K, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int neo_objective_scene(const void* x, const void* head,
                                   const void* tail, const void* prims,
                                   const void* env_of, void* f_out,
                                   void* g_out, int n_problems, int n_prims,
                                   int K, const float* host_params,
                                   void* stream) {
  const neo::SolveParams P = params(host_params);
  const auto launch = g_out != nullptr ? launch_scene<true>
                                       : launch_scene<false>;
  return launch(static_cast<const float*>(x), static_cast<const float*>(head),
                static_cast<const float*>(tail),
                static_cast<const float*>(prims),
                static_cast<const int*>(env_of), static_cast<float*>(f_out),
                static_cast<float*>(g_out), n_problems, n_prims, K, P,
                static_cast<cudaStream_t>(stream));
}

extern "C" int neo_objective_grid(const void* x, const void* head,
                                  const void* tail, const void* win,
                                  const void* worg, const void* env_of,
                                  void* f_out, void* g_out, int n_problems,
                                  int Hw, int Ww, int K,
                                  const float* host_params, void* stream) {
  const neo::SolveParams P = params(host_params);
  const dim3 grid((n_problems + kWarps - 1) / kWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* hp = static_cast<const float*>(head);
  const auto* tp = static_cast<const float*>(tail);
  const auto* wp = static_cast<const float*>(win);
  const auto* op = static_cast<const float*>(worg);
  const auto* ep = static_cast<const int*>(env_of);
  auto* fp = static_cast<float*>(f_out);
  auto* gp = static_cast<float*>(g_out);
  if (gp != nullptr)
    objective_grid_kernel<true><<<grid, kBlock, 0, s>>>(
        xp, hp, tp, wp, op, ep, fp, gp, n_problems, Hw, Ww, K, P);
  else
    objective_grid_kernel<false><<<grid, kBlock, 0, s>>>(
        xp, hp, tp, wp, op, ep, fp, gp, n_problems, Hw, Ww, K, P);
  return static_cast<int>(cudaGetLastError());
}
