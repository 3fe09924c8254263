// The port's warp device code on a CPU, one std::thread a lane (see
// shim/cuda_runtime.h): the objective (neo::warp_objective), the banded
// Givens solve (neo::warp_givens_solve in B5's band layout) and the L-BFGS
// loop (neo::lbfgs_solve) over the scene SDF, one problem at a time, with
// plain C entries for ctypes. Build with -DNEO_M=M, as the kernels' per-M
// libraries are (tests/test_torch_warp_host.py).
#include <cuda_runtime.h>

#include <cstring>
#include <thread>
#include <vector>

#include "lbfgs_device.cuh"

namespace {

template <class F>
void run_warp(F&& lane_fn) {
  std::barrier<> bar(32);
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < 32; ++lane)
    lanes.emplace_back([&, lane] {
      warp_barrier = &bar;
      lane_fn(lane);
    });
  for (auto& t : lanes) t.join();
}

neo::SolveParams params(const float* host_params) {
  neo::SolveParams P;
  memcpy(&P, host_params, sizeof(P));
  return P;
}

template <int LBW>
void solve(const float* aug, float* out, int n_problems) {
  constexpr int N = neo::kNS, D = 2, W = N + D;
  using L = neo::BandLayout<N, D, LBW, neo::kFill>;
  std::vector<float> sys(L::kFloats), diag(N), sol(N * D);
  for (int p = 0; p < n_problems; ++p) {
    for (int r = 0; r < N; ++r)
      for (int j = 0; j < W; ++j) {
        const float v = aug[(static_cast<long>(p) * N + r) * W + j];
        const int off = r - j + neo::kFill;
        if (j >= N)
          sys[L::rhs(r, j - N)] = v;
        else if (off >= 0 && off < L::kBW)
          sys[L::at(r, j)] = v;
      }
    run_warp([&](int lane) {
      neo::warp_givens_solve<N, D, LBW, neo::kFill>(sys.data(), diag.data(),
                                                    lane, sol.data());
    });
    memcpy(out + static_cast<long>(p) * N * D, sol.data(),
           sizeof(float) * N * D);
  }
}

}  // namespace

extern "C" int host_num_vars() { return neo::kNV; }

// f (and g unless g_out is null) of n_problems problems, problem p on its
// own primitive table prims[p] (n_prims x 6)
extern "C" void host_objective_scene(const float* x, const float* head,
                                     const float* tail, const float* prims,
                                     int n_prims, int K,
                                     const float* host_params, int n_problems,
                                     float* f_out, float* g_out) {
  const neo::SolveParams P = params(host_params);
  std::vector<float> smem(neo::kScratchFloats + 6 * n_prims);
  for (int p = 0; p < n_problems; ++p) {
    float* pr = smem.data() + neo::kScratchFloats;
    memcpy(pr, prims + static_cast<long>(p) * n_prims * 6,
           sizeof(float) * 6 * n_prims);
    run_warp([&](int lane) {
      float xv[neo::kNV], hd[6], tl[6], g[neo::kNV];
      for (int i = 0; i < neo::kNV; ++i) xv[i] = x[p * neo::kNV + i];
      for (int i = 0; i < 6; ++i) {
        hd[i] = head[p * 6 + i];
        tl[i] = tail[p * 6 + i];
      }
      const neo::SceneQuery q{pr, n_prims};
      const float f =
          g_out ? neo::warp_objective<true>(xv, hd, tl, q, K, P, lane,
                                            smem.data(), g)
                : neo::warp_objective<false>(xv, hd, tl, q, K, P, lane,
                                             smem.data(), g);
      if (lane == 0) {
        f_out[p] = f;
        if (g_out)
          for (int i = 0; i < neo::kNV; ++i) g_out[p * neo::kNV + i] = g[i];
      }
    });
  }
}

// B5's solve of aug (n_problems, n, n + 2), n = 6M, lower bandwidth 4 or 2
extern "C" void host_banded_solve(const float* aug, float* out,
                                  int n_problems, int lower_bw) {
  if (lower_bw == 4)
    solve<4>(aug, out, n_problems);
  else
    solve<2>(aug, out, n_problems);
}

// B1's solve of n_problems problems with history hist
extern "C" void host_lbfgs_scene(const float* x0, const float* head,
                                 const float* tail, const float* prims,
                                 int n_prims, int K, int max_iters,
                                 int max_ls, int hist,
                                 const float* host_params, int n_problems,
                                 float* x_out, float* f_out, int* it_out) {
  const neo::SolveParams P = params(host_params);
  std::vector<float> smem(neo::warp_floats(hist) + 6 * n_prims);
  for (int p = 0; p < n_problems; ++p) {
    float* pr = smem.data() + neo::warp_floats(hist);
    memcpy(pr, prims + static_cast<long>(p) * n_prims * 6,
           sizeof(float) * 6 * n_prims);
    run_warp([&](int lane) {
      float x[neo::kNV], hd[6], tl[6], f = 0.0f;
      int it = 0;
      for (int i = 0; i < neo::kNV; ++i) x[i] = x0[p * neo::kNV + i];
      for (int i = 0; i < 6; ++i) {
        hd[i] = head[p * 6 + i];
        tl[i] = tail[p * 6 + i];
      }
      const neo::SceneQuery q{pr, n_prims};
      neo::lbfgs_solve(x, hd, tl, q, K, max_iters, max_ls, hist, P,
                       smem.data(), lane, &f, &it);
      if (lane == 0) {
        for (int i = 0; i < neo::kNV; ++i) x_out[p * neo::kNV + i] = x[i];
        f_out[p] = f;
        it_out[p] = it;
      }
    });
  }
}
