// The tiled dense polar depth fusion shared by B8 v2 (csrc/fusion.cu, one
// frame per env), B8 v3 (csrc/fusion_multi.cu, F frames per env) and B8 v1
// (csrc/fusion_window.cu, one frame per env on a window of the grid): one
// template, fuse_tile_kernel<kOneClip, Hit, kWindow>.
//
// All three port neoplanner_tpu/mapping/occupancy_pallas.py: v2
// `_make_kernel_v2` (:176, launched at :263) and v1 `_make_kernel` (:51,
// launched at :121) with the hit scatter `_scatter_hits` (:494), v3
// `_make_kernel_v3` (:299, launched at :419). Per env, frame after frame in
// order, each cell of the (H, W) log-odds grid
//   v3 (kOneClip):  cell = clip((cell + carve_f) + float(k_f) * l_hit)
//   v2 and v1:      cell = clip(cell + carve), then k times
//                   cell = clip(cell + l_hit)
// where carve_f is l_miss on the cells in front of the frame's per-column
// carve range (r_cell < r_carve(u) - res at the cell's image column u) and
// 0 elsewhere, and k_f the number of the frame's columns whose hit falls in
// the cell. The k sequential clip-adds are the bits of the compare-and-swap
// scatter that v2 and v1 launched before: every add is the same l_hit onto
// a clipped value, so any order of them gives the same cell.
//
// v1 (kWindow) runs this on a (ch, cw) window of each env's grid, at org's
// [r0, c0], in place: the tiles cover the window, not the grid, and a block
// takes all of an env's window (kWindowTiles tiles at most), so the table
// is staged once per env. Its cells take their positions from the window's
// origin (sc[0], sc[1]: the world centre of the window's cell (0, 0)), and
// its column index rounds half to even (rintf, jnp.round; v2 takes
// floor(u + 0.5)): v1 is not v2 restricted to a window. Both roundings
// keep a cell's column only for u in [-0.5, Wcam - 0.5], the closed strip
// the reach test's half-planes bound. A window row starts at an arbitrary
// column, so v1 loads and stores 4 bytes a lane; a lane's four cells run
// down a column of its strip, two rows apart, so that each load and store
// of a warp covers two runs of 16 cells of a window row (the row-wise
// mapping of v2 and v3, eight rows of 16 bytes an instruction, left v1 no
// faster than the kernel it replaces). Tiles inside the window skip the
// masks. A hit outside the window (the reference never clips the hits to
// it) is listed apart and gets its k clipped adds from the env's block
// after the window's tiles; its cell is no window cell, so no other thread
// touches it. In place is safe: each window cell is read once, before its
// one write, by the thread that writes it.
//
// Design. A block takes one env and a group of kTilesPerBlock consecutive tiles
// of kTileH x kTileW cells, in turn; each warp holds a kWarpH x kWarpW strip of
// the tile, each lane four cells of a row of it, in registers across all frames
// (one 16-byte load and store where the rows allow it), and loads the next
// tile's cells while it runs this one: the grid is read once and written once,
// out of place. The block first stages each frame's carve table in shared
// memory with its scalars and the table's maximum (a warp a frame, shuffles)
// and decides whether the frame's camera reaches each strip of the group's
// tiles (a lane a strip, the bits by ballot), so that the carve test's branch
// is the same on every lane of a warp and a warp whose strip the camera misses
// skips it. Every thread lists the frames' hits that fall in the group, with
// their frame, tile and cell. The staging starts all its global loads before
// it uses any, so that the block waits one round trip for them, not one a
// column. Per tile, where the list holds a hit, the block counts them with
// shared-memory atomics (16-bit counters, two frames a word; each thread zeroes
// its cells' after use); then every thread runs its cells through the frames. A
// frame that does not reach a strip skips the carve test there and applies the
// same expression with carve = 0, so that the cells take the bits they took
// before (v + 0 turns -0.0 into +0.0, and the clip moves cells outside the
// bounds) at two or three instructions a cell.
//
// The reach test, per frame and strip, conservative (the plain predicate is
// mapping/fusion.py `tile_reach` on rectangles of WARP_H x WARP_W cells, which
// the tests hold against every cell the carve frees). A cell can carve only if
// dcx > 1e-6, its image column lies in [0, Wcam - 1], and r_cell <
// fsub(r_carve, res) <= fsub(max of the table, res) = T. On the rectangle of
// the strip's cell centres (linear functions take their extremes at its
// corners) a frame cannot reach the strip if T <= 0; or the rectangle's nearest
// point lies farther than T from the camera; or all four corners lie behind the
// camera (dcx <= 1e-6); or all four lie outside the same one of the two half-
// planes fx dcy <= (half_w + 0.5) dcx and fx dcy > -(Wcam - 0.5 - half_w) dcx
// that bound the image columns. Each test keeps a margin of kReachRel of the
// coordinates' scale L (1 + |x0| + |y0| + |cam| + the strip's far row and
// column in metres; of T too for the distance), far above the roundoff of the
// cells' own arithmetic, as B4's cull does. Inside a reached strip each cell
// tests dcx > 1e-6, then r_cell > 0 and r_cell < T, before the IEEE divide:
// both are the kernel's own rounded values and fsub_rn is monotone, so these
// early-outs need no margin, and only cells that can carve divide.
//
// The tile: 32 x 32 cells (3.2 m at 0.1 m), the cull's unit a warp's 8 x
// 16 strip of it. On examples/profile_vision.py's map (256 x 192 at 0.1 m,
// a 6 m camera of 86 degrees) a frame's wedge touches some 15-20% of 32 x
// 32 tiles (chip_smoke.py prints the share), and fewer of the strips; a
// tile's fixed work (its counters, a barrier where it holds hits) and a
// group's staging (8 B a column and frame, 6.4 KB at F = 5, from L2) are
// paid once for 1024 cells and eight tiles. A block a tile (the first form
// of this kernel) waited on its staging's round trips at every tile, and
// took nearly as long with its carve switched off. Registers are capped
// for five resident blocks an SM: at six, v2's kernel spilled and slowed;
// at four, fewer warps were left to cover the loads.
//
// Arithmetic: the parent kernels' round-to-nearest intrinsics in their
// order, so that no FMA contraction moves a cell and the kernels agree with
// the plain versions and with the earlier kernels bit for bit.
//
// Bound on the H100: device memory (2 x 4 B a cell, read and written once)
// where the cull leaves the carve to the strips that the camera reaches;
// without it, the carve test's ~40 instructions a cell and
// frame (a divide and a square root among them) bound the kernel.
//
// Limits: the shared memory, fuse_tile_smem_bytes(F, Wcam) <= 227 KB (F <=
// 68 frames at Wcam = 160; v2 Wcam <= 28,532), opted into past 48 KB; H * W
// below 2^31 cells; n_envs x groups below 2^31 blocks. Any H and W (the
// last tiles masked; scalar loads where W % 4 != 0 or a pointer is not
// 16-byte aligned). A hit index outside its env's grid is ignored. v1: a
// window of at most kWindowMax x kWindowMax cells inside the grid (org must
// place it there, as fusion.py's _window_inputs does) and
// fuse_window_smem_bytes(Wcam) <= 227 KB (Wcam <= 28,523).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kTileCells = kTileW * kTileH;
constexpr int kFuseBlock = 256;
constexpr int kFuseWarps = kFuseBlock / 32;
constexpr int kCellsPerThread = kTileCells / kFuseBlock;
constexpr int kWarpW = 16;  // a warp's strip of the tile, the cull's unit
constexpr int kWarpH = 8;
constexpr int kWarpsX = kTileW / kWarpW;
constexpr int kTilesPerBlock = 8;  // a block's tiles, in turn
constexpr int kFuseMinBlocks = 5;  // resident blocks an SM (<= 51 registers)
constexpr int kTabLoads = 8;       // a lane's table loads in flight
constexpr int kHitLoads = 4;       // a thread's hit loads in flight
constexpr int kFrameWords = 7;     // a frame's record in shared memory
constexpr size_t kFuseSmemMax = 232448;  // a block's shared memory, 227 KB
constexpr float kReachRel = 1e-4f;
constexpr int kWindowMax = 128;    // v1's window side, cells
constexpr int kWindowTiles = (kWindowMax / kTileH) * (kWindowMax / kTileW);
static_assert(kCellsPerThread == 4, "one float4 a thread");
static_assert(kWarpW * kWarpH == 32 * kCellsPerThread, "a lane a segment");
static_assert(kWarpsX * (kTileH / kWarpH) == kFuseWarps, "a warp a strip");

struct FuseParams {
  float fx, res, half_w, l_hit, l_miss, l_min, l_max;
};

// A frame's record: the scalars and T = fsub(max table, res).
struct FrameRec {
  float x0, y0, cx, cy, cp, sp, t_max;
};
static_assert(sizeof(FrameRec) == kFrameWords * 4, "layout");

// dynamic shared memory of a block: the packed hit counters (two frames a
// 32-bit word a cell), F tables, the group's hits (at most F * Wcam), F
// records, the reach flags of the group's tiles, their hit counts and the
// list's length
inline size_t fuse_tile_smem_bytes(int F, int Wcam) {
  return 4 * (static_cast<size_t>((F + 1) / 2) * kTileCells +
              2 * static_cast<size_t>(F) * Wcam +
              static_cast<size_t>(F) * (kFrameWords + kTilesPerBlock) +
              kTilesPerBlock + 1);
}

// v1's block: as fuse_tile_smem_bytes(1, Wcam) with kWindowTiles tiles and
// a second list length (the hits outside the window)
inline size_t fuse_window_smem_bytes(int Wcam) {
  return 4 * (static_cast<size_t>(kTileCells) + 2 * static_cast<size_t>(Wcam) +
              (kFrameWords + kWindowTiles) + kWindowTiles + 2);
}

__device__ __forceinline__ float clip(float v, const FuseParams& P) {
  return fminf(fmaxf(v, P.l_min), P.l_max);
}

// Whether frame (x0, y0, cx, cy, cp, sp) with T = t_max may carve a cell
// whose centre lies in columns c_lo..c_hi, rows r_lo..r_hi (see the header;
// fusion.py tile_reach is the same rule).
__device__ bool tile_reached(float x0, float y0, float cx, float cy, float cp,
                             float sp, float t_max, int c_lo, int c_hi,
                             int r_lo, int r_hi, int Wcam,
                             const FuseParams& P) {
  if (!(t_max > 0.0f)) return false;
  const float xa = __fadd_rn(x0, __fmul_rn(static_cast<float>(c_lo), P.res));
  const float xb = __fadd_rn(x0, __fmul_rn(static_cast<float>(c_hi), P.res));
  const float ya = __fadd_rn(y0, __fmul_rn(static_cast<float>(r_lo), P.res));
  const float yb = __fadd_rn(y0, __fmul_rn(static_cast<float>(r_hi), P.res));
  const float L = __fadd_rn(
      __fadd_rn(__fadd_rn(1.0f, fabsf(x0)), __fadd_rn(fabsf(y0), fabsf(cx))),
      __fadd_rn(fabsf(cy),
                __fmul_rn(static_cast<float>(c_hi + r_hi), fabsf(P.res))));
  const float m = __fmul_rn(kReachRel, L);
  // nearest point of the rectangle
  const float ddx = fmaxf(fmaxf(__fsub_rn(fminf(xa, xb), cx),
                                __fsub_rn(cx, fmaxf(xa, xb))), 0.0f);
  const float ddy = fmaxf(fmaxf(__fsub_rn(fminf(ya, yb), cy),
                                __fsub_rn(cy, fmaxf(ya, yb))), 0.0f);
  const float r_far = __fadd_rn(__fadd_rn(t_max, m),
                                __fmul_rn(kReachRel, t_max));
  if (__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) >
      __fmul_rn(r_far, r_far))
    return false;
  // the corners against the camera's half-planes
  const float mc = __fmul_rn(m, __fadd_rn(fabsf(cp), fabsf(sp)));
  const float A = __fadd_rn(P.half_w, 0.5f);
  const float Bq = __fsub_rn(__fsub_rn(static_cast<float>(Wcam), 0.5f),
                             P.half_w);
  const float mA = __fmul_rn(mc, __fadd_rn(fabsf(P.fx), fabsf(A)));
  const float mB = __fmul_rn(mc, __fadd_rn(fabsf(P.fx), fabsf(Bq)));
  bool behind = true, left = true, right = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = __fsub_rn((i & 1) ? xb : xa, cx);
    const float dy = __fsub_rn((i & 2) ? yb : ya, cy);
    const float dcx = __fadd_rn(__fmul_rn(cp, dx), __fmul_rn(sp, dy));
    const float dcy = __fadd_rn(__fmul_rn(-sp, dx), __fmul_rn(cp, dy));
    const float fy = __fmul_rn(P.fx, dcy);
    behind = behind && dcx <= __fsub_rn(1e-6f, mc);
    left = left && __fsub_rn(fy, __fmul_rn(A, dcx)) > mA;
    right = right && __fadd_rn(fy, __fmul_rn(Bq, dcx)) < -mB;
  }
  return !(behind || left || right);
}

__device__ __forceinline__ void load_cells(const float* __restrict__ lo,
                                           long long at, bool in_rows,
                                           int cols_left, bool vec,
                                           float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (!in_rows) return;
  if (vec) {
    if (cols_left > 0) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(lo + at));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cols_left) v[j] = __ldg(lo + at + j);
  }
}

__device__ __forceinline__ void store_cells(float* __restrict__ out,
                                            long long at, bool in_rows,
                                            int cols_left, bool vec,
                                            const float (&v)[4]) {
  if (!in_rows) return;
  if (vec) {
    if (cols_left > 0)
      *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cols_left) out[at + j] = v[j];
  }
}

// v1: a lane's four cells down a column of the window, two rows apart, at
// p + j * step (step = 2 rows); unmasked where the tile lies inside the
// window (full), else the rows left from p's on and whether p's column is.
__device__ __forceinline__ void load_column(const float* __restrict__ p,
                                            int step, bool full,
                                            int rows_left, bool col_in,
                                            float (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = full || (col_in && 2 * j < rows_left) ? __ldg(p + j * step) : 0.0f;
}

__device__ __forceinline__ void store_column(float* __restrict__ p, int step,
                                             bool full, int rows_left,
                                             bool col_in,
                                             const float (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (full || (col_in && 2 * j < rows_left)) p[j * step] = v[j];
}

// One block per (env, group of kTiles consecutive tiles in row-major tile
// order): blockIdx.x = env * groups + group, tiles_x tiles a row of the
// (H, W) region. v2, v3: the region is the grid, lo/out (B, H, W); v1
// (kWindow): the (H, W) = (ch, cw) window at org (B, 2) int32 [r0, c0] of
// each env's (grid_h, grid_w) grid, one group, lo = out (in place). tabs
// (B, F, Wcam) carve range per image column; sc (B, F, 8) [x of the
// region's column 0's centre, y of its row 0's centre, cam x, cam y,
// cos(yaw), sin(yaw), 0, 0]; hit (B, F, Wcam): v3 the cell row * W + col in
// the env's grid (int32), v2 and v1 env * (grid cells) + row * grid width +
// col (int64); negative for none.
template <bool kOneClip, typename Hit, bool kWindow>
__global__ void __launch_bounds__(kFuseBlock, kFuseMinBlocks)
    fuse_tile_kernel(const float* __restrict__ lo,
                     const float* __restrict__ tabs,
                     const float* __restrict__ sc,
                     const Hit* __restrict__ hit, const int* __restrict__ org,
                     float* __restrict__ out, int F, int H, int W, int Wcam,
                     int tiles_x, int tiles, int groups, int grid_h,
                     int grid_w, FuseParams P) {
  constexpr int kTiles = kWindow ? kWindowTiles : kTilesPerBlock;
  // a lane's four cells j: along a row of its strip (row 0, column j; one
  // 16-byte load where the rows allow it), or, v1, down a column two rows
  // apart (row 2 j, column 0), so that each scalar load of a warp reads two
  // runs of 16 cells of a window row
  constexpr int kDr = kWindow ? 2 : 0, kDc = kWindow ? 0 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_words = (F + 1) / 2;
  uint32_t* cnt = smem;                                  // [n_words][cells]
  float* tab = reinterpret_cast<float*>(cnt + n_words * kTileCells);
  int* list = reinterpret_cast<int*>(tab + F * Wcam);   // the group's hits
  FrameRec* rec = reinterpret_cast<FrameRec*>(list + F * Wcam);  // [F]
  int* reach = reinterpret_cast<int*>(rec + F);  // [kTiles][F] warps
  int* tile_hits = reach + kTiles * F;           // [kTiles]
  int* n_list = tile_hits + kTiles;
  int* n_out = n_list + 1;  // v1: hits outside the window, from list's top

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x / groups;
  const int t0 = (blockIdx.x - e * groups) * kTiles;
  const int n_tiles = min(kTiles, tiles - t0);
  // lane l of warp w: row l / 4 of the warp's 8 x 16 strip, columns
  // 4 (l % 4) .. + 3; v1: rows l / 16 + 0, 2, 4, 6, column l % 16
  const int lr = (warp / kWarpsX) * kWarpH +
                 (kWindow ? lane / kWarpW : lane / (kWarpW / 4));
  const int lc = (warp % kWarpsX) * kWarpW +
                 (kWindow ? lane % kWarpW : 4 * (lane % (kWarpW / 4)));
  // the env's grid, its row stride, and the region's cell (0, 0) in it
  const int ld = kWindow ? grid_w : W;
  const long long grid0 =
      e * (kWindow ? static_cast<long long>(grid_h) * grid_w
                   : static_cast<long long>(H) * W);
  const int r0 = kWindow ? __ldg(org + 2 * e) : 0;
  const int c0 = kWindow ? __ldg(org + 2 * e + 1) : 0;
  const long long env0 = grid0 + static_cast<long long>(r0) * ld + c0;
  const bool vec = (W & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(lo) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // v1: this lane's first cell in the window, and two rows' step
  const long long at0 = env0 + static_cast<long long>(lr) * ld + lc;
  const int step = 2 * ld;

  // the first tile's cells (their latency hides behind the staging below);
  // tile (tr, tc) of the region (v1 counts on, rather than divides per tile)
  int tr = t0 / tiles_x, tc = t0 - tr * tiles_x;
  int r = tr * kTileH + lr, c = tc * kTileW + lc;
  float v[4];
  if (kWindow)
    load_column(lo + at0 + tr * kTileH * ld + tc * kTileW, step,
                (tr + 1) * kTileH <= H && (tc + 1) * kTileW <= W, H - r, c < W,
                v);
  else
    load_cells(lo, env0 + static_cast<long long>(r) * ld + c, r < H, W - c,
               vec, v);
  for (int i = tid; i < n_words * kTileCells; i += kFuseBlock) cnt[i] = 0u;
  if (tid < kTiles) tile_hits[tid] = 0;
  if (tid == 0) *n_list = 0;
  if (kWindow && tid == 0) *n_out = 0;
  __syncthreads();  // every counter is zero before any hit lands

  // each frame's table, scalars and T, and whether it reaches each tile of
  // the group (lane g tests tile g), a warp a frame
  for (int f = warp; f < F; f += kFuseWarps) {
    const long long fr = static_cast<long long>(e) * F + f;
    const float* s = sc + fr * 8;
    const float x0 = s[0], y0 = s[1], cx = s[2], cy = s[3], cp = s[4],
                sp = s[5];
    float mx = -INFINITY;
    for (int i0 = 0; i0 < Wcam; i0 += 32 * kTabLoads) {
      float x[kTabLoads];
#pragma unroll
      for (int u = 0; u < kTabLoads; ++u) {
        const int i = i0 + 32 * u + lane;
        x[u] = i < Wcam ? __ldg(tabs + fr * Wcam + i) : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kTabLoads; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < Wcam) tab[f * Wcam + i] = x[u];
        mx = fmaxf(mx, x[u]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float t_max = __fsub_rn(mx, P.res);
    // lane l tests strip l % 8 of tile l / 8 (of four), bits by ballot
    for (int i0 = 0; i0 < n_tiles * kFuseWarps; i0 += 32) {
      const int g = (i0 + lane) / kFuseWarps, w = lane % kFuseWarps;
      const int t = t0 + g;
      const int ra = (t / tiles_x) * kTileH + (w / kWarpsX) * kWarpH;
      const int ca = (t % tiles_x) * kTileW + (w % kWarpsX) * kWarpW;
      const bool sees =
          g < n_tiles && ra < H && ca < W &&
          tile_reached(x0, y0, cx, cy, cp, sp, t_max, ca,
                       min(ca + kWarpW, W) - 1, ra, min(ra + kWarpH, H) - 1,
                       Wcam, P);
      const unsigned bits = __ballot_sync(0xffffffffu, sees);
      if (lane % kFuseWarps == 0 && g < n_tiles)
        reach[g * F + f] = (bits >> lane) & 0xffu;
    }
    if (lane == 0) rec[f] = FrameRec{x0, y0, cx, cy, cp, sp, t_max};
  }
  // the hits that fall in the group's tiles, listed with their frame, tile
  // and cell, whatever the reach test says; v1's outside its window listed
  // apart, from the list's top
  const long long base = sizeof(Hit) == 8 ? grid0 : 0;  // v2's are global
  const long long h_lo =
      kWindow ? 0 : static_cast<long long>(t0 / tiles_x) * kTileH * W;
  const long long h_hi =
      kWindow ? static_cast<long long>(grid_h) * grid_w
              : static_cast<long long>(
                    min(((t0 + n_tiles - 1) / tiles_x + 1) * kTileH, H)) * W;
  const Hit* he = hit + static_cast<long long>(e) * F * Wcam;
  for (int i0 = 0; i0 < F * Wcam; i0 += kFuseBlock * kHitLoads) {
    long long h[kHitLoads];
#pragma unroll
    for (int u = 0; u < kHitLoads; ++u) {
      const int i = i0 + kFuseBlock * u + tid;
      h[u] = i < F * Wcam ? static_cast<long long>(__ldg(he + i)) - base : -1;
    }
#pragma unroll
    for (int u = 0; u < kHitLoads; ++u) {
      if (h[u] < h_lo || h[u] >= h_hi) continue;
      const int hh = static_cast<int>(h[u]);
      int hr = hh / ld, hc = hh - hr * ld;
      if (kWindow) {
        hr -= r0, hc -= c0;
        if (hr < 0 || hr >= H || hc < 0 || hc >= W) {
          list[F * Wcam - 1 - atomicAdd(n_out, 1)] = hh;
          continue;
        }
      }
      const int g = (hr / kTileH) * tiles_x + hc / kTileW - t0;
      if (g < 0 || g >= n_tiles) continue;
      const int f = (i0 + kFuseBlock * u + tid) / Wcam;
      list[atomicAdd(n_list, 1)] =
          (f * kTiles + g) * kTileCells + (hr % kTileH) * kTileW +
          hc % kTileW;
      atomicAdd(&tile_hits[g], 1);
    }
  }
  __syncthreads();

  const float u_max = static_cast<float>(Wcam - 1);
  const int cell = lr * kTileW + lc;
  for (int g = 0; g < n_tiles; ++g) {
    // the next tile's cells, loaded while this one runs
    const int tn = t0 + g + 1;
    const int trn = kWindow ? (tc + 1 < tiles_x ? tr : tr + 1) : tn / tiles_x;
    const int tcn = kWindow ? (tc + 1 < tiles_x ? tc + 1 : 0) : tn % tiles_x;
    const int rn = trn * kTileH + lr, cn = tcn * kTileW + lc;
    float nv[4];
    if (kWindow)
      load_column(lo + at0 + trn * kTileH * ld + tcn * kTileW, step,
                  g + 1 < n_tiles && (trn + 1) * kTileH <= H &&
                      (tcn + 1) * kTileW <= W,
                  g + 1 < n_tiles ? H - rn : 0, cn < W, nv);
    else
      load_cells(lo, env0 + static_cast<long long>(rn) * ld + cn,
                 g + 1 < n_tiles && rn < H, W - cn, vec, nv);
    const bool hits = tile_hits[g] > 0;  // the same in every thread
    if (hits) {
      for (int i = tid; i < *n_list; i += kFuseBlock) {
        const int x = list[i];
        const int fg = x / kTileCells;
        if (fg % kTiles != g) continue;
        const int f = fg / kTiles;
        atomicAdd(&cnt[(f >> 1) * kTileCells + x % kTileCells],
                  1u << (16 * (f & 1)));
      }
      __syncthreads();
    }
    float xr[4], yr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xr[j] = __fmul_rn(static_cast<float>(c + kDc * j), P.res);
      yr[j] = __fmul_rn(static_cast<float>(r + kDr * j), P.res);
    }
    // the frames in order
    for (int f = 0; f < F; ++f) {
      uint32_t k[4] = {0u, 0u, 0u, 0u};
      if (hits) {
        const uint32_t* cf = cnt + (f >> 1) * kTileCells + cell;
        const int sh = 16 * (f & 1);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          k[j] = (cf[(kDr * kTileW + kDc) * j] >> sh) & 0xffffu;
      }
      bool carve[4] = {false, false, false, false};
      if ((reach[g * F + f] >> warp) & 1) {
        const FrameRec q = rec[f];
        const float dy0 = __fsub_rn(__fadd_rn(q.y0, yr[0]), q.cy);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dx = __fsub_rn(__fadd_rn(q.x0, xr[j]), q.cx);
          const float dy =
              kDr == 0 ? dy0 : __fsub_rn(__fadd_rn(q.y0, yr[j]), q.cy);
          const float dcx = __fadd_rn(__fmul_rn(q.cp, dx),
                                      __fmul_rn(q.sp, dy));
          if (!(dcx > 1e-6f)) continue;
          const float r_cell = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                    __fmul_rn(dy, dy)));
          if (!(r_cell > 0.0f && r_cell < q.t_max)) continue;
          const float dcy = __fadd_rn(__fmul_rn(-q.sp, dx),
                                      __fmul_rn(q.cp, dy));
          const float u = __fsub_rn(
              P.half_w, __fdiv_rn(__fmul_rn(P.fx, dcy), fmaxf(dcx, 1e-6f)));
          const float uf = kWindow ? rintf(u) : floorf(__fadd_rn(u, 0.5f));
          if (uf >= 0.0f && uf <= u_max)
            carve[j] = r_cell < __fsub_rn(
                                    tab[f * Wcam + static_cast<int>(uf)],
                                    P.res);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kOneClip) {
          v[j] = clip(__fadd_rn(__fadd_rn(v[j], carve[j] ? P.l_miss : 0.0f),
                                __fmul_rn(static_cast<float>(k[j]), P.l_hit)),
                      P);
        } else {
          v[j] = clip(carve[j] ? __fadd_rn(v[j], P.l_miss) : v[j], P);
          for (uint32_t n = 0; n < k[j]; ++n)
            v[j] = clip(__fadd_rn(v[j], P.l_hit), P);
        }
      }
    }
    if (hits) {  // each thread zeroes its own cells' counters
      for (int w = 0; w < n_words; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cnt[w * kTileCells + cell + (kDr * kTileW + kDc) * j] = 0u;
      __syncthreads();  // before the next tile's hits land
    }
    if (kWindow)
      store_column(out + at0 + tr * kTileH * ld + tc * kTileW, step,
                   (tr + 1) * kTileH <= H && (tc + 1) * kTileW <= W, H - r,
                   c < W, v);
    else
      store_cells(out, env0 + static_cast<long long>(r) * ld + c, r < H,
                  W - c, vec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = nv[j];
    tr = trn, tc = tcn, r = rn, c = cn;
  }
  if (kWindow) {
    // the hits outside the window: the first of equal entries adds all k
    const int n = *n_out;
    const int* top = list + F * Wcam - 1;  // entry i at top[-i]
    for (int i = tid; i < n; i += kFuseBlock) {
      const int x = top[-i];
      bool first = true;
      int k = 0;
      for (int j = 0; j < n; ++j) {
        if (top[-j] != x) continue;
        first = first && j >= i;
        ++k;
      }
      if (!first) continue;
      float y = out[grid0 + x];
      for (int m = 0; m < k; ++m) y = clip(__fadd_rn(y, P.l_hit), P);
      out[grid0 + x] = y;
    }
  }
}

// Launch fuse_tile_kernel<kOneClip, Hit, false> (v2, v3) on stream st;
// returns the launch's error, cudaErrorInvalidValue past the limits.
template <bool kOneClip, typename Hit>
cudaError_t launch_fuse_tile(const float* lo, const float* tabs,
                             const float* sc, const Hit* hit, float* out,
                             int n_envs, int F, int H, int W, int Wcam,
                             const FuseParams& P, cudaStream_t st) {
  if (n_envs <= 0 || H <= 0 || W <= 0) return cudaSuccess;
  if (F < 0 || Wcam < 1 || static_cast<long long>(H) * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;  // F = 0: a copy
  const size_t smem = fuse_tile_smem_bytes(F, Wcam);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((H + kTileH - 1) / kTileH);
  const int groups = (tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  if (smem > kFuseSmemMax ||
      static_cast<long long>(groups) * n_envs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // all of it dynamic: opted into past the default 48 KB
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fuse_tile_kernel<kOneClip, Hit, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fuse_tile_kernel<kOneClip, Hit, false>
      <<<static_cast<unsigned>(groups * n_envs), kFuseBlock, smem, st>>>(
          lo, tabs, sc, hit, nullptr, out, F, H, W, Wcam, tiles_x, tiles,
          groups, H, W, P);
  return cudaGetLastError();
}

// Launch v1, fuse_tile_kernel<false, int64, true>, in place on grid (B, H,
// W) over the (ch, cw) windows at org, one block per env, on stream st;
// returns the launch's error, cudaErrorInvalidValue past the limits.
inline cudaError_t launch_fuse_window(float* grid, const float* tabs,
                                      const float* sc, const long long* hit,
                                      const int* org, int n_envs, int H,
                                      int W, int ch, int cw, int Wcam,
                                      const FuseParams& P, cudaStream_t st) {
  if (n_envs <= 0) return cudaSuccess;
  const size_t smem = fuse_window_smem_bytes(Wcam);
  if (ch < 1 || cw < 1 || ch > kWindowMax || cw > kWindowMax || ch > H ||
      cw > W || Wcam < 1 || smem > kFuseSmemMax ||
      static_cast<long long>(H) * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fuse_tile_kernel<false, long long, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = (cw + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((ch + kTileH - 1) / kTileH);  // one group
  fuse_tile_kernel<false, long long, true>
      <<<static_cast<unsigned>(n_envs), kFuseBlock, smem, st>>>(
          grid, tabs, sc, hit, org, grid, 1, ch, cw, Wcam, tiles_x, tiles, 1,
          H, W, P);
  return cudaGetLastError();
}

}  // namespace
