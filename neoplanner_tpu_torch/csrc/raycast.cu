// B4: z-depth image of each env's scene from its drone pose, one thread per
// pixel, one block per 2-D tile of one pose's pixels.
//
// Replaces neoplanner_tpu/sense/raycast_pallas.py `_make_kernel` (:72) with
// `_pack_prims` (:179) and `_base_dirs` (:249), launched by `_trace_batch`
// (:219). Python wrapper: sense/raycast.py `render_depth_auto`; plain
// version: sense/raycast.py `render_depth`; the tile cull's plain version:
// sense/raycast.py `tile_cull`.
//
// Each pixel builds its camera ray (the optical-frame pixel ray rotated into
// the body frame, raycast.ray_dirs_camera), rotates it by the env's attitude
// quaternion, takes the nearest hit over the env's live boxes (slab test) and
// capped vertical cylinders (side and both caps) and the ground plane, and
// writes z = t * (ray . body x); a miss or a hit out of [min_range,
// max_range] reads max_range. A row stride s > 1 renders rows s/2, s/2 + s,
// ... of the image at the full vertical field of view (the cheap frames of
// sensor-rate fusion). The launch takes F poses per env: pose p traces env
// p / F's primitives, so the sensor-rate loop renders every env's F
// mid-segment frames in one launch without copying the scene F times.
//
// Bound on the H100: operations. A 160x120 frame against 24 primitives is
// ~19,200 x 24 x ~30 flops against 76.8 KB written. Design: a block takes
// a kTileW x kTileH tile of the output image of up to kPoses poses, one
// thread a pixel. Warp w first culls pose w's env primitives against the
// tile: every ray of the tile is a positive combination of its four corner
// rays, so a primitive that lies wholly outside one face of their cone (or
// behind it) can be hit by no pixel of the tile; a primitive a ray misses
// reads kInf and fminf(t, kInf) = t, so dropping it changes no output bit.
// The test is conservative: exact support functions of the box and the
// cylinder against each face, with a roundoff margin far above the pixel
// tests' own (kCullRel, kCullTangent). The survivors, compacted with a warp
// ballot (boxes from the front, cylinders from the back), go to shared
// memory as two float4s each, holding the terms that do not depend on the
// pixel (a box's slab offsets; a cylinder's offsets, its quadratic's
// constant term and cap numerators), so a pixel's test costs two broadcast
// 16-byte loads. Each thread then builds its pixel's body-frame ray once
// and traces it for every pose of the block, against that pose's survivors
// only, keeping a dense test's arithmetic expression for expression (the
// same divides, square roots and contractions), so the image is the dense
// kernel's bit for bit. Several poses a block spread the cull's
// latency and the block's barrier over more pixels. The TPU kernel's
// workarounds go: no (R8, 128) sublane tiling and no boxes-first sorting
// with dynamic trip counts.
#include <string.h>

#include <algorithm>

#include "minco_device.cuh"

namespace {

constexpr int kTileW = 8;    // columns of a tile (sense/raycast.py TILE_W)
constexpr int kTileH = 32;   // output rows of a tile (TILE_H)
constexpr int kBlock = kTileW * kTileH;
constexpr int kPoses = kBlock / 32;  // poses a block, one culling warp each
constexpr float kInf = 1e9f;
constexpr int kPrimFields = 8;    // cx cy cz hx hy hz is_cyl active
// the cull's roundoff margin: kCullRel of the coordinates' scale L, plus
// for a cylinder kCullTangent L^2 / r (a near-tangent ray's quadratic, whose
// discriminant cancels, errs by ~eps L^2 / r), both far above the errors
constexpr float kCullRel = 1e-4f;      // sense/raycast.py CULL_REL
constexpr float kCullTangent = 1e-5f;  // CULL_TANGENT
constexpr unsigned kFull = 0xffffffffu;
// the survivors' tables a block may hold: an H100 block's 232,448 B less
// 1 KB for the poses' own terms (sense/raycast.py MAX_PRIMS)
constexpr size_t kTableBytes = 232448 - 1024;

// a pose's terms in the block's static shared memory: its quaternion, its
// origin and body x in the world, and its survivors' counts
struct PoseTerms {
  float t[10];
  int nb, nc;
};
constexpr size_t kPoseBytes = sizeof(PoseTerms) * kPoses;
static_assert(kPoseBytes <= 232448 - kTableBytes, "kTableBytes");

struct CamParams {
  float fx, fy, min_range, max_range, cam_height;
};

__device__ __forceinline__ void quat_rotate(const float (&q)[4],
                                            const float (&v)[3],
                                            float (&out)[3]) {
  const float w = q[0], ux = q[1], uy = q[2], uz = q[3];
  const float uvx = uy * v[2] - uz * v[1];
  const float uvy = uz * v[0] - ux * v[2];
  const float uvz = ux * v[1] - uy * v[0];
  const float uuvx = uy * uvz - uz * uvy;
  const float uuvy = uz * uvx - ux * uvz;
  const float uuvz = ux * uvy - uy * uvx;
  out[0] = v[0] + 2.0f * (w * uvx + uuvx);
  out[1] = v[1] + 2.0f * (w * uvy + uuvy);
  out[2] = v[2] + 2.0f * (w * uvz + uuvz);
}

// the optical-frame offsets of a pixel column and of an output row
__device__ __forceinline__ float col_x(int col, int width, const CamParams& C) {
  const float u = static_cast<float>(col) + 0.5f;
  return (u - static_cast<float>(width) / 2.0f) / C.fx;
}

__device__ __forceinline__ float row_y(int row, int row_stride,
                                       const CamParams& C) {
  const float v = static_cast<float>(row_stride / 2 + row * row_stride) + 0.5f;
  return (v - C.cam_height / 2.0f) / C.fy;
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float l1(const float (&a)[3]) {
  return fabsf(a[0]) + fabsf(a[1]) + fabsf(a[2]);
}

// One pose's cull of the tile, by one warp: the inward normals of the
// corner rays' cone (the same on every lane), then one primitive per lane.
// Writes the survivors' float4 pairs to sp (boxes at 0, 1, ..., cylinders
// at n_prims - 1, n_prims - 2, ...) and their counts.
__device__ __forceinline__ void cull_tile(
    const float* __restrict__ src, int n_prims, const float (&q)[4],
    float ox, float oy, float oz, float xa, float xb, float ya, float yb,
    int lane, float4* sp, int* n_box, int* n_cyl) {
  // lane l computes corner ray l % 4 and the face from it to the next
  // corner, then every lane gathers the four of each with shuffles
  const int ci = lane & 3, quad = lane & ~3;
  float a[3], c[3], e2[3], e3[3];
  {
    const float b[3] = {1.0f, -((ci == 1 || ci == 2) ? xb : xa),
                        -(ci >= 2 ? yb : ya)};
    quat_rotate(q, b, a);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c[j] = __shfl_sync(kFull, a[j], quad | ((ci + 1) & 3));
    e2[j] = __shfl_sync(kFull, a[j], quad | ((ci + 2) & 3));
    e3[j] = __shfl_sync(kFull, a[j], quad | ((ci + 3) & 3));
  }
  float face[3];
  {
    float n[3] = {a[1] * c[2] - a[2] * c[1], a[2] * c[0] - a[0] * c[2],
                  a[0] * c[1] - a[1] * c[0]};
    const float s1 = dot3(n, e2), s2 = dot3(n, e3);
    // the side of the face that holds the other two corners; none when
    // they straddle it (a degenerate cone)
    const float sgn = (s1 >= 0.0f && s2 >= 0.0f)   ? 1.0f
                      : (s1 <= 0.0f && s2 <= 0.0f) ? -1.0f
                                                   : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) face[j] = sgn * n[j];
  }
  float D[4][3], N[5][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      D[i][j] = __shfl_sync(kFull, a[j], i);
      N[i][j] = __shfl_sync(kFull, face[j], i);
    }
  {  // in front: the corner rays' sum, where every corner lies on its side
    float f[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) f[j] = D[0][j] + D[1][j] + D[2][j] + D[3][j];
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) ok = ok && dot3(f, D[i]) >= 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) N[4][j] = ok ? f[j] : 0.0f;
  }
  float L1[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) L1[i] = l1(N[i]);
  // a ray within ~1e-6 of vertical takes the cylinder test's a_safe, whose
  // "hit" need not lie on the cylinder: no cylinder cull where the cone may
  // hold the vertical
  bool up = true, down = true;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    up = up && N[i][2] >= -1e-3f * L1[i];
    down = down && -N[i][2] >= -1e-3f * L1[i];
  }
  const bool cyl_ok = !up && !down;

  const unsigned below = (1u << lane) - 1u;
  int nb = 0, nc = 0;
  for (int base = 0; base < n_prims; base += 32) {
    const int k = base + lane;
    bool live = false, is_cyl = false;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f), B = A;
    if (k < n_prims) {
      const float* p = src + k * kPrimFields;
      const float cx = p[0], cy = p[1], cz = p[2];
      const float hx = p[3], hy = p[4], hz = p[5];
      is_cyl = p[6] > 0.5f;
      live = p[7] > 0.5f;
      if (is_cyl) {  // the dense test's pixel-free terms, as written there
        const float rox = ox - cx, roy = oy - cy;
        const float c = rox * rox + roy * roy - hx * hx;
        const float roz = oz - cz;
        A = make_float4(rox, roy, c, hx * hx);
        B = make_float4(static_cast<float>(-1) * hz - roz,
                        static_cast<float>(1) * hz - roz, cz, hz);
      } else {
        A = make_float4(cx - hx - ox, cx + hx - ox, cy - hy - oy,
                        cy + hy - oy);
        B = make_float4(cz - hz - oz, cz + hz - oz, 0.0f, 0.0f);
      }
      if (live && (!is_cyl || cyl_ok)) {
        const float rel[3] = {cx - ox, cy - oy, cz - oz};
        const float ax = fabsf(hx), ay = fabsf(hy), az = fabsf(hz);
        const float L = l1(rel) + fabsf(cx) + fabsf(cy) + fabsf(cz) +
                        fabsf(ox) + fabsf(oy) + fabsf(oz) + ax + ay + az;
        const float m =
            kCullRel * L + (is_cyl ? kCullTangent * L * L / ax : 0.0f);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float sup =
              is_cyl ? ax * sqrtf(N[i][0] * N[i][0] + N[i][1] * N[i][1]) +
                           fabsf(N[i][2]) * az
                     : fabsf(N[i][0]) * ax + fabsf(N[i][1]) * ay +
                           fabsf(N[i][2]) * az;
          // wholly outside this face, by more than the margin: culled
          if (dot3(N[i], rel) + sup < -m * L1[i]) live = false;
        }
      }
    }
    const unsigned mb = __ballot_sync(kFull, live && !is_cyl);
    const unsigned mc = __ballot_sync(kFull, live && is_cyl);
    if (live) {
      const int slot = is_cyl ? n_prims - 1 - (nc + __popc(mc & below))
                              : nb + __popc(mb & below);
      sp[2 * slot] = A;
      sp[2 * slot + 1] = B;
    }
    nb += __popc(mb);
    nc += __popc(mc);
  }
  if (lane == 0) {
    *n_box = nb;
    *n_cyl = nc;
  }
}

// four blocks an SM: 64 registers a thread
__global__ void __launch_bounds__(kBlock, 4)
    render_depth_kernel(const float* __restrict__ pos,
                        const float* __restrict__ quat,
                        const float* __restrict__ prims,
                        float* __restrict__ depth, int n_poses,
                        int frames_per_env, int n_prims, int width,
                        int out_rows, int row_stride, int tiles_x, int tiles,
                        int poses_per_block, CamParams C) {
  // pose p0 + w's survivors at sp + 2 * n_prims * w
  extern __shared__ float4 sp[];
  __shared__ PoseTerms s_pose[kPoses];
  const int tile = blockIdx.x % tiles;
  const int p0 = (blockIdx.x / tiles) * poses_per_block;
  const int np = min(poses_per_block, n_poses - p0);
  const int col0 = (tile % tiles_x) * kTileW, row0 = (tile / tiles_x) * kTileH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp < np) {  // warp w culls pose p0 + w against the tile
    const int e = p0 + warp;
    const float q[4] = {quat[e * 4 + 0], quat[e * 4 + 1], quat[e * 4 + 2],
                        quat[e * 4 + 3]};
    const float ox = pos[e * 3 + 0], oy = pos[e * 3 + 1], oz = pos[e * 3 + 2];
    const int col1 = min(col0 + kTileW, width) - 1;
    const int row1 = min(row0 + kTileH, out_rows) - 1;
    cull_tile(prims + static_cast<long long>(e / frames_per_env) * n_prims *
                          kPrimFields,
              n_prims, q, ox, oy, oz, col_x(col0, width, C),
              col_x(col1, width, C), row_y(row0, row_stride, C),
              row_y(row1, row_stride, C), lane,
              sp + 2 * static_cast<long long>(n_prims) * warp,
              &s_pose[warp].nb, &s_pose[warp].nc);
    if (lane == 0) {
      const float xb_in[3] = {1.0f, 0.0f, 0.0f};
      float xb[3];
      quat_rotate(q, xb_in, xb);
      float* sq = s_pose[warp].t;
      sq[0] = q[0]; sq[1] = q[1]; sq[2] = q[2]; sq[3] = q[3];
      sq[4] = ox;   sq[5] = oy;   sq[6] = oz;
      sq[7] = xb[0]; sq[8] = xb[1]; sq[9] = xb[2];
    }
  }
  __syncthreads();
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int col = col0 + tx, row = row0 + ty;
  if (col >= width || row >= out_rows) return;

  // body-frame unit ray of this pixel (raycast.ray_dirs_camera), the same
  // for every pose of the block
  const float x_opt = col_x(col, width, C);
  const float y_opt = row_y(row, row_stride, C);
  const float b[3] = {1.0f, -x_opt, -y_opt};
  const float bn = sqrtf(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  const float db[3] = {b[0] / bn, b[1] / bn, b[2] / bn};

  for (int w = 0; w < np; ++w) {
    const float* sq = s_pose[w].t;
    const float q[4] = {sq[0], sq[1], sq[2], sq[3]};
    const float oz = sq[6];
    float d[3];
    quat_rotate(q, db, d);

    const float ix = 1.0f / (fabsf(d[0]) < 1e-9f ? 1e-9f : d[0]);
    const float iy = 1.0f / (fabsf(d[1]) < 1e-9f ? 1e-9f : d[1]);
    const float iz = 1.0f / (fabsf(d[2]) < 1e-9f ? 1e-9f : d[2]);
    const float dz_safe = fabsf(d[2]) < 1e-9f ? 1e-9f : d[2];
    const float4* tab = sp + 2 * static_cast<long long>(n_prims) * w;
    float t = kInf;
    const int nb = s_pose[w].nb, nc = s_pose[w].nc;
    for (int k = 0; k < nb; ++k) {  // slab test (raycast._ray_box)
      const float4 A = tab[2 * k], B = tab[2 * k + 1];
      const float lox = A.x * ix, hix = A.y * ix;
      const float loy = A.z * iy, hiy = A.w * iy;
      const float loz = B.x * iz, hiz = B.y * iz;
      const float tmin = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)),
                               fminf(loz, hiz));
      const float tmax = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)),
                               fmaxf(loz, hiz));
      const float tp =
          (tmax >= fmaxf(tmin, 0.0f) && tmin > 0.0f) ? tmin : kInf;
      t = fminf(t, tp);
    }
    if (nc > 0) {  // capped vertical cylinders (raycast._ray_cylinder)
      const float a = d[0] * d[0] + d[1] * d[1];
      const float a_safe = a < 1e-12f ? 1e-12f : a;
      for (int k = n_prims - 1; k >= n_prims - nc; --k) {
        const float4 A = tab[2 * k], B = tab[2 * k + 1];
        const float rox = A.x, roy = A.y, c = A.z, hx2 = A.w;
        const float cz = B.z, hz = B.w;
        const float bq = 2.0f * (rox * d[0] + roy * d[1]);
        const float disc = bq * bq - 4.0f * a * c;
        const float sq_ = sqrtf(fmaxf(disc, 0.0f));
        const float t_side = (-bq - sq_) / (2.0f * a_safe);
        const float z_at = oz + t_side * d[2];
        const bool side_ok =
            disc > 0.0f && t_side > 0.0f && fabsf(z_at - cz) <= hz;
        float tp = side_ok ? t_side : kInf;
        const float num[2] = {B.x, B.y};  // s * hz - roz, s = -1, 1
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float tc = num[s] / dz_safe;
          const float xc = rox + tc * d[0], yc = roy + tc * d[1];
          if (tc > 0.0f && xc * xc + yc * yc <= hx2) tp = fminf(tp, tc);
        }
        t = fminf(t, tp);
      }
    }
    if (d[2] < -1e-6f) t = fminf(t, -oz / d[2]);  // ground plane

    const float z = t * (d[0] * sq[7] + d[1] * sq[8] + d[2] * sq[9]);
    const bool valid = t < kInf && z >= C.min_range && z <= C.max_range;
    depth[(static_cast<long long>(p0 + w) * out_rows + row) * width + col] =
        valid ? z : C.max_range;
  }
}

}  // namespace

// pos (n_poses, 3), quat (n_poses, 4): pose p = env p / frames_per_env's
// frame p % frames_per_env; prims (n_poses / frames_per_env, n_prims, 8);
// depth (n_poses, out_rows, width)
extern "C" int neo_render_depth(const void* pos, const void* quat,
                                const void* prims, void* depth, int n_poses,
                                int frames_per_env, int n_prims, int width,
                                int out_rows, int row_stride,
                                const float* host_params, void* stream) {
  CamParams C;
  static_assert(sizeof(CamParams) == 5 * sizeof(float), "layout");
  memcpy(&C, host_params, sizeof(C));
  // kPoses poses a block where their survivors' tables fit a block's
  // shared memory, fewer for large tables
  const size_t table = static_cast<size_t>(n_prims) * 2 * sizeof(float4);
  const int per_block = static_cast<int>(
      table == 0 ? kPoses
                 : std::max<size_t>(1, std::min<size_t>(
                                           kPoses, kTableBytes / table)));
  const size_t smem = table * per_block;
  // raised past the default where the tables and the poses' own terms
  // (static) together pass 48 KB
  if (smem + kPoseBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((out_rows + kTileH - 1) / kTileH);
  const dim3 grid(static_cast<unsigned>((n_poses + per_block - 1) /
                                        per_block) * tiles);
  render_depth_kernel<<<grid, kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(quat),
      static_cast<const float*>(prims), static_cast<float*>(depth), n_poses,
      frames_per_env, n_prims, width, out_rows, row_stride, tiles_x, tiles,
      per_block, C);
  return static_cast<int>(cudaGetLastError());
}
