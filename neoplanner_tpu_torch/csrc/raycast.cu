// B4: z-depth image of each env's scene from its drone pose, one thread per
// pixel, one block per tile of one pose's pixels.
//
// Replaces neoplanner_tpu/sense/raycast_pallas.py `_make_kernel` (:72) with
// `_pack_prims` (:179) and `_base_dirs` (:249), launched by `_trace_batch`
// (:219). Python wrapper: sense/raycast.py `render_depth_auto`; plain
// version: sense/raycast.py `render_depth`.
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
// ~19,200 x 24 x ~30 flops against 76.8 KB written. The TPU kernel's
// workarounds go: no (R8, 128) sublane tiling and no boxes-first sorting
// with dynamic trip counts — every thread of a block walks the same
// primitive table in shared memory, so the branch on the primitive's shape
// is uniform across the block and costs no divergence.
#include <string.h>

#include "minco_device.cuh"

namespace {

constexpr int kBlock = 256;
constexpr float kInf = 1e9f;
constexpr int kPrimFields = 8;  // cx cy cz hx hy hz is_cyl active

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

__global__ void __launch_bounds__(kBlock)
    render_depth_kernel(const float* __restrict__ pos,
                        const float* __restrict__ quat,
                        const float* __restrict__ prims,
                        float* __restrict__ depth, int frames_per_env,
                        int n_prims, int width, int out_rows, int row_stride,
                        CamParams C) {
  extern __shared__ float sp[];  // [n_prims * 8] of this pose's env
  const int e = blockIdx.y;      // pose
  const float* src = prims + static_cast<long long>(e / frames_per_env) *
                                 n_prims * kPrimFields;
  for (int i = threadIdx.x; i < n_prims * kPrimFields; i += blockDim.x)
    sp[i] = src[i];
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= out_rows * width) return;
  const int row = pix / width, col = pix - row * width;

  // body-frame unit ray of this pixel (raycast.ray_dirs_camera)
  const float u = static_cast<float>(col) + 0.5f;
  const float v = static_cast<float>(row_stride / 2 + row * row_stride) + 0.5f;
  const float x_opt = (u - static_cast<float>(width) / 2.0f) / C.fx;
  const float y_opt = (v - C.cam_height / 2.0f) / C.fy;
  const float b[3] = {1.0f, -x_opt, -y_opt};
  const float bn = sqrtf(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  const float db[3] = {b[0] / bn, b[1] / bn, b[2] / bn};
  const float q[4] = {quat[e * 4 + 0], quat[e * 4 + 1], quat[e * 4 + 2],
                      quat[e * 4 + 3]};
  float d[3];
  quat_rotate(q, db, d);
  const float ox = pos[e * 3 + 0], oy = pos[e * 3 + 1], oz = pos[e * 3 + 2];

  const float ix = 1.0f / (fabsf(d[0]) < 1e-9f ? 1e-9f : d[0]);
  const float iy = 1.0f / (fabsf(d[1]) < 1e-9f ? 1e-9f : d[1]);
  const float iz = 1.0f / (fabsf(d[2]) < 1e-9f ? 1e-9f : d[2]);
  const float dz_safe = fabsf(d[2]) < 1e-9f ? 1e-9f : d[2];
  float t = kInf;
  for (int k = 0; k < n_prims; ++k) {
    const float* p = sp + k * kPrimFields;
    if (!(p[7] > 0.5f)) continue;
    const float cx = p[0], cy = p[1], cz = p[2];
    const float hx = p[3], hy = p[4], hz = p[5];
    float tp;
    if (p[6] > 0.5f) {  // capped vertical cylinder (raycast._ray_cylinder)
      const float rox = ox - cx, roy = oy - cy;
      const float a = d[0] * d[0] + d[1] * d[1];
      const float bq = 2.0f * (rox * d[0] + roy * d[1]);
      const float c = rox * rox + roy * roy - hx * hx;
      const float disc = bq * bq - 4.0f * a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float a_safe = a < 1e-12f ? 1e-12f : a;
      const float t_side = (-bq - sq) / (2.0f * a_safe);
      const float z_at = oz + t_side * d[2];
      const bool side_ok =
          disc > 0.0f && t_side > 0.0f && fabsf(z_at - cz) <= hz;
      tp = side_ok ? t_side : kInf;
      const float roz = oz - cz;
#pragma unroll
      for (int s = -1; s <= 1; s += 2) {
        const float tc = (static_cast<float>(s) * hz - roz) / dz_safe;
        const float xc = rox + tc * d[0], yc = roy + tc * d[1];
        if (tc > 0.0f && xc * xc + yc * yc <= hx * hx) tp = fminf(tp, tc);
      }
    } else {  // slab test (raycast._ray_box)
      const float lox = (cx - hx - ox) * ix, hix = (cx + hx - ox) * ix;
      const float loy = (cy - hy - oy) * iy, hiy = (cy + hy - oy) * iy;
      const float loz = (cz - hz - oz) * iz, hiz = (cz + hz - oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)),
                               fminf(loz, hiz));
      const float tmax = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)),
                               fmaxf(loz, hiz));
      tp = (tmax >= fmaxf(tmin, 0.0f) && tmin > 0.0f) ? tmin : kInf;
    }
    t = fminf(t, tp);
  }
  if (d[2] < -1e-6f) t = fminf(t, -oz / d[2]);  // ground plane

  const float xb_in[3] = {1.0f, 0.0f, 0.0f};
  float xb[3];
  quat_rotate(q, xb_in, xb);
  const float z = t * (d[0] * xb[0] + d[1] * xb[1] + d[2] * xb[2]);
  const bool valid = t < kInf && z >= C.min_range && z <= C.max_range;
  depth[static_cast<long long>(e) * out_rows * width + pix] =
      valid ? z : C.max_range;
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
  const size_t smem = static_cast<size_t>(n_prims) * kPrimFields * sizeof(float);
  const dim3 block(kBlock);
  const dim3 grid((out_rows * width + kBlock - 1) / kBlock, n_poses);
  render_depth_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(quat),
      static_cast<const float*>(prims), static_cast<float*>(depth),
      frames_per_env, n_prims, width, out_rows, row_stride, C);
  return static_cast<int>(cudaGetLastError());
}
