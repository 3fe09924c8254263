// B3 and B10: one tracking segment (all substeps) per env, one thread per
// env.
//
// Replaces neoplanner_tpu/sim/track_pallas.py `_make_track_kernel` (:94),
// launched by `_track_batch` (:241): with_dis=True through `track_segment`
// (:284) is B3 (C entry neo_track_segment), with_dis=False through
// `track_segment_grid` (:322) is B10 (C entry neo_track_segment_grid). Python
// wrappers: sim/track.py `track_segment` and `track_segment_grid`; plain
// version: the substep loop of the same module (sim/env._track_segment's
// scan). B10 runs without the distance query and writes the 10 Hz tick mask
// instead; the wrapper adds the collision term from a nearest ESDF sample at
// the tick positions (the map never feeds back into the dynamics).
//
// Per substep: the cascaded pos/vel controller with the acceleration clamp,
// semi-implicit integration with drag, the rate-limited yaw toward the
// commanded velocity's heading, the differential-flatness attitude (the
// Shepperd candidates picked by the first largest pivot), the goal latch,
// the freeze outside the mission phase, and on every 6th substep the 10 Hz
// weighted metric with the scene SDF at the drone's position. The launch
// takes the segment's first substep i0 and ticks where (t + i0) % 6 == 0,
// so a segment tracked in chunks keeps one segment's metric cadence. The trace
// rows [pos, vel, pos_des, vel_des, acc_des] are written out per substep.
//
// Bound on the H100: device memory. Per env the kernel reads 60 commands
// (1,440 B), the state and the primitive table, writes a 3,600 B trace, and
// does ~150 flops per substep plus (B3) 10 SDF queries; B10 reads no
// primitives and writes a 240 B tick mask instead. The TPU kernel's
// workarounds go: the desired yaw and the angle wrap use atan2f in-kernel
// (Mosaic had no atan2, so the TPU form precomputed it outside), and the
// reached/freeze logic is plain booleans. B3's env primitives sit in the
// thread's slice of shared memory.
#include <string.h>

#include "minco_device.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kMetricEvery = 6;  // 60 Hz commands, 10 Hz metric
constexpr int kStateIn = 22;
constexpr int kStateOut = 18;

struct TrackParams {
  float dt, kp_pos, kp_vel, a_max, drag, yaw_rate_max, g, des_pos_z, v_max,
      safe_dis, reach_thr;
};

// frames.quat_from_accel_yaw for one acceleration and yaw
__device__ __forceinline__ void quat_from_accel_yaw(float ax, float ay,
                                                    float az, float yaw,
                                                    float g, float (&q)[4]) {
  const float tx = ax, ty = ay, tz = az + g;
  const float tn = sqrtf(tx * tx + ty * ty + tz * tz) + 1e-9f;
  const float zbx = tx / tn, zby = ty / tn, zbz = tz / tn;
  const float cy = cosf(yaw), sy = sinf(yaw);
  float ybx = -zbz * sy, yby = zbz * cy, ybz = zbx * sy - zby * cy;
  const float yn = sqrtf(ybx * ybx + yby * yby + ybz * ybz) + 1e-9f;
  ybx /= yn;
  yby /= yn;
  ybz /= yn;
  const float xbx = yby * zbz - ybz * zby;
  const float xby = ybz * zbx - ybx * zbz;
  const float xbz = ybx * zby - yby * zbx;
  // rotation columns are the body axes
  const float m00 = xbx, m01 = ybx, m02 = zbx;
  const float m10 = xby, m11 = yby, m12 = zby;
  const float m20 = xbz, m21 = ybz, m22 = zbz;
  const float tr = m00 + m11 + m22;
  const float piv[4] = {tr, m00 - m11 - m22, -m00 + m11 - m22,
                        -m00 - m11 + m22};
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[best]) best = i;
  float c[4];
  if (best == 0) {
    const float s = sqrtf(fmaxf(1.0f + tr, 1e-12f)) * 0.5f;
    c[0] = s;
    c[1] = (m21 - m12) / (4 * s);
    c[2] = (m02 - m20) / (4 * s);
    c[3] = (m10 - m01) / (4 * s);
  } else if (best == 1) {
    const float s = sqrtf(fmaxf(1.0f + m00 - m11 - m22, 1e-12f)) * 0.5f;
    c[0] = (m21 - m12) / (4 * s);
    c[1] = s;
    c[2] = (m01 + m10) / (4 * s);
    c[3] = (m02 + m20) / (4 * s);
  } else if (best == 2) {
    const float s = sqrtf(fmaxf(1.0f - m00 + m11 - m22, 1e-12f)) * 0.5f;
    c[0] = (m02 - m20) / (4 * s);
    c[1] = (m01 + m10) / (4 * s);
    c[2] = s;
    c[3] = (m12 + m21) / (4 * s);
  } else {
    const float s = sqrtf(fmaxf(1.0f - m00 - m11 + m22, 1e-12f)) * 0.5f;
    c[0] = (m10 - m01) / (4 * s);
    c[1] = (m02 + m20) / (4 * s);
    c[2] = (m12 + m21) / (4 * s);
    c[3] = s;
  }
  const float qn =
      sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + c[3] * c[3]) + 1e-12f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = c[i] / qn;
}

// state in (22): pos3 vel3 yaw quat4 goal2 metric_pos2 metrics3 reached steps
//                active moving
// state out (18): pos3 vel3 yaw quat4 metric_pos2 metrics3 reached steps
// WITH_DIS: prims (B, n_prims, 6) are read and ticks is unused; else prims
// is unused and ticks (B, spr) receives 1 on the substeps that ticked.
template <bool WITH_DIS>
__global__ void __launch_bounds__(kBlock)
    track_segment_kernel(const float* __restrict__ cmds,
                         const float* __restrict__ st_in,
                         const float* __restrict__ prims,
                         float* __restrict__ st_out, float* __restrict__ trace,
                         float* __restrict__ ticks, int n_envs, int n_prims,
                         int spr, int i0, TrackParams P) {
  extern __shared__ float smem[];  // [n_prims * 6][blockDim.x]
  const int tid = threadIdx.x;
  const int e = blockIdx.x * blockDim.x + tid;
  if (e >= n_envs) return;
  const int stride = blockDim.x;
  if (WITH_DIS) {
    const float* src = prims + static_cast<long long>(e) * n_prims * 6;
    for (int i = 0; i < n_prims * 6; ++i) smem[i * stride + tid] = src[i];
  }
  const float* pr = smem + tid;

  const float* st = st_in + static_cast<long long>(e) * kStateIn;
  float px = st[0], py = st[1], pz = st[2];
  float vx = st[3], vy = st[4], vz = st[5];
  float yaw = st[6];
  float q[4] = {st[7], st[8], st[9], st[10]};
  const float gx = st[11], gy = st[12];
  float mpx = st[13], mpy = st[14];
  float m0 = st[15], m1 = st[16], m2 = st[17];
  bool reached = st[18] > 0.5f;
  float steps = st[19];
  const bool active = st[20] > 0.5f;
  const bool moving = st[21] > 0.5f;

  const float* cmd = cmds + static_cast<long long>(e) * spr * 6;
  float* tr = trace + static_cast<long long>(e) * spr * 15;
  for (int t = 0; t < spr; ++t) {
    const float* c = cmd + t * 6;  // [pos_xy, vel_xy, acc_xy]
    const float pdx = c[0], pdy = c[1], vdx = c[2], vdy = c[3];
    const float adx = c[4], ady = c[5];
    const float pdz = P.des_pos_z;
    const float speed = sqrtf(vdx * vdx + vdy * vdy);
    const float yaw_des = speed > 0.05f ? atan2f(vdy, vdx) : yaw;

    if (!(reached || !moving)) {
      float acx = adx + P.kp_pos * (pdx - px) + P.kp_vel * (vdx - vx);
      float acy = ady + P.kp_pos * (pdy - py) + P.kp_vel * (vdy - vy);
      float acz = P.kp_pos * (pdz - pz) + P.kp_vel * (0.0f - vz);
      const float an = sqrtf(acx * acx + acy * acy + acz * acz);
      const float sc = fminf(1.0f, P.a_max / fmaxf(an, 1e-9f));
      acx *= sc;
      acy *= sc;
      acz *= sc;
      vx = vx + (acx - P.drag * vx) * P.dt;
      vy = vy + (acy - P.drag * vy) * P.dt;
      vz = vz + (acz - P.drag * vz) * P.dt;
      px = px + vx * P.dt;
      py = py + vy * P.dt;
      pz = pz + vz * P.dt;
      const float dy = yaw_des - yaw;
      const float lim = P.yaw_rate_max * P.dt;
      yaw = yaw + fminf(fmaxf(atan2f(sinf(dy), cosf(dy)), -lim), lim);
      quat_from_accel_yaw(acx, acy, acz, yaw, P.g, q);
    }
    const float ex = px - gx, ey = py - gy;
    reached = reached || (active && sqrtf(ex * ex + ey * ey) < P.reach_thr);

    const bool tick = ((t + i0) % kMetricEvery == 0) && active && !reached;
    if (tick) {
      const float ddx = px - mpx, ddy = py - mpy;
      const float vviol = fmaxf(vx * vx + vy * vy - P.v_max * P.v_max, 0.0f);
      if (WITH_DIS) {
        const float dis = neo::scene_min_dist<false>(pr, stride, n_prims, px,
                                                     py, nullptr, nullptr);
        const float dviol = fmaxf(P.safe_dis - fmaxf(dis, 0.0f), 0.0f);
        m2 += dviol * dviol * dviol;
      }
      m0 += sqrtf(ddx * ddx + ddy * ddy);
      m1 += vviol * vviol * vviol;
      mpx = px;
      mpy = py;
    }
    if (!WITH_DIS) ticks[static_cast<long long>(e) * spr + t] = tick ? 1.0f : 0.0f;
    if (active && !reached) steps += 1.0f;

    float* row = tr + t * 15;
    row[0] = px;   row[1] = py;   row[2] = pz;
    row[3] = vx;   row[4] = vy;   row[5] = vz;
    row[6] = pdx;  row[7] = pdy;  row[8] = pdz;
    row[9] = vdx;  row[10] = vdy; row[11] = 0.0f;
    row[12] = adx; row[13] = ady; row[14] = 0.0f;
  }
  float* o = st_out + static_cast<long long>(e) * kStateOut;
  o[0] = px;  o[1] = py;  o[2] = pz;
  o[3] = vx;  o[4] = vy;  o[5] = vz;
  o[6] = yaw;
  o[7] = q[0]; o[8] = q[1]; o[9] = q[2]; o[10] = q[3];
  o[11] = mpx; o[12] = mpy;
  o[13] = m0; o[14] = m1; o[15] = m2;
  o[16] = reached ? 1.0f : 0.0f;
  o[17] = steps;
}

}  // namespace

extern "C" int neo_track_segment(const void* cmds, const void* state,
                                 const void* prims, void* state_out,
                                 void* trace, int n_envs, int n_prims,
                                 int spr, int i0, const float* host_params,
                                 void* stream) {
  TrackParams P;
  static_assert(sizeof(TrackParams) == 11 * sizeof(float), "layout");
  memcpy(&P, host_params, sizeof(P));
  const size_t smem = static_cast<size_t>(n_prims) * 6 * kBlock * sizeof(float);
  const dim3 block(kBlock);
  const dim3 grid((n_envs + kBlock - 1) / kBlock);
  track_segment_kernel<true><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cmds), static_cast<const float*>(state),
      static_cast<const float*>(prims), static_cast<float*>(state_out),
      static_cast<float*>(trace), nullptr, n_envs, n_prims, spr, i0, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neo_track_segment_grid(const void* cmds, const void* state,
                                      void* state_out, void* trace,
                                      void* ticks, int n_envs, int spr,
                                      int i0, const float* host_params,
                                      void* stream) {
  TrackParams P;
  memcpy(&P, host_params, sizeof(P));
  const dim3 block(kBlock);
  const dim3 grid((n_envs + kBlock - 1) / kBlock);
  track_segment_kernel<false><<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cmds), static_cast<const float*>(state),
      nullptr, static_cast<float*>(state_out), static_cast<float*>(trace),
      static_cast<float*>(ticks), n_envs, 0, spr, i0, P);
  return static_cast<int>(cudaGetLastError());
}
