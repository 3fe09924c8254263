// B3 and B10: one tracking segment (all substeps) per env, one warp per
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
// commanded velocity's heading, the goal latch, the freeze outside the
// mission phase, and on every 6th substep the 10 Hz weighted metric with
// the scene SDF at the drone's position. The launch takes the segment's
// first substep i0 and ticks where (t + i0) % 6 == 0, so a segment tracked
// in chunks keeps one segment's metric cadence. The trace rows [pos, vel,
// pos_des, vel_des, acc_des] are written out per substep. The
// differential-flatness attitude (the Shepperd candidates picked by the
// first largest pivot) reaches only the output state, so it is computed
// once, from the last moving substep's acceleration and yaw.
//
// Bound on the H100: device memory by bytes (per env 60 commands, 1,440 B,
// in and a 3,600 B trace out), but the substep chain is serial: ~60 x a few
// hundred cycles of dependent square roots, divides and atan2f. Design: one
// warp per env, kWarps envs a block. The warp reads its commands into
// shared memory in coalesced loads, its lanes compute the command-only
// terms (speed, the commanded heading, the metric phase) for all substeps
// in parallel, then every lane runs the chain on the same values (so every
// branch is warp-uniform), lane 0 leaves pos and vel per substep in shared
// memory, and the lanes store the trace rows and ticks coalesced after the
// chain. B3 reads its env's primitive table once into the warp's shared
// memory; at a tick each lane takes a run of it and a warp min gives the
// distance. The TPU kernel's workarounds go: the desired yaw and the angle
// wrap use atan2f in-kernel (Mosaic had no atan2, so the TPU form
// precomputed it outside), and the reached/freeze logic is plain booleans.
#include <string.h>

#include "minco_device.cuh"

namespace {

constexpr int kWarps = 4;        // envs per block, one warp each
constexpr int kBlock = 32 * kWarps;
constexpr int kChunk = 64;       // substeps staged in shared memory at once
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

// A warp's staging area for up to kChunk substeps: the commands, the terms
// that depend on them alone, and what the chain leaves for the trace.
struct Stage {
  float cmd[kChunk * 6];   // [pos_xy, vel_xy, acc_xy] per substep
  float yaw_cmd[kChunk];   // atan2f(vdy, vdx)
  int flags[kChunk];       // bit 0: speed > 0.05; bit 1: a metric substep
  float pv[kChunk * 6];    // pos, vel after each substep
  float tick[kChunk];      // 1 on the substeps that ticked (B10)
};
// sim/track.py _STAGE_BYTES (B3's primitive cap, MAX_PRIMS, counts it)
static_assert(sizeof(Stage) == 3840, "sim/track.py _STAGE_BYTES");

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
  __shared__ Stage stages[kWarps];
  extern __shared__ float tabs[];  // WITH_DIS: [kWarps][n_prims * 6]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= n_envs) return;  // whole warps: nothing below syncs the block
  Stage& S = stages[warp];

  // B3: the env's primitive table, once per warp; lane l takes the run
  // [k0, k0 + nk) of it at the tick-time distance query
  float* tab = tabs + static_cast<long long>(warp) * n_prims * 6;
  const int per_lane = (n_prims + 31) / 32;
  const int k0 = min(lane * per_lane, n_prims);
  const int nk = min(per_lane, n_prims - k0);
  if (WITH_DIS) {
    const float* src = prims + static_cast<long long>(e) * n_prims * 6;
    for (int i = lane; i < n_prims * 6; i += 32) tab[i] = src[i];
  }

  // every lane runs the chain on the same values, so every branch below is
  // taken alike by the whole warp
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
  // the last moving substep's clamped acceleration and yaw: the attitude is
  // a function of them alone, so it is computed once, after the chain
  bool moved = false;
  float qax = 0.0f, qay = 0.0f, qaz = 0.0f, qyaw = 0.0f;
  const float pdz = P.des_pos_z;

  for (int c0 = 0; c0 < spr; c0 += kChunk) {
    const int n = min(kChunk, spr - c0);
    __syncwarp();  // the previous chunk's stores have read the stage
    const float* src = cmds + (static_cast<long long>(e) * spr + c0) * 6;
    for (int i = lane; i < n * 6; i += 32) S.cmd[i] = src[i];
    __syncwarp();
    for (int t = lane; t < n; t += 32) {
      const float vdx = S.cmd[t * 6 + 2], vdy = S.cmd[t * 6 + 3];
      const float speed = sqrtf(vdx * vdx + vdy * vdy);
      S.yaw_cmd[t] = atan2f(vdy, vdx);
      S.flags[t] = (speed > 0.05f ? 1 : 0) |
                   ((c0 + t + i0) % kMetricEvery == 0 ? 2 : 0);
    }
    __syncwarp();

    for (int t = 0; t < n; ++t) {
      const float* c = S.cmd + t * 6;  // [pos_xy, vel_xy, acc_xy]
      const float pdx = c[0], pdy = c[1], vdx = c[2], vdy = c[3];
      const float adx = c[4], ady = c[5];
      const int fl = S.flags[t];
      const float yaw_des = (fl & 1) ? S.yaw_cmd[t] : yaw;

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
        moved = true;
        qax = acx;
        qay = acy;
        qaz = acz;
        qyaw = yaw;
      }
      const float ex = px - gx, ey = py - gy;
      reached = reached || (active && sqrtf(ex * ex + ey * ey) < P.reach_thr);

      const bool tick = (fl & 2) && active && !reached;
      if (tick) {
        const float ddx = px - mpx, ddy = py - mpy;
        const float vviol = fmaxf(vx * vx + vy * vy - P.v_max * P.v_max, 0.0f);
        if (WITH_DIS) {
          // the lanes' runs of the table, then a warp min (exact, in any
          // order: the same minimum as one pass over the table)
          float dis = neo::scene_min_dist<false>(tab + 6 * k0, 1, nk, px, py,
                                                 nullptr, nullptr);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dis = fminf(dis, __shfl_xor_sync(0xffffffffu, dis, o));
          const float dviol = fmaxf(P.safe_dis - fmaxf(dis, 0.0f), 0.0f);
          m2 += dviol * dviol * dviol;
        }
        m0 += sqrtf(ddx * ddx + ddy * ddy);
        m1 += vviol * vviol * vviol;
        mpx = px;
        mpy = py;
      }
      if (active && !reached) steps += 1.0f;
      if (lane == 0) {
        float* r = S.pv + t * 6;
        r[0] = px;  r[1] = py;  r[2] = pz;
        r[3] = vx;  r[4] = vy;  r[5] = vz;
        if (!WITH_DIS) S.tick[t] = tick ? 1.0f : 0.0f;
      }
    }
    __syncwarp();

    // the chunk's trace rows [pos, vel, pos_des, vel_des, acc_des] and
    // ticks, stored coalesced
    float* tr = trace + (static_cast<long long>(e) * spr + c0) * 15;
    for (int i = lane; i < n * 15; i += 32) {
      const int t = i / 15, j = i - t * 15;
      float v;
      if (j < 6) {
        v = S.pv[t * 6 + j];
      } else if (j == 8) {
        v = pdz;
      } else if (j == 11 || j == 14) {
        v = 0.0f;
      } else {  // 6, 7 pos_des; 9, 10 vel_des; 12, 13 acc_des
        v = S.cmd[t * 6 + (j - 6) - (j >= 9) - (j >= 12)];
      }
      tr[i] = v;
    }
    if (!WITH_DIS)
      for (int t = lane; t < n; t += 32)
        ticks[static_cast<long long>(e) * spr + c0 + t] = S.tick[t];
  }
  if (moved) quat_from_accel_yaw(qax, qay, qaz, qyaw, P.g, q);
  if (lane == 0) {
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
  // each warp's primitive table, raised past the default where it and the
  // warps' stages (static) together pass 48 KB
  const size_t smem =
      static_cast<size_t>(n_prims) * 6 * kWarps * sizeof(float);
  if (smem + sizeof(Stage) * kWarps > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_segment_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_envs + kWarps - 1) / kWarps);
  track_segment_kernel<true><<<grid, kBlock, smem,
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
  const dim3 grid((n_envs + kWarps - 1) / kWarps);
  track_segment_kernel<false><<<grid, kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cmds), static_cast<const float*>(state),
      nullptr, static_cast<float*>(state_out), static_cast<float*>(trace),
      static_cast<float*>(ticks), n_envs, 0, spr, i0, P);
  return static_cast<int>(cudaGetLastError());
}
