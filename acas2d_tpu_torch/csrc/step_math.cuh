// Shared device math of the fused kernels (float32).
//
// CUDA counterpart of acas2d_tpu/ops/pallas_step.py:48-202; the plain torch
// version is acas2d_tpu_torch/ops/step_math.py.  The counter-based hash RNG
// is bit-identical to the Pallas kernels'; the float math follows their op
// order, with the parameter-dependent constants passed in as float64 values
// rounded to float32 on the host (RolloutConsts), never divided here.
// Uses the IEEE sqrtf and division (no fast-math intrinsics) and the Cephes
// arctan polynomial of the Pallas kernels, not atanf.  The geometry's sines
// come from its Trig parameter: IeeeTrig (sinf/cosf, the policy rollout's)
// or BoundedTrig (one shared reduction a sin/cos pair, for |x| <= 8 only:
// the env-only rollout's).
#pragma once

#include <stdint.h>

namespace acas {

constexpr float kDeg2Rad = (float)(3.14159265358979323846 / 180.0);
constexpr float kRad2Deg = (float)(1.0 / (3.14159265358979323846 / 180.0));
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kInv360 = (float)(1.0 / 360.0);
constexpr float kInv180 = (float)(1.0 / 180.0);

// Field order is ops/step_math.py:CONST_NAMES, then max_steps.
struct RolloutConsts {
  float dt, v, acc, gx, gy, inv_max_steps, bearing;
  float player_x0, player_y0, traffic_x0, traffic_y_top;
  float traffic_y_span, player_lim, traffic_lim, coll_dist;
  float goal_radius, reward_collision, reward_goal, inv_safe;
  float inv_dev_reward, inv_goal_reward, inv_d_dev_max, inv_d_goal_max;
  float inv_d_sep_max, inv_d_cpa_max, inv_v_closing_max, half_log_2pi;
  int max_steps;
};

__device__ __forceinline__ uint32_t triple32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// Uniform in [0, 1): top 24 bits of triple32(base + step*C + salt*C').
__device__ __forceinline__ float u01_hash(uint32_t base, int step,
                                          uint32_t salt) {
  uint32_t x = base + (uint32_t)step * 0x7FEB352Du + salt * 0x85EBCA6Bu;
  return (float)(triple32(x) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float atan_ceph(float x) {
  float ax = fabsf(x);
  bool big = ax > 2.414213562373095f;   // tan(3*pi/8)
  bool mid = ax > 0.4142135623730950f;  // tan(pi/8)
  // one divide with selected operands: -1 / ax, (ax - 1) / (ax + 1) or
  // ax / 1, bit for bit the reference's select of three (where big, ax
  // exceeds its 1e-30 floor)
  float num = big ? -1.0f : (mid ? ax - 1.0f : ax);
  float den = big ? ax : (mid ? ax + 1.0f : 1.0f);
  float xr = num / den;
  float off = big ? (float)(3.14159265358979323846 / 2)
                  : (mid ? (float)(3.14159265358979323846 / 4) : 0.0f);
  float z = xr * xr;
  float y = (((8.05374449538e-2f * z - 1.38776856032e-1f) * z
              + 1.99777106478e-1f) * z - 3.33329491539e-1f) * z * xr + xr;
  float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return s * (off + y);
}

__device__ __forceinline__ float atan2_ceph(float y, float x) {
  float safe_x = x == 0.0f ? 1.0f : x;
  float base = atan_ceph(y / safe_x);
  float res = x > 0.0f ? base : (y >= 0.0f ? base + kPi : base - kPi);
  if (x == 0.0f) res = y > 0.0f ? kPi / 2 : (y < 0.0f ? -kPi / 2 : 0.0f);
  return res;
}

__device__ __forceinline__ float mod360(float x) {
  return x - 360.0f * floorf(x * kInv360);
}

// x - 2pi * floor(x / 2pi) for x = atan2_ceph(..), which lies in
// [-pi, pi]: there the floor is -1 from x <= -0x1p-147 down, and 0 above
// (a quotient of a smaller negative denormal rounds to -0).  The + 0.0f
// turns -0 into +0, as the reference's subtraction does.
__device__ __forceinline__ float mod2pi(float x) {
  return x <= -0x1p-147f ? x + kTwoPi : x + 0.0f;
}

// sinf / cosf (the CUDA Math API's, 2 ulp, any x): the policy rollout's.
struct IeeeTrig {
  static __device__ __forceinline__ float sin(float x) { return sinf(x); }
  static __device__ __forceinline__ void sincos(float x, float* s,
                                                float* c) {
    *s = sinf(x);
    *c = cosf(x);
  }
};

// sin and cos for |x| <= 8 only, within 1 ulp of the correctly rounded
// value there (the CUDA Math API documents 2 for sinf/cosf).  Every angle
// of the env step lies there: headings wrapped to [0, 360) degrees,
// bearings in [0, 2pi], a bearing less an arctan.  One Cody-Waite
// reduction by pi/2 (three float32 parts, fused multiply-adds) serves a
// sin/cos pair; the Cephes polynomials on [-pi/4, pi/4]; the quadrant
// selects and signs.  No slow path for large x, so no local memory.  The
// CPU tests emulate it bit for bit (tests/test_torch_env_rollout_redesign.py).
struct BoundedTrig {
  static __device__ __forceinline__ void sincos(float x, float* s,
                                                float* c) {
    // 1.5 * 2^23 + round(x * 2/pi): the quadrant in the low bits
    const float t = fmaf(x, 0x1.45f306p-1f, 12582912.0f);
    const int q = __float_as_int(t);
    const float j = t - 12582912.0f;
    float r = fmaf(-j, 0x1.921fb6p+0f, x);   // pi/2 = the three parts' sum
    r = fmaf(-j, -0x1.777a5cp-25f, r);
    r = fmaf(-j, -0x1.ee59dap-50f, r);
    const float z = r * r;
    float ps = fmaf(fmaf(-0x1.9943f2p-13f, z, 0x1.11073cp-7f), z,
                    -0x1.555546p-3f) * z;
    ps = fmaf(ps, r, r);
    const float pc = fmaf(fmaf(fmaf(fmaf(0x1.99eb9cp-16f, z, -0x1.6c0c34p-10f),
                                    z, 0x1.55554ap-5f), z, -0.5f), z, 1.0f);
    const float sv = (q & 1) ? pc : ps;
    const float cv = (q & 1) ? ps : pc;
    *s = (q & 2) ? -sv : sv;
    *c = ((q + 1) & 2) ? -cv : cv;
  }
  static __device__ __forceinline__ float sin(float x) {
    float s, c;
    sincos(x, &s, &c);
    return s;
  }
};

struct Geom {
  float d_goal, h_goal_rad, d_dev, d_sep, d_cpa, v_closing;
};

// Player/goal/traffic geometry with the reference's bug_compat quirks
// (kinematics.py:47,57,67,74), as pallas_step.py:env_geometry states it.
template <class Trig = IeeeTrig>
__device__ __forceinline__ Geom env_geometry(
    const RolloutConsts& c, float px, float py, float cp, float sp,
    float psi, float tx, float ty, float tv, float tcos, float tsin,
    float a_lat) {
  Geom g;
  float dxg = c.gx - px, dyg = c.gy - py;
  g.d_goal = sqrtf(dxg * dxg + dyg * dyg);
  g.h_goal_rad = mod2pi(atan2_ceph(dyg, dxg));
  g.d_dev = g.d_goal * Trig::sin(g.h_goal_rad);
  float dxt = tx - px, dyt = ty - py;
  g.d_sep = sqrtf(dxt * dxt + dyt * dyt);
  float v12x = c.v * cp - tv * tcos;
  float v12y = c.v * sp - tv * tsin;
  float h_rel = atan_ceph(v12y / (v12x == 0.0f ? 1e-30f : v12x));
  float a_rel = mod2pi(atan2_ceph(dyt, dxt));
  g.d_cpa = g.d_sep * Trig::sin(a_rel - h_rel);
  float psi1l = (psi + (a_lat / c.v) * c.dt) * kDeg2Rad;
  float s1, c1;
  Trig::sincos(psi1l, &s1, &c1);
  float vx1 = c.v * c1 * c.dt;
  float vy1 = c.v * s1 * c.dt;
  float vx2 = tv * tcos * c.dt;
  float vy2 = c.v * tsin * c.dt;  // bug_compat: player speed, not tv
  float dpx = (px + vx1) - (tx + vx2);
  float dpy = (py + vy1) - (ty + tv * tsin * c.dt);
  float nd = sqrtf(dpx * dpx + dpy * dpy);
  g.v_closing = (((vx1 - vx2) * dpx + (vy1 - vy2) * dpy) / nd) / c.dt;
  return g;
}

__device__ __forceinline__ float pow4(float x) {
  float sq = x * x;
  return sq * sq;
}

// step_reward_5 (rewards.py:5-60).
__device__ __forceinline__ float shaped_step_reward(
    const RolloutConsts& c, float psi, float h_goal_deg, const Geom& g) {
  float dh = fabsf(psi - h_goal_deg);
  dh = fminf(dh, 360.0f - dh);
  float r_head = pow4(1.0f - dh * kInv180);
  float r_cpa = fminf(1.0f, pow4(g.d_cpa * c.inv_safe));
  float dev_frac = fabsf(g.d_dev) * c.inv_dev_reward;
  float r_dev = dev_frac > 1.0f ? 0.0f : sqrtf(fmaxf(0.0f, 1.0f - dev_frac));
  float r_goal = fminf(1.0f, pow4(1.0f - g.d_goal * c.inv_goal_reward));
  return r_head * (g.v_closing <= 0.0f ? r_cpa * r_dev : r_goal);
}

// envs/core.py:observe feature order.
__device__ __forceinline__ void build_obs(const RolloutConsts& c, int steps,
                                          float psi, const Geom& g,
                                          float* obs) {
  obs[0] = (float)steps * c.inv_max_steps;
  obs[1] = psi * kInv360;
  obs[2] = g.d_dev * c.inv_d_dev_max;
  obs[3] = g.d_goal * c.inv_d_goal_max;
  obs[4] = (g.h_goal_rad * kRad2Deg) * kInv360;
  obs[5] = g.d_sep * c.inv_d_sep_max;
  obs[6] = g.d_cpa * c.inv_d_cpa_max;
  obs[7] = g.v_closing * c.inv_v_closing_max;
}

}  // namespace acas
