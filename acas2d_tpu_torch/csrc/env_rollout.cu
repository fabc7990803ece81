// Fused env-only rollout: T autoreset steps of the ACAS-2D environment under
// in-kernel random (or forced-zero) actions, in one launch.
//
// Replaces the TPU kernel acas2d_tpu/ops/pallas_step.py:205
// (fused_rollout_kernel), reached through fused_rollout :350: the env-steps/s
// headline of bench.py.
// Plain version: acas2d_tpu_torch/ops/env_rollout.py:_env_rollout_plain.
//
// What it computes, per env and step (the Pallas kernel's semantics): a
// uniform action on hash salt 0 (or 0), integration of the player and the
// straight-flying traffic (direction cosines cached per episode), the
// geometry with the bug_compat quirks, the shaped reward with its time
// discount and terminal bonuses, termination timeout > collision > goal, a
// masked respawn on salts 1-3 with the step counter reset to 1, and, with
// WITH_OBS, the eight observation features of the post-respawn state added
// one at a time to a carried checksum.  Per env it writes the final state
// and five sums: reward, episodes ended, goals, collisions, obs checksum.
// The RNG streams equal the TPU kernel's: env e is lane e % 1024 of program
// e / 1024, and the step counter is the loop index 0 .. T-1.
//
// What bounds it on an H100: the state is read and written once per launch
// (9 arrays in, 14 out: 92 bytes per env), while every step runs ~20 square
// roots, sines and divides and ~200 other float32 operations, so the work
// is operations, and the card's time goes to issuing their instructions
// (no products, no tiles: shared memory and tensor cores have no role).
// Design: one thread per env, the state in registers, a loop over the T
// steps.  The instructions a step issues are cut where the arithmetic
// allows: the respawn runs only where an episode ended; the observation
// of a lane whose episode went on is the state the reward's geometry just
// measured, so only a respawned lane computes a second geometry (the
// Pallas kernel computes it for every lane, at no cost on the TPU's
// lock-step lanes); one divide per arctan (step_math.cuh); and the loop's
// sines come from one bounded-range reduction a sin/cos pair
// (acas::BoundedTrig: every angle there lies within |x| < 8).  ZERO_ACTIONS
// and WITH_OBS are template parameters, so the default launch carries no
// observation code.  At the headline shape (B = 262,144) that is 2,048
// blocks of 128 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_math.cuh"

namespace {

constexpr int THREADS = 128;
// The registers a thread may use: 8 blocks an SM leave it up to 64, and
// ptxas takes 54-56 (without the minimum it took 46-51 and fitted 9-10
// blocks, which ran 1.4% slower without obs: PERF.md, env_ab)
constexpr int MIN_BLOCKS = 8;
using Trig = acas::BoundedTrig;   // the loop's sines (the angles are bounded)
constexpr int N_IN = 9;    // px, py, psi, tx, ty, tv, tpsi, steps, total_reward
constexpr int N_OUT = 14;  // the same nine, then reward_sum, episodes, goals,
                           // collisions, obs_sum

struct Buffers {
  const void* in[N_IN];
  void* out[N_OUT];
};

__device__ __forceinline__ float load_f(const Buffers& b, int k, int e) {
  return static_cast<const float*>(b.in[k])[e];
}

__device__ __forceinline__ void store_f(const Buffers& b, int k, int e,
                                        float v) {
  static_cast<float*>(b.out[k])[e] = v;
}

__device__ __forceinline__ void store_i(const Buffers& b, int k, int e,
                                        int v) {
  static_cast<int*>(b.out[k])[e] = v;
}

template <bool ZERO_ACTIONS, bool WITH_OBS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) env_rollout_kernel(
    const acas::RolloutConsts c, int B, int T, uint32_t seed,
    const Buffers buf) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B) return;
  const uint32_t base = seed * 0x9E3779B9u
                      + (uint32_t)(e >> 10) * 0xC2B2AE35u
                      + (uint32_t)(e & 1023) * 0x27D4EB2Fu;
  float px = load_f(buf, 0, e), py = load_f(buf, 1, e);
  float psi = load_f(buf, 2, e), tx = load_f(buf, 3, e);
  float ty = load_f(buf, 4, e), tv = load_f(buf, 5, e);
  float tpsi = load_f(buf, 6, e);
  int steps = static_cast<const int*>(buf.in[7])[e];
  float tot = load_f(buf, 8, e);
  // the traffic's heading wrapped to [0, 360) first, as every heading the
  // env makes already is (mod360 is exact there), so that the bounded
  // routine applies to whatever the caller passes
  float tcos, tsin;
  Trig::sincos(acas::mod360(tpsi) * acas::kDeg2Rad, &tsin, &tcos);
  float rs = 0.0f, os = 0.0f;
  int ec = 0, gc = 0, cc = 0;

  for (int i = 0; i < T; ++i) {
    float a_lat = 0.0f;
    if (!ZERO_ACTIONS) {
      const float a = acas::u01_hash(base, i, 0) * 2.0f - 1.0f;
      a_lat = a * c.acc;
    }
    // integrate player + traffic (aircraft.py:16-26)
    psi = acas::mod360(psi + a_lat / c.v);
    const float pr = psi * acas::kDeg2Rad;
    float cp, sp;
    Trig::sincos(pr, &sp, &cp);
    px = px + c.v * cp * c.dt;
    py = py + c.v * sp * c.dt;
    tx = tx + tv * tcos * c.dt;
    ty = ty + tv * tsin * c.dt;
    steps += 1;

    const acas::Geom g = acas::env_geometry<Trig>(c, px, py, cp, sp, psi, tx,
                                                  ty, tv, tcos, tsin, a_lat);
    const float r_step =
        acas::shaped_step_reward(c, psi, g.h_goal_rad * acas::kRad2Deg, g);
    const bool collided = g.d_sep < c.coll_dist;
    const bool at_goal = g.d_goal < c.goal_radius;
    const bool in_time = steps <= c.max_steps;
    const float tdf = 1.0f - (float)steps * c.inv_max_steps;
    const float reward = r_step * tdf
                       + (collided ? c.reward_collision : 0.0f)
                       + (at_goal ? c.reward_goal : 0.0f);
    tot = tot + reward;
    rs = rs + reward;

    // termination: timeout > collision > goal (game.py:294-314)
    const bool done = !in_time || collided || at_goal;
    ec += done;
    gc += at_goal && !collided && in_time;
    cc += collided && in_time;

    // masked respawn; observe() leaves steps == 1 (game.py:197)
    if (done) {
      const float rb_psi = acas::u01_hash(base, i, 1);
      const float rb_sd = acas::u01_hash(base, i, 2);
      const float rb_tpsi = acas::u01_hash(base, i, 3);
      const float sd = rb_sd < 0.5f ? 1.0f : 0.0f;
      px = c.player_x0;
      py = c.player_y0;
      psi = acas::mod360(c.bearing + (rb_psi * 2.0f - 1.0f) * c.player_lim);
      tx = c.traffic_x0;
      ty = c.traffic_y_top + sd * c.traffic_y_span;
      tv = c.v;
      tpsi = acas::mod360(145.0f + sd * 70.0f
                          + (rb_tpsi * 2.0f - 1.0f) * c.traffic_lim);
      Trig::sincos(tpsi * acas::kDeg2Rad, &tsin, &tcos);
      steps = 1;
      tot = 0.0f;
    }

    if (WITH_OBS) {
      // The post-respawn observation.  Where the episode went on, its
      // geometry is g: the same state and the live a_lat in the lookahead.
      // A respawned lane measures its new state, with a_lat = 0.
      acas::Geom o = g;
      if (done) {
        float cp2, sp2;
        Trig::sincos(psi * acas::kDeg2Rad, &sp2, &cp2);
        o = acas::env_geometry<Trig>(c, px, py, cp2, sp2, psi, tx, ty, tv,
                                     tcos, tsin, 0.0f);
      }
      // one feature at a time, in the Pallas kernel's order (:311-320)
      os = os + (float)steps * c.inv_max_steps;
      os = os + psi * acas::kInv360;
      os = os + o.d_dev * c.inv_d_dev_max;
      os = os + o.d_goal * c.inv_d_goal_max;
      os = os + (o.h_goal_rad * acas::kRad2Deg) * acas::kInv360;
      os = os + o.d_sep * c.inv_d_sep_max;
      os = os + o.d_cpa * c.inv_d_cpa_max;
      os = os + o.v_closing * c.inv_v_closing_max;
    }
  }

  store_f(buf, 0, e, px);
  store_f(buf, 1, e, py);
  store_f(buf, 2, e, psi);
  store_f(buf, 3, e, tx);
  store_f(buf, 4, e, ty);
  store_f(buf, 5, e, tv);
  store_f(buf, 6, e, tpsi);
  store_i(buf, 7, e, steps);
  store_f(buf, 8, e, tot);
  store_f(buf, 9, e, rs);
  store_i(buf, 10, e, ec);
  store_i(buf, 11, e, gc);
  store_i(buf, 12, e, cc);
  store_f(buf, 13, e, os);
}

// out = registers a thread, local memory bytes a thread (stack frame and
// spills), resident blocks an SM
template <bool Z, bool O>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, env_rollout_kernel<Z, O>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, env_rollout_kernel<Z, O>, THREADS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return err;
}

template <bool Z, bool O>
cudaError_t launch(const acas::RolloutConsts& c, int B, int T, uint32_t seed,
                   const Buffers& buf, cudaStream_t stream) {
  env_rollout_kernel<Z, O><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                             stream>>>(c, B, T, seed, buf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The instantiation for (zero_actions, with_obs) as built for this card:
// out[3] as attrs() fills it.  Returns the CUDA error code.
int acas_env_rollout_attrs(int zero_actions, int with_obs, int* out) {
  cudaError_t err;
  if (zero_actions)
    err = with_obs ? attrs<true, true>(out) : attrs<true, false>(out);
  else
    err = with_obs ? attrs<false, true>(out) : attrs<false, false>(out);
  return (int)err;
}

// B envs, T steps.  ins: 9 device pointers of (B,) arrays, px, py, psi, tx,
// ty, tv, tpsi (float32), steps (int32), total_reward (float32); outs: 14
// device pointers, the same nine, then reward_sum (float32), episodes,
// goals, collisions (int32) and obs_sum (float32, 0 without with_obs).
// Returns the launch's cudaGetLastError().
int acas_env_rollout(const acas::RolloutConsts* c, int B, int T, int seed,
                     int zero_actions, int with_obs, void* const* ins,
                     void* const* outs, void* stream) {
  Buffers buf;
  for (int k = 0; k < N_IN; ++k) buf.in[k] = ins[k];
  for (int k = 0; k < N_OUT; ++k) buf.out[k] = outs[k];
  const uint32_t s = (uint32_t)seed;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (zero_actions)
    err = with_obs ? launch<true, true>(*c, B, T, s, buf, st)
                   : launch<true, false>(*c, B, T, s, buf, st);
  else
    err = with_obs ? launch<false, true>(*c, B, T, s, buf, st)
                   : launch<false, false>(*c, B, T, s, buf, st);
  return (int)err;
}

}  // extern "C"
