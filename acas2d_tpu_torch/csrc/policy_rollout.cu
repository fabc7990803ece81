// Fused policy-in-kernel PPO rollout: K autoreset steps of the actor-critic
// forward, gaussian sampling and the environment step, in one launch.
//
// Replaces the TPU kernel acas2d_tpu/ops/pallas_policy.py:67
// (fused_policy_rollout_kernel), reached through fused_policy_rollout :375
// (one policy) and fused_policy_rollout_members :433 (P member policies,
// each rolling its own B envs, in one launch).
// Plain version: acas2d_tpu_torch/ops/policy_rollout.py:_rollout_plain.
//
// What it computes, per env and step (the Pallas kernel's semantics): the
// two-tower 64-tanh MLP (mean, value), a Box-Muller sample on hash salts 4/5,
// the log-prob of the raw sample, clip and scale to the lateral
// acceleration, integration, geometry with the bug_compat quirks, shaped
// reward, outcome codes 3 > 2 > 1, a masked respawn on salts 1-3, and the
// next observation from the live a_lat.  The envs of all members are one
// member-major index space, e = m * B + (env of member m).  The RNG streams
// equal the TPU kernel's: its member grid numbers env e of member m as lane
// e % 1024 of program m * G + e / 1024 (G = B / 1024), which is the global
// index hashed here whenever B % 1024 == 0 (always at P == 1).
//
// What bounds it on an H100: the MLP is 18,688 flop per env-step and the
// env step is a few hundred more, against 64 bytes of buffers written per
// env-step, so the work is float32 operations on the CUDA cores, not bytes.
// Design: one thread per env with the state in registers and a loop over
// the K steps; grid (env blocks of one member, members), so a block never
// straddles two members and loads only its own member's weights and
// log_std; both towers' weights (38 KB) in shared memory, read at one
// address by all threads of a warp (broadcast, float4-wide); each tower on
// its own — h1 (64 floats) in registers, then the layer-2 neurons one at a
// time, each fed straight into the head's dot product — so the TPU kernel's
// 128x128 block-diagonal product is never formed.  At B = 2048, P = 1 this
// is 16 blocks of 128 threads on 132 SMs: latency-bound; at the population
// shape (P = 32, B = 1024) 256 blocks.  Times in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_math.cuh"

namespace {

constexpr int H = 64;
constexpr int OBS = 8;
constexpr int TOWER = H * OBS + H + H * H + H + H + 1;  // 4801 floats
constexpr int N_PARAMS = 2 * TOWER + 1;           // 9603: + log_std
constexpr int TOWER_SMEM = 4804;  // tower stride in shared memory (16-B aligned)
constexpr int THREADS = 128;

// One tower and its head: W1 (64,8), b1, W2 (64,64), b2, w_head, b_head.
__device__ __forceinline__ float tower_out(const float* __restrict__ tw,
                                           const float* obs) {
  const float* w1 = tw;
  const float* b1 = w1 + H * OBS;
  const float* w2 = b1 + H;
  const float* b2 = w2 + H * H;
  const float* wh = b2 + H;
  float h1[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float4 wa = reinterpret_cast<const float4*>(w1 + k * OBS)[0];
    const float4 wb = reinterpret_cast<const float4*>(w1 + k * OBS)[1];
    float a = wa.x * obs[0] + wa.y * obs[1] + wa.z * obs[2] + wa.w * obs[3]
            + wb.x * obs[4] + wb.y * obs[5] + wb.z * obs[6] + wb.w * obs[7];
    h1[k] = tanhf(a + b1[k]);
  }
  float out = 0.0f;
  for (int j = 0; j < H; ++j) {
    const float4* row = reinterpret_cast<const float4*>(w2 + j * H);
    float a = 0.0f;
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 w = row[q];
      a += w.x * h1[4 * q] + w.y * h1[4 * q + 1] + w.z * h1[4 * q + 2]
         + w.w * h1[4 * q + 3];
    }
    out += wh[j] * tanhf(a + b2[j]);
  }
  return out + wh[H];
}

__global__ void __launch_bounds__(THREADS) policy_rollout_kernel(
    const acas::RolloutConsts c, int B, int K, uint32_t seed, int step_offset,
    const float* __restrict__ params, const float* __restrict__ st_in,
    const int* __restrict__ steps_in, const float* __restrict__ obs_in,
    float* __restrict__ st_out, int* __restrict__ steps_out,
    float* __restrict__ obs_out, float* __restrict__ obs_buf,
    float* __restrict__ fbuf, int* __restrict__ ibuf) {
  __shared__ __align__(16) float w[2 * TOWER_SMEM];
  const int member = blockIdx.y;
  const float* mp = params + (size_t)member * N_PARAMS;
  for (int i = threadIdx.x; i < TOWER; i += THREADS) {
    w[i] = mp[i];
    w[TOWER_SMEM + i] = mp[TOWER + i];
  }
  __syncthreads();

  const int el = blockIdx.x * THREADS + threadIdx.x;  // env of this member
  if (el >= B) return;
  const int e = member * B + el;                      // global env index
  const int PB = gridDim.y * B;

  const float log_std = fminf(fmaxf(mp[2 * TOWER], -4.0f), 2.0f);
  const float sigma = expf(log_std);
  const float logp_const = -log_std - c.half_log_2pi;
  const uint32_t base = seed * 0x9E3779B9u
                      + (uint32_t)(e >> 10) * 0xC2B2AE35u
                      + (uint32_t)(e & 1023) * 0x27D4EB2Fu;

  float px = st_in[0 * PB + e], py = st_in[1 * PB + e];
  float psi = st_in[2 * PB + e], tx = st_in[3 * PB + e];
  float ty = st_in[4 * PB + e], tv = st_in[5 * PB + e];
  float tpsi = st_in[6 * PB + e], tot = st_in[7 * PB + e];
  int steps = steps_in[e];
  float tcos = cosf(tpsi * acas::kDeg2Rad);
  float tsin = sinf(tpsi * acas::kDeg2Rad);
  float obs[OBS];
#pragma unroll
  for (int f = 0; f < OBS; ++f) obs[f] = obs_in[(size_t)e * OBS + f];
  float a_live = 0.0f;
  const size_t KB = (size_t)K * PB;

  for (int i = 0; i < K; ++i) {
    const int step_id = step_offset + i;
    const size_t kb = (size_t)i * PB + e;

    // policy forward + gaussian sample (SB3 collect_rollouts)
    const float mean = tower_out(w, obs);
    const float value = tower_out(w + TOWER_SMEM, obs);
    const float u1 = acas::u01_hash(base, step_id, 4);
    const float u2 = acas::u01_hash(base, step_id, 5);
    const float z = sqrtf(-2.0f * logf(fmaxf(1.0f - u1, 1e-12f)))
                  * cosf(acas::kTwoPi * u2);
    const float action = mean + sigma * z;  // raw sample
    const float dz = (action - mean) / sigma;
    const float logp = logp_const - 0.5f * dz * dz;
    const float a_lat = fminf(fmaxf(action, -1.0f), 1.0f) * c.acc;

    // pre-step buffers
    float4* ob = reinterpret_cast<float4*>(obs_buf + kb * OBS);
    ob[0] = make_float4(obs[0], obs[1], obs[2], obs[3]);
    ob[1] = make_float4(obs[4], obs[5], obs[6], obs[7]);
    fbuf[0 * KB + kb] = action;
    fbuf[1 * KB + kb] = logp;
    fbuf[2 * KB + kb] = value;

    // integrate player + traffic (aircraft.py:16-26)
    psi = acas::mod360(psi + a_lat / c.v);
    float pr = psi * acas::kDeg2Rad;
    float cp = cosf(pr), sp = sinf(pr);
    px = px + c.v * cp * c.dt;
    py = py + c.v * sp * c.dt;
    tx = tx + tv * tcos * c.dt;
    ty = ty + tv * tsin * c.dt;
    steps += 1;

    acas::Geom g = acas::env_geometry(c, px, py, cp, sp, psi, tx, ty, tv,
                                      tcos, tsin, a_lat);
    const float r_step =
        acas::shaped_step_reward(c, psi, g.h_goal_rad * acas::kRad2Deg, g);
    const bool collided = g.d_sep < c.coll_dist;
    const bool at_goal = g.d_goal < c.goal_radius;
    const bool timeout = steps > c.max_steps;
    const float tdf = 1.0f - (float)steps * c.inv_max_steps;
    const float reward = r_step * tdf
                       + (collided ? c.reward_collision : 0.0f)
                       + (at_goal ? c.reward_goal : 0.0f);
    tot = tot + reward;
    const bool done = timeout || collided || at_goal;
    const int outcome = timeout ? 3 : (collided ? 2 : (at_goal ? 1 : 0));

    fbuf[3 * KB + kb] = reward;
    fbuf[4 * KB + kb] = done ? 1.0f : 0.0f;
    fbuf[5 * KB + kb] = done ? tot : 0.0f;
    ibuf[0 * KB + kb] = done ? steps : 0;
    ibuf[1 * KB + kb] = outcome;

    // masked respawn (reset_from semantics); observe() leaves steps == 1
    if (done) {
      const float rb_psi = acas::u01_hash(base, step_id, 1);
      const float rb_sd = acas::u01_hash(base, step_id, 2);
      const float rb_tpsi = acas::u01_hash(base, step_id, 3);
      const float sd = rb_sd < 0.5f ? 1.0f : 0.0f;
      px = c.player_x0;
      py = c.player_y0;
      psi = acas::mod360(c.bearing + (rb_psi * 2.0f - 1.0f) * c.player_lim);
      tx = c.traffic_x0;
      ty = c.traffic_y_top + sd * c.traffic_y_span;
      tv = c.v;
      tpsi = acas::mod360(145.0f + sd * 70.0f
                          + (rb_tpsi * 2.0f - 1.0f) * c.traffic_lim);
      const float ftr = tpsi * acas::kDeg2Rad;
      tcos = cosf(ftr);
      tsin = sinf(ftr);
      steps = 1;
      tot = 0.0f;
    }

    // next observation; the closing-speed lookahead holds the live a_lat
    a_live = done ? 0.0f : a_lat;
    pr = psi * acas::kDeg2Rad;
    cp = cosf(pr);
    sp = sinf(pr);
    g = acas::env_geometry(c, px, py, cp, sp, psi, tx, ty, tv, tcos, tsin,
                           a_live);
    acas::build_obs(c, steps, psi, g, obs);
  }

  st_out[0 * PB + e] = px;
  st_out[1 * PB + e] = py;
  st_out[2 * PB + e] = psi;
  st_out[3 * PB + e] = tx;
  st_out[4 * PB + e] = ty;
  st_out[5 * PB + e] = tv;
  st_out[6 * PB + e] = tpsi;
  st_out[7 * PB + e] = tot;
  st_out[8 * PB + e] = a_live;
  steps_out[e] = steps;
#pragma unroll
  for (int f = 0; f < OBS; ++f) obs_out[(size_t)e * OBS + f] = obs[f];
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// P members of B envs each, member-major (PB = P * B).  params (P, 9603);
// st_in (8, PB): px, py, psi, tx, ty, tv, tpsi, total_reward; st_out (9, PB)
// adds the live a_lat.  obs_in / obs_out (PB, 8); obs_buf (K, PB, 8);
// fbuf (6, K, PB): action, logp, value, reward, done, episode_return;
// ibuf (2, K, PB): episode_steps, outcome.  Returns the launch's
// cudaGetLastError().
int acas_policy_rollout(const acas::RolloutConsts* c, int P, int B, int K,
                        int seed, int step_offset, const float* params,
                        const float* st_in, const int* steps_in,
                        const float* obs_in, float* st_out, int* steps_out,
                        float* obs_out, float* obs_buf, float* fbuf,
                        int* ibuf, void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS, P);
  policy_rollout_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      *c, B, K, (uint32_t)seed, step_offset, params, st_in, steps_in, obs_in,
      st_out, steps_out, obs_out, obs_buf, fbuf, ibuf);
  return (int)cudaGetLastError();
}

}  // extern "C"
