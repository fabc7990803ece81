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
// What bounds it on an H100: per env-step the MLP's products are 18,432
// flop, 256 tanhf and a few hundred float32 ops of the env step, against
// 64 bytes of buffers written: operations, not bytes.  On the CUDA cores
// the products alone need 0.146 ms at P = 32 x B = 1024, K = 16; on the
// TF32 tensor cores as 3xTF32 (three products each) 0.059 ms, and the
// 256 tanhf a step (one special-function op each at least) 0.032 ms.
//
// Design.  Both towers' products run on the TF32 tensor cores as 3xTF32
// mma.sync.m16n8k8 (tf32x3.cuh, shared with the gradient kernel): weights
// split once per block into {hi, lo} pairs in shared memory, activations
// split as a fragment is formed.  A tile is 16 * MT envs of one member
// (MT m16 row tiles; MT = 1 or 2); a block holds W tiles of one member.
// At MT = 2 a tile has two warps, one a tower; at MT = 1 four, two a
// tower, each with all of layer 1 and half of layer 2's columns and of the
// head, since there a step is a chain of dependent work on one warp a
// scheduler.  All warps of a tile run at once; the policy tower's (first)
// warp then runs the env step, one lane an env, and the value tower's
// writes the values.  The next observation goes through a per-tile double
// buffer in shared memory, and a tile's warps meet at one named barrier a
// step (two at MT = 1, where a tower's second warp hands over its half of
// the head).  The layer-1 product's C fragment of column block j is, with
// the columns of the k-step permuted (k = t <-> 2t, k = t + 4 <-> 2t + 1),
// the layer-2 product's A fragment of k-step j, so h1 never leaves
// registers: layer 1's n-tile j feeds layer 2's k-step j directly, and
// each B fragment (two {hi, lo} pairs adjacent in k) is one 16-byte load.
// The head is float32 on the CUDA cores in the C layout: a lane's dot over
// its columns, then two xor shuffles, so all four lanes of a row hold the
// same sum; the output is (columns 0-31 + columns 32-63) + b_head at any
// MT.  Every row's arithmetic is independent of its tile, W and MT, so
// the launch shape changes no output bit.  The wrapper picks (MT, W) from
// (P, B) and the SM count (ops/policy_rollout.py:launch_shape): at B =
// 2048, P = 1, MT = 1, W = 1, 128 blocks of 4 warps; at the population's
// P = 32, B = 1024, MT = 2, W = 4, 256 blocks of 8 warps.  An env's state
// lives in shared memory between steps, so that the MLP has the registers
// to itself.  Shared memory: the split weights 83,520 bytes a block, plus
// 1,920 bytes a tile an MT of observation buffers, state and head halves.
// Times in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_math.cuh"
#include "tf32x3.cuh"

namespace {

using namespace acas;

constexpr int H = 64;
constexpr int OBS = 8;
constexpr int TOWER = H * OBS + H + H * H + H + H + 1;  // 4801 floats
constexpr int N_PARAMS = 2 * TOWER + 1;           // 9603: + log_std
// a tower's offsets: W1 (64, 8), b1, W2 (64, 64), then b2, w_head, b_head
constexpr int O_B1 = H * OBS, O_W2 = O_B1 + H, O_B2 = O_W2 + H * H;
constexpr int MAX_WARPS = 16;  // a block's at most: 512 threads
// Warps a tile: a tile of 32 envs (MT = 2) takes a warp a tower; one of
// 16 (MT = 1), where the card has warps to spare, two a tower, each with
// half of layer 2's columns and of the head.
__host__ __device__ constexpr int warps_a_tile(int mt) {
  return mt == 1 ? 4 : 2;
}
// Row strides of the split weights, in {hi, lo} pairs: a quarter-warp's
// 16-byte B-fragment loads (rows g and g + 1, four pairs of columns) then
// hit the 8 distinct 16-byte bank groups (a row is 64 bytes mod 128 long).
constexpr int W1_LD = OBS;     // 64 bytes
constexpr int W2_LD = H + 8;   // 576 bytes
constexpr int VEC = 200;       // b1, b2, w_head, b_head in floats, padded
                               // (the policy tower's: then sigma and the
                               // log-prob constant)
constexpr int VEC_AT = H * W1_LD + H * W2_LD;      // a tower's vectors
constexpr int TOWER_PAIRS = VEC_AT + VEC / 2;       // 5220
constexpr int NSTATE = 12;     // words of an env's state (EnvState)

// Words a row of a tile: two observation buffers, the env's state, and
// (MT = 1) the two towers' second halves of the head.
constexpr int TILE_WORDS = 2 * OBS + NSTATE + 2;

__host__ __device__ constexpr int smem_bytes(int mt, int w) {
  // both towers' split weights, then the tiles of 16 * MT rows
  return 2 * TOWER_PAIRS * 8 + w * 16 * mt * TILE_WORDS * 4;
}

// B fragment whose k-rows t and t + 4 are adjacent {hi, lo} pairs at p.
__device__ __forceinline__ FragB load_pairs(const float2* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  FragB b;
  b.h[0] = __float_as_uint(v.x);
  b.l[0] = __float_as_uint(v.y);
  b.h[1] = __float_as_uint(v.z);
  b.l[1] = __float_as_uint(v.w);
  return b;
}

// A fragment of rows g and g + 8 from (x0, x1) at column 2t and (y0, y1)
// at column 2t + 1 of the block: k = t <-> 2t, k = t + 4 <-> 2t + 1.
__device__ __forceinline__ FragA frag_a(float x0, float x1, float y0,
                                        float y1) {
  FragA a;
  split(x0, a.h[0], a.l[0]);
  split(x1, a.h[1], a.l[1]);
  split(y0, a.h[2], a.l[2]);
  split(y1, a.h[3], a.l[3]);
  return a;
}

// One tower on the warp's MT row tiles of observations (obs: [16 * MT][8]
// in shared memory): layer 1, layer 2's column blocks q0 .. q0 + NQ - 1
// (NQ = 8: all; NQ = 4: one half) and the head over them.  out[mt][0 / 1]
// for rows g and g + 8 of row tile mt, in all four lanes of the row's quad:
// at NQ = 8 the tower's output, (half 0 + half 1) + b_head with each half
// the head's dot over 32 columns; at NQ = 4 the dot over the warp's half,
// which the caller completes in the same order.
template <int MT, int NQ>
__device__ __forceinline__ void tower(const float2* __restrict__ tw,
                                      const float* __restrict__ obs, int q0,
                                      float (&out)[MT][2]) {
  const float2* w1 = tw;
  const float2* w2 = w1 + H * W1_LD;
  const float* vec = reinterpret_cast<const float*>(tw + VEC_AT);
  const float* b1 = vec;
  const float* b2 = vec + H;
  const float* wh = vec + 2 * H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  FragA a1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float2 r0 = *reinterpret_cast<const float2*>(
        obs + (16 * mt + g) * OBS + 2 * t);
    const float2 r1 = *reinterpret_cast<const float2*>(
        obs + (16 * mt + g + 8) * OBS + 2 * t);
    a1[mt] = frag_a(r0.x, r1.x, r0.y, r1.y);
  }
  float acc[MT][NQ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][q][r] = 0.0f;

  // layer 1's column block j is layer 2's k-step j
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const FragB bw = load_pairs(w1 + (8 * j + g) * W1_LD + 2 * t);
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * j + 2 * t);
    FragA a2[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float c[4] = {};
      mma3(c, a1[mt], bw);
      // c: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of block j
      a2[mt] = frag_a(tanhf(c[0] + bb.x), tanhf(c[2] + bb.x),
                      tanhf(c[1] + bb.y), tanhf(c[3] + bb.y));
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const FragB b =
          load_pairs(w2 + (8 * (q0 + q) + g) * W2_LD + 8 * j + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma3_rn(acc[mt][q], a2[mt], b);
    }
  }

  const float bh = vec[3 * H];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < NQ / 4; ++h) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 4 * h; q < 4 * h + 4; ++q) {
        const int c = 8 * (q0 + q) + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
        const float2 w = *reinterpret_cast<const float2*>(wh + c);
        s0 += w.x * tanhf(acc[mt][q][0] + bb.x);
        s0 += w.y * tanhf(acc[mt][q][1] + bb.y);
        s1 += w.x * tanhf(acc[mt][q][2] + bb.x);
        s1 += w.y * tanhf(acc[mt][q][3] + bb.y);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (h == 0) {
        out[mt][0] = s0;
        out[mt][1] = s1;
      } else {
        out[mt][0] = (out[mt][0] + s0) + bh;
        out[mt][1] = (out[mt][1] + s1) + bh;
      }
    }
}

// dst(i, split of src0[i], split of src1[i]) for i < n over the block's
// threads.  Each thread loads a batch of both sources before it stores any:
// the compiler cannot tell a shared-memory store from a load of the
// weights, so loads and stores interleaved one at a time wait out an L2
// round trip each (~15 us for a block of two warps).  A batch of 4 a
// source keeps 8 loads in flight; 8 or 16 spill registers at MT = 2.
template <class Dst>
__device__ __forceinline__ void split_copy(const float* __restrict__ src0,
                                           const float* __restrict__ src1,
                                           int n, Dst dst) {
  constexpr int BATCH = 4;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * blockDim.x) {
    float a[BATCH], b[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      a[u] = i < n ? src0[i] : 0.0f;
      b[u] = i < n ? src1[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst(i, split_pair(a[u]), split_pair(b[u]));
    }
  }
}

// The barrier of tile `tile`'s warps (ids 1..MAX_WARPS / WARPS; 0 is the
// block's).
template <int WARPS>
__device__ __forceinline__ void tile_sync(int tile) {
  asm volatile("bar.sync %0, %1;" ::"r"(tile + 1), "n"(32 * WARPS)
               : "memory");
}

// An env's state between steps, in shared memory as [field][row] of its
// tile.
struct EnvState {
  float px, py, psi, tx, ty, tv, tpsi, tot, tcos, tsin, a_live;
  int steps;
};

__device__ __forceinline__ EnvState load_state(const float* s, int rows) {
  EnvState v;
  v.px = s[0 * rows];
  v.py = s[1 * rows];
  v.psi = s[2 * rows];
  v.tx = s[3 * rows];
  v.ty = s[4 * rows];
  v.tv = s[5 * rows];
  v.tpsi = s[6 * rows];
  v.tot = s[7 * rows];
  v.tcos = s[8 * rows];
  v.tsin = s[9 * rows];
  v.a_live = s[10 * rows];
  v.steps = __float_as_int(s[11 * rows]);
  return v;
}

__device__ __forceinline__ void store_state(float* s, int rows,
                                            const EnvState& v) {
  s[0 * rows] = v.px;
  s[1 * rows] = v.py;
  s[2 * rows] = v.psi;
  s[3 * rows] = v.tx;
  s[4 * rows] = v.ty;
  s[5 * rows] = v.tv;
  s[6 * rows] = v.tpsi;
  s[7 * rows] = v.tot;
  s[8 * rows] = v.tcos;
  s[9 * rows] = v.tsin;
  s[10 * rows] = v.a_live;
  s[11 * rows] = __int_as_float(v.steps);
}

template <int MT>
__global__ void __launch_bounds__(32 * MAX_WARPS) policy_rollout_kernel(
    const RolloutConsts c, int B, int K, const int* __restrict__ seed,
    int step_offset, const float* __restrict__ params,
    const float* __restrict__ st_in, const int* __restrict__ steps_in,
    const float* __restrict__ obs_in,
    float* __restrict__ st_out, int* __restrict__ steps_out,
    float* __restrict__ obs_out, float* __restrict__ obs_buf,
    float* __restrict__ fbuf, int* __restrict__ ibuf) {
  extern __shared__ __align__(16) float2 smem[];
  constexpr int ROWS = 16 * MT;
  constexpr int WPT = warps_a_tile(MT);
  constexpr int NQ = 16 / WPT;  // layer 2's column blocks a warp: 8 or 4
  const int member = blockIdx.y;
  const int W = blockDim.x / (32 * WPT);
  const float* mp = params + (size_t)member * N_PARAMS;
  // after both towers' vectors: the member's sigma and log-prob constant
  float* samp = reinterpret_cast<float*>(smem + VEC_AT) + 3 * H + 1;

  // both towers' weights, split once into {hi, lo} pairs
  const float* tp0 = mp;
  const float* tp1 = mp + TOWER;
  float2* w1 = smem;
  float2* w2 = smem + H * W1_LD;
  split_copy(tp0 + O_W2, tp1 + O_W2, H * H, [&](int i, float2 a, float2 b) {
    const int k = (i >> 6) * W2_LD + (i & 63);
    w2[k] = a;
    w2[TOWER_PAIRS + k] = b;
  });
  split_copy(tp0, tp1, H * OBS, [&](int i, float2 a, float2 b) {
    const int k = (i >> 3) * W1_LD + (i & 7);
    w1[k] = a;
    w1[TOWER_PAIRS + k] = b;
  });
  float* vec = reinterpret_cast<float*>(smem + VEC_AT);
  for (int i = threadIdx.x; i < 3 * H + 1; i += blockDim.x) {
    // b1, then b2, w_head, b_head
    const int o = i < H ? O_B1 + i : O_B2 + i - H;
    vec[i] = tp0[o];
    vec[2 * TOWER_PAIRS + i] = tp1[o];
  }
  if (threadIdx.x == 0) {
    const float log_std = fminf(fmaxf(mp[2 * TOWER], -4.0f), 2.0f);
    samp[0] = expf(log_std);
    samp[1] = -log_std - c.half_log_2pi;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp / WPT, role = warp % WPT;
  const int tw_id = role & 1;            // 0: the policy tower, 1: value
  const int q0 = NQ == 8 ? 0 : (role >> 1) * NQ;  // its first column block
  const bool stepper = role == 0;        // runs the env step
  const bool valuer = role == 1;         // writes the values
  const int tile0 = (blockIdx.x * W + tile) * ROWS;  // first env of the tile
  if (tile0 >= B) return;
  // the lane's env: row g + 8 (t & 1) of row tile t >> 1 (MT = 2), or of
  // row tile 0 for t < 2 (MT = 1), the rows whose outputs its quad holds
  const int g = lane >> 2, t = lane & 3;
  const bool has_row = MT == 2 || t < 2;
  const int half = t & 1, mt_own = MT == 2 ? t >> 1 : 0;
  const int row = 16 * mt_own + g + 8 * half;
  const int el = tile0 + row;  // env of this member
  const bool active = has_row && el < B;
  const int e = member * B + el;  // global env index
  const int PB = gridDim.y * B;
  // per tile: two observation buffers [2][ROWS][8], the state [12][ROWS],
  // the second halves of the head [2][ROWS]
  float* obs_s = reinterpret_cast<float*>(smem + 2 * TOWER_PAIRS)
               + tile * TILE_WORDS * ROWS;
  float* st_s = obs_s + 2 * ROWS * OBS + row;
  float* head2_s = obs_s + (2 * OBS + NSTATE) * ROWS + tw_id * ROWS;
  const float2* tw = smem + tw_id * TOWER_PAIRS;

  if (stepper && has_row) {
    float4 o0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), o1 = o0;
    if (active) {
      EnvState v;
      v.px = st_in[0 * PB + e];
      v.py = st_in[1 * PB + e];
      v.psi = st_in[2 * PB + e];
      v.tx = st_in[3 * PB + e];
      v.ty = st_in[4 * PB + e];
      v.tv = st_in[5 * PB + e];
      v.tpsi = st_in[6 * PB + e];
      v.tot = st_in[7 * PB + e];
      v.steps = steps_in[e];
      v.tcos = cosf(v.tpsi * kDeg2Rad);
      v.tsin = sinf(v.tpsi * kDeg2Rad);
      v.a_live = 0.0f;
      store_state(st_s, ROWS, v);
      const float* oi = obs_in + (size_t)e * OBS;
      o0 = make_float4(oi[0], oi[1], oi[2], oi[3]);
      o1 = make_float4(oi[4], oi[5], oi[6], oi[7]);
    }
    // rows past B stay zero in both buffers
    for (int b = 0; b < 2; ++b) {
      float4* os = reinterpret_cast<float4*>(obs_s + (b * ROWS + row) * OBS);
      os[0] = o0;
      os[1] = o1;
    }
  }
  tile_sync<WPT>(tile);

  const size_t KB = (size_t)K * PB;
  for (int i = 0; i < K; ++i) {
    const int cur = i & 1;
    const float* ob = obs_s + cur * ROWS * OBS;
    // out[mt][0 / 1]: the tower's output for rows g, g + 8 of row tile mt
    float out[MT][2];
    tower<MT, NQ>(tw, ob, q0, out);
    if constexpr (NQ == 4) {
      // the second half's warp hands its dots to the first's
      if (q0 != 0 && t == 0) {
        head2_s[g] = out[0][0];
        head2_s[g + 8] = out[0][1];
      }
      tile_sync<WPT>(tile);
      const float bh = reinterpret_cast<const float*>(tw + VEC_AT)[3 * H];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        out[0][k] = (out[0][k] + head2_s[g + 8 * k]) + bh;
    }
    float own = half ? out[0][1] : out[0][0];
    if (MT == 2 && mt_own == 1) own = half ? out[MT - 1][1] : out[MT - 1][0];
    const size_t kb = (size_t)i * PB + e;
    if (valuer && active) fbuf[2 * KB + kb] = own;  // value
    if (stepper && active) {
      EnvState v = load_state(st_s, ROWS);
      const int step_id = step_offset + i;
      const uint32_t base = (uint32_t)__ldg(seed) * 0x9E3779B9u
                          + (uint32_t)(e >> 10) * 0xC2B2AE35u
                          + (uint32_t)(e & 1023) * 0x27D4EB2Fu;
      // gaussian sample (SB3 collect_rollouts)
      const float mean = own;
      const float sigma = samp[0];
      const float u1 = u01_hash(base, step_id, 4);
      const float u2 = u01_hash(base, step_id, 5);
      const float z = sqrtf(-2.0f * logf(fmaxf(1.0f - u1, 1e-12f)))
                    * cosf(kTwoPi * u2);
      const float action = mean + sigma * z;  // raw sample
      const float dz = (action - mean) / sigma;
      const float logp = samp[1] - 0.5f * dz * dz;
      const float a_lat = fminf(fmaxf(action, -1.0f), 1.0f) * c.acc;

      // pre-step buffers
      const float4* os = reinterpret_cast<const float4*>(ob + row * OBS);
      float4* obd = reinterpret_cast<float4*>(obs_buf + kb * OBS);
      obd[0] = os[0];
      obd[1] = os[1];
      fbuf[0 * KB + kb] = action;
      fbuf[1 * KB + kb] = logp;

      // integrate player + traffic (aircraft.py:16-26)
      v.psi = mod360(v.psi + a_lat / c.v);
      float pr = v.psi * kDeg2Rad;
      float cp = cosf(pr), sp = sinf(pr);
      v.px = v.px + c.v * cp * c.dt;
      v.py = v.py + c.v * sp * c.dt;
      v.tx = v.tx + v.tv * v.tcos * c.dt;
      v.ty = v.ty + v.tv * v.tsin * c.dt;
      v.steps += 1;

      Geom gm = env_geometry(c, v.px, v.py, cp, sp, v.psi, v.tx, v.ty, v.tv,
                             v.tcos, v.tsin, a_lat);
      const float r_step =
          shaped_step_reward(c, v.psi, gm.h_goal_rad * kRad2Deg, gm);
      const bool collided = gm.d_sep < c.coll_dist;
      const bool at_goal = gm.d_goal < c.goal_radius;
      const bool timeout = v.steps > c.max_steps;
      const float tdf = 1.0f - (float)v.steps * c.inv_max_steps;
      const float reward = r_step * tdf
                         + (collided ? c.reward_collision : 0.0f)
                         + (at_goal ? c.reward_goal : 0.0f);
      v.tot = v.tot + reward;
      const bool done = timeout || collided || at_goal;
      const int outcome = timeout ? 3 : (collided ? 2 : (at_goal ? 1 : 0));

      fbuf[3 * KB + kb] = reward;
      fbuf[4 * KB + kb] = done ? 1.0f : 0.0f;
      fbuf[5 * KB + kb] = done ? v.tot : 0.0f;
      ibuf[0 * KB + kb] = done ? v.steps : 0;
      ibuf[1 * KB + kb] = outcome;

      // masked respawn (reset_from semantics); observe() leaves steps == 1
      if (done) {
        const float rb_psi = u01_hash(base, step_id, 1);
        const float rb_sd = u01_hash(base, step_id, 2);
        const float rb_tpsi = u01_hash(base, step_id, 3);
        const float sd = rb_sd < 0.5f ? 1.0f : 0.0f;
        v.px = c.player_x0;
        v.py = c.player_y0;
        v.psi = mod360(c.bearing + (rb_psi * 2.0f - 1.0f) * c.player_lim);
        v.tx = c.traffic_x0;
        v.ty = c.traffic_y_top + sd * c.traffic_y_span;
        v.tv = c.v;
        v.tpsi = mod360(145.0f + sd * 70.0f
                        + (rb_tpsi * 2.0f - 1.0f) * c.traffic_lim);
        const float ftr = v.tpsi * kDeg2Rad;
        v.tcos = cosf(ftr);
        v.tsin = sinf(ftr);
        v.steps = 1;
        v.tot = 0.0f;
      }

      // next observation; the closing-speed lookahead holds the live a_lat
      v.a_live = done ? 0.0f : a_lat;
      pr = v.psi * kDeg2Rad;
      cp = cosf(pr);
      sp = sinf(pr);
      gm = env_geometry(c, v.px, v.py, cp, sp, v.psi, v.tx, v.ty, v.tv,
                        v.tcos, v.tsin, v.a_live);
      float obs[OBS];
      build_obs(c, v.steps, v.psi, gm, obs);
      float4* on = reinterpret_cast<float4*>(obs_s
                                             + ((cur ^ 1) * ROWS + row) * OBS);
      on[0] = make_float4(obs[0], obs[1], obs[2], obs[3]);
      on[1] = make_float4(obs[4], obs[5], obs[6], obs[7]);
      store_state(st_s, ROWS, v);
    }
    tile_sync<WPT>(tile);
  }

  if (stepper && active) {
    const EnvState v = load_state(st_s, ROWS);
    st_out[0 * PB + e] = v.px;
    st_out[1 * PB + e] = v.py;
    st_out[2 * PB + e] = v.psi;
    st_out[3 * PB + e] = v.tx;
    st_out[4 * PB + e] = v.ty;
    st_out[5 * PB + e] = v.tv;
    st_out[6 * PB + e] = v.tpsi;
    st_out[7 * PB + e] = v.tot;
    st_out[8 * PB + e] = v.a_live;
    steps_out[e] = v.steps;
    const float4* os = reinterpret_cast<const float4*>(
        obs_s + ((K & 1) * ROWS + row) * OBS);
    float4* oo = reinterpret_cast<float4*>(obs_out + (size_t)e * OBS);
    oo[0] = os[0];
    oo[1] = os[1];
  }
}

// Lets policy_rollout_kernel<MT> take `smem` bytes of dynamic shared
// memory.  The attribute is set when a launch first needs more than the
// largest size set so far, and not again: an eager launch before a CUDA
// graph's capture sets it, and the capture records no attribute call.
template <int MT>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      policy_rollout_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <int MT>
cudaError_t attrs(int w, int* out) {
  const int smem = smem_bytes(MT, w);
  cudaError_t err = allow_smem<MT>(smem);
  cudaFuncAttributes a = {};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, policy_rollout_kernel<MT>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, policy_rollout_kernel<MT>, 32 * warps_a_tile(MT) * w, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return err;
}

template <int MT>
cudaError_t launch(const RolloutConsts& c, int P, int B, int K,
                   const int* seed, int step_offset, int w,
                   const float* params, const float* st_in,
                   const int* steps_in, const float* obs_in, float* st_out,
                   int* steps_out, float* obs_out, float* obs_buf,
                   float* fbuf, int* ibuf, cudaStream_t stream) {
  const int smem = smem_bytes(MT, w);
  const cudaError_t err = allow_smem<MT>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B + 16 * MT - 1) / (16 * MT);
  const dim3 grid((tiles + w - 1) / w, P);
  policy_rollout_kernel<MT><<<grid, 32 * warps_a_tile(MT) * w, smem,
                              stream>>>(
      c, B, K, seed, step_offset, params, st_in, steps_in, obs_in, st_out,
      steps_out, obs_out, obs_buf, fbuf, ibuf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The kernel for MT m16 row tiles a warp and blocks of w tiles, as built
// for this card: out[0] registers a thread, out[1] local memory bytes a
// thread, out[2] dynamic shared memory bytes a block, out[3] resident
// blocks an SM.  Returns the CUDA error code.
int acas_policy_rollout_attrs(int mt, int w, int* out) {
  if (mt == 1) return (int)attrs<1>(w, out);
  if (mt == 2) return (int)attrs<2>(w, out);
  return (int)cudaErrorInvalidValue;
}

// P members of B envs each, member-major (PB = P * B), in blocks of w
// tiles of 16 * mt envs (mt = 1 or 2).  params (P, 9603); st_in (8, PB):
// px, py, psi, tx, ty, tv, tpsi, total_reward; st_out (9, PB) adds the
// live a_lat.  obs_in / obs_out (PB, 8); obs_buf (K, PB, 8); fbuf (6, K,
// PB): action, logp, value, reward, done, episode_return; ibuf (2, K, PB):
// episode_steps, outcome.  The kernel reads the RNG seed (its int32 bit
// pattern) from device memory, seed[0], so that a CUDA graph's replay
// takes the seed its caller wrote there; step_offset, the same at every
// replay, is a value.  Returns the launch's cudaGetLastError() (or the
// error of setting its shared memory size).
int acas_policy_rollout(const acas::RolloutConsts* c, int P, int B, int K,
                        const int* seed, int step_offset, int mt, int w,
                        const float* params, const float* st_in,
                        const int* steps_in, const float* obs_in,
                        float* st_out, int* steps_out, float* obs_out,
                        float* obs_buf, float* fbuf, int* ibuf,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (mt == 1)
    return (int)launch<1>(*c, P, B, K, seed, step_offset, w,
                          params, st_in, steps_in, obs_in, st_out, steps_out,
                          obs_out, obs_buf, fbuf, ibuf, s);
  if (mt == 2)
    return (int)launch<2>(*c, P, B, K, seed, step_offset, w,
                          params, st_in, steps_in, obs_in, st_out, steps_out,
                          obs_out, obs_buf, fbuf, ibuf, s);
  return (int)cudaErrorInvalidValue;
}

// Marks the interface above, whose seed is a device pointer (builds of an
// earlier source take it as a value and lack this symbol).
int acas_policy_rollout_reads_seed(void) { return 1; }

}  // extern "C"
