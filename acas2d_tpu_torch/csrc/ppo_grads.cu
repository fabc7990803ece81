// Fused PPO minibatch gradient: forward and hand-derived backward of the
// clipped PPO loss, with the loss statistics, in two deterministic passes.
//
// Replaces the TPU kernel acas2d_tpu/ops/pallas_update.py:60
// (_ppo_grad_kernel), reached through ppo_minibatch_grads :345 (one policy)
// and, vmapped over a population's members, ppo_minibatch_grads_packed :389
// (P members' minibatches in one launch), with f32 or bf16 operands.
// Plain version: acas2d_tpu_torch/ops/ppo_grads.py:_grads_plain.
//
// What it computes (the Pallas kernel's branch structure): the two towers'
// forward, the log-prob of the stored action, the +-20 log-ratio clamp
// (delta_in), the ratio, the strict in_band test, the min-branch selector
// sel, the straight-through log-std gradient, unclipped value MSE; then the
// parameter gradients of both towers and heads, and the sums of policy loss,
// value loss, KL and clip count.  Advantages arrive normalised (the wrapper
// normalises the minibatch, as normalize_adv_column does).
//
// What bounds it on an H100: ~54,000 flop per row (forward 2 x 9,344,
// backward about twice that) against 52 bytes read per row, so operations.
// F32: float32 on the CUDA cores (67 TFLOP/s) or the products on the TF32
// tensor cores at three products each (495 TFLOP/s dense), the least of the
// two.  BF16: the bf16 tensor cores (989 TFLOP/s dense).
//
// Two first passes, each a kernel of its own; both walk a block's rows in
// tiles of 64 and keep the cross-row products dW2 = e2^T h1 and
// dW1 = e1^T x in registers across the tile loop.
//   grad_partials_tf32x3 (f32): Hopper's warpgroup MMA (wgmma.mma_async,
//   sm_90a; wgmma_tf32.cuh) in TF32 as 3xTF32: each operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
//   hi*lo + lo*hi + hi*hi is summed in float32, which carries ~22 bits of
//   each operand, close to float32 (1xTF32 would keep 11).  A block is two
//   warpgroups; each takes every other 64-row tile of the block and walks
//   it from start to finish alone: its 64 rows are exactly wgmma's M, so a
//   tile needs no other warps and no block barrier.  Layout and design
//   below, at the kernel.
//   grad_partials_bf16mma (bf16, the JAX kernel's bf16=True,
//   pallas_update.py:109-127): the two operands of each of the eight
//   products (forward W1 x, W2 h1, w_head h2; backward dO h2, w_head dO,
//   e2^T h1, e2 W2, e1^T x) are rounded to bf16 (round to nearest even) and
//   the products summed in float32 on mma.sync; biases, bias sums, the tanh
//   derivatives and the loss stay float32.  Layout and design below.
//
// Blocks run in no order, so the TPU kernel's sequential
// accumulation becomes two passes.  Pass 1: block (b, member * 2 + tower)
// takes a contiguous range of one member's rows for one tower (the
// members are independent, and so are the towers: the
// policy tower needs only the mean, the value tower only the value).
// Each block writes its partial sums of the 4,801 tower gradients
// and the loss sums, each in a fixed order.  Pass 2 sums the partials of
// every entry in block order: the result is deterministic, with no float
// atomics.  Only the real
// 64x64 blocks are computed; the TPU kernel's off-diagonal packing is not,
// so the packed path's masked gradients are exactly the flat vector.  The
// wrapper bounds the blocks of a launch (about 256 over all members), so
// the partials stay small at any population size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace acas;

constexpr int H = 64;
constexpr int OBS = 8;
constexpr int NCOL = 13;  // packed row: obs(8), action, logp, value, adv, ret
constexpr int TOWER = H * OBS + H + H * H + H + H + 1;  // 4801
constexpr int N_PARAMS = 2 * TOWER + 1;                 // 9603: + log_std
constexpr int NSTAT = 5;  // policy loss, value loss, kl, clip count, dls
constexpr int REC = TOWER + NSTAT;                      // partial record
constexpr int O_B1 = H * OBS, O_W2 = O_B1 + H, O_B2 = O_W2 + H * H;
constexpr int O_WH = O_B2 + H, O_BH = O_WH + H;
constexpr int T = 64;        // rows per tile
constexpr int THREADS = 256;
constexpr int VEC = 200;     // b1, b2, w_head, b_head (padded to 8 floats)

struct GradConsts {
  float inv_n, eps, lo, hi, dvalue_scale, log_2pi;
};

// ------------------------------------------------ bf16 pass (mma.sync)
//
// A block has 8 warps and walks its rows in tiles of 64; the tile's
// activations live in shared memory row-major (h1, h2, e1; row stride 68
// floats) beside bf16 copies of x, h1, e2 and e1 (row stride 72).  Warps
// 2r and 2r+1 own rows 16r..16r+15 of the forward, the head and loss (four
// lanes a row, reduced by shuffles) and e1, each warp 32 of the 64
// features, and meet at 64-thread named barriers; only the cross-row
// products dW2 (a 16 x 32 tile a warp) and dW1 (16 x 8 over half the rows
// a warp) and the end of a tile wait for the whole block: 3 block barriers
// a tile.  Each operand is rounded once: the weights as a block loads
// them, x, h1, e2 and e1 as a tile builds them.  Products m16n8k16 bf16
// (layer 1, K = 8: m16n8k8), one term each; fragments come from the bf16
// copies by ldmatrix, whose .trans form reads the column-major operands
// (e2 and h1 in dW2, W2 in e1, e1 and x in dW1) from the same row-major
// copy.  The head's two products and w_head * dO are scalar, on rounded
// values.  The bias and head-weight sums are per-lane registers over the
// warp's rows.  93,216 bytes of shared memory a block, 2 blocks an SM.

using bf16 = __nv_bfloat16;

// A product operand rounded to bf16 and back.
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int LDT = 68;  // row stride of the (T, 64) float32 tiles
constexpr int LDB = 72;  // row stride of the bf16 copies: 144 bytes, so the
                         // 8 rows of an ldmatrix hit 32 distinct banks

// Shared memory in floats, every region a multiple of 16 bytes: W2
// (64 x LDB) and W1 rounded, VEC, x ([t][OBS]), h1, h2, e1 (float32,
// [t][LDT]), row fields, dout, and the copies of h1, e2, e1 ([t][LDB]).
constexpr int BF16_WEIGHTS = (H * LDB + H * OBS) / 2;
constexpr int BF16_X = T * OBS / 2;
constexpr int BF16_FLOATS = BF16_WEIGHTS + VEC + BF16_X + 3 * T * LDT
                          + 4 * T + T + 3 * T * LDB / 2;

// Fragments of mma.sync.m16n8k16 with bf16 operands: each 32-bit register
// holds two bf16 adjacent in k, the lower k in the low half.  Lane
// 4 g + t holds A (16 x 16) pairs (g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8); B (16 x 8) pairs (2t, g), (2t + 8, g); C as above.
// m16n8k8 takes the first two A registers and the first B register.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l & 7 of matrix l >> 3 (16 bytes, 16-byte aligned).  Plain, lane
// 4 g + t receives (row g, columns 2t, 2t + 1) of each matrix; .trans,
// (rows 2t, 2t + 1, column g).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// The same for one bf16 k-step.
__device__ __forceinline__ void mma_bf16_rn(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  float z[4] = {};
  mma_bf16(z, a, b0, b1);
  add_tile(c, z);
}

// C tile (16 x 8) to p[m * ld + n], each element through f(value, n);
// under BF16 also rounded to bf16 into q[m * LDB + n].
template <bool BF16 = false, class F>
__device__ __forceinline__ void store_c(float* p, int ld, const float (&c)[4],
                                        F f, bf16* q = nullptr) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
  const float2 u = make_float2(f(c[0], t2), f(c[1], t2 + 1));
  const float2 v = make_float2(f(c[2], t2), f(c[3], t2 + 1));
  *reinterpret_cast<float2*>(p + g * ld + t2) = u;
  *reinterpret_cast<float2*>(p + (g + 8) * ld + t2) = v;
  if constexpr (BF16) {
    *reinterpret_cast<__nv_bfloat162*>(q + g * LDB + t2) =
        __float22bfloat162_rn(u);
    *reinterpret_cast<__nv_bfloat162*>(q + (g + 8) * LDB + t2) =
        __float22bfloat162_rn(v);
  }
}

// Barrier of the two warps that own row tile rt (ids 1-4; 0 is the
// block's).
__device__ __forceinline__ void pair_sync(int rt) {
  asm volatile("bar.sync %0, 64;" ::"r"(rt + 1) : "memory");
}

__device__ __forceinline__ void grad_partials_bf16(
    const GradConsts& c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) float tc[];
  const int member = blockIdx.y >> 1;
  const int tower = blockIdx.y & 1;
  params += (size_t)member * N_PARAMS;
  data += (size_t)member * n * NCOL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = warp >> 1, ch = warp & 1;  // row tile, feature half
  const int t0 = 16 * rt;                   // first row of the row tile
  const int c0 = 32 * ch;                   // first feature of the half
  const int col = c0 + lane;                // this lane's feature
  const int hr = t0 + 8 * ch + (lane >> 2), hq = lane & 3;  // head row, phase
  const int g = lane >> 2, tq = lane & 3;   // fragment row, column pair
  // ldmatrix x4 row addresses (lane >> 3 picks the matrix): matrix bit 0
  // moves 8 rows, bit 1 8 columns (rows-first), or the other way round
  const int ldm_rows = (((lane >> 3) & 1) * 8 + (lane & 7)) * LDB
                     + (lane >> 4) * 8;
  const int ldm_cols = ((lane >> 4) * 8 + (lane & 7)) * LDB
                     + ((lane >> 3) & 1) * 8;
  bf16* w2b = reinterpret_cast<bf16*>(tc);      // (64, LDB)
  bf16* w1b = w2b + H * LDB;                    // (64, 8)
  float* b1 = tc + BF16_WEIGHTS;
  float* b2 = b1 + H;
  float* wh = b2 + H;                // rounded
  float* bh = wh + H;
  float* xs = b1 + VEC;
  bf16* xb = reinterpret_cast<bf16*>(xs);  // [t][OBS]
  float* h1 = xs + BF16_X;           // [t][LDT]
  float* h2 = h1 + T * LDT;          // [t][LDT]
  float* e1 = h2 + T * LDT;          // [t][LDT]
  float* rowv = e1 + T * LDT;        // act, old_logp, adv, ret: [4][T]
  float* dout = rowv + 4 * T;        // [T]
  bf16* h1b = reinterpret_cast<bf16*>(dout + T);  // [t][LDB]
  bf16* e2b = h1b + T * LDB;
  bf16* e1b = e2b + T * LDB;

  const float* tp = params + tower * TOWER;
  for (int i = tid; i < H * H; i += THREADS)
    w2b[(i >> 6) * LDB + (i & 63)] = __float2bfloat16_rn(tp[O_W2 + i]);
  for (int i = tid; i < H * OBS; i += THREADS)
    w1b[i] = __float2bfloat16_rn(tp[i]);
  if (tid < H) {
    b1[tid] = tp[O_B1 + tid];
    b2[tid] = tp[O_B2 + tid];
    wh[tid] = rnd(tp[O_WH + tid]);
  } else if (tid == H) {
    bh[0] = tp[O_BH];
  }
  const float cls = fminf(fmaxf(params[2 * TOWER], -4.0f), 2.0f);
  const float var = expf(2.0f * cls);

  float dw2[4][4] = {};  // dW2 rows 16 rt.., columns c0 + 8 q..
  float dw1[4] = {};     // dW1 rows 16 (warp & 3).., all 8 columns
  float g_wh = 0.0f, g_b2 = 0.0f, g_b1 = 0.0f;  // feature col, rows of rt
  float s_pl = 0.0f, s_vl = 0.0f, s_kl = 0.0f, s_cf = 0.0f, s_dls = 0.0f;
  float s_bh = 0.0f;                            // row hr (hq == 0 lanes)

  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(n, r_begin + rows_per_block);
  __syncthreads();
  for (int r0 = r_begin; r0 < r_end; r0 += T) {
    const int nt = min(T, r_end - r0);
    // the row tile's 16 contiguous rows of 13 floats, by its two warps
    for (int i = 32 * ch + lane; i < 16 * NCOL; i += 64) {
      const int tl = i / NCOL, cl = i - tl * NCOL, t = t0 + tl;
      const float v = t < nt ? data[(size_t)(r0 + t0) * NCOL + i] : 0.0f;
      if (cl < OBS) xb[t * OBS + cl] = __float2bfloat16_rn(v);
      else if (cl == 8) rowv[t] = v;
      else if (cl == 9) rowv[T + t] = v;
      else if (cl == 11) rowv[2 * T + t] = v;
      else if (cl == 12) rowv[3 * T + t] = v;
    }
    pair_sync(rt);
    // layer 1: h1 = tanh(x W1^T + b1), K = 8
    {
      uint32_t ax[2];
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(xb);
      ax[0] = xw[(t0 + g) * (OBS / 2) + tq];
      ax[1] = xw[(t0 + g + 8) * (OBS / 2) + tq];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = c0 + 8 * q;
        float z[4] = {};
        const uint32_t* ww = reinterpret_cast<const uint32_t*>(w1b);
        mma_bf16_k8(z, ax[0], ax[1], ww[(n0 + g) * (OBS / 2) + tq]);
        store_c<true>(h1 + t0 * LDT + n0, LDT, z,
                      [&](float v, int j) { return tanhf(v + b1[n0 + j]); },
                      h1b + t0 * LDB + n0);
      }
    }
    pair_sync(rt);
    // layer 2: h2 = tanh(h1 W2^T + b2)
    {
      float z[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, h1b + t0 * LDB + 16 * ks + ldm_rows);
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          uint32_t b[4];
          ldsm4(b, w2b + (c0 + 16 * qq) * LDB + 16 * ks + ldm_cols);
          mma_bf16_rn(z[2 * qq], a, b[0], b[1]);
          mma_bf16_rn(z[2 * qq + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = c0 + 8 * q;
        store_c(h2 + t0 * LDT + n0, LDT, z[q],
                [&](float v, int j) { return tanhf(v + b2[n0 + j]); });
      }
    }
    pair_sync(rt);
    // head and the loss: four lanes a row, features hq + 4 i
    {
      const int t = hr;
      float o = 0.0f;
#pragma unroll
      for (int i = 0; i < H / 4; ++i)
        o += wh[hq + 4 * i] * rnd(h2[t * LDT + hq + 4 * i]);
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      o += __shfl_xor_sync(0xffffffffu, o, 2);
      if (hq == 0) {
        o += bh[0];
        float d = 0.0f;
        if (t < nt) {
          if (tower == 0) {
            const float act = rowv[t], old_logp = rowv[T + t];
            const float adv = rowv[2 * T + t];
            const float diff = act - o;
            const float logp = -0.5f * (diff * diff / var + 2.0f * cls
                                        + c.log_2pi);
            const float delta = logp - old_logp;
            const bool delta_in = fabsf(delta) < 20.0f;
            const float dc = fminf(fmaxf(delta, -20.0f), 20.0f);
            const float ratio = expf(dc);
            const bool in_band = (ratio > c.lo) && (ratio < c.hi);
            const float unclipped = adv * ratio;
            const float clipped = adv * fminf(fmaxf(ratio, c.lo), c.hi);
            s_pl += -fminf(unclipped, clipped);
            s_kl += (ratio - 1.0f) - dc;
            s_cf += fabsf(ratio - 1.0f) > c.eps ? 1.0f : 0.0f;
            // min() picks the unclipped branch inside the band, and outside
            // it where clipping would have helped the objective
            const bool sel = in_band || (adv > 0.0f && ratio < c.lo)
                          || (adv < 0.0f && ratio > c.hi);
            const float dlogp = (-(adv * ratio) * c.inv_n)
                              * ((sel && delta_in) ? 1.0f : 0.0f);
            d = dlogp * (diff / var);
            // straight-through log_std: d logp / d log_std = diff^2/var - 1
            s_dls += dlogp * (diff * diff / var - 1.0f);
          } else {
            const float verr = o - rowv[3 * T + t];
            s_vl += verr * verr;
            d = c.dvalue_scale * verr;
          }
        }
        dout[t] = d;
        s_bh += d;
      }
    }
    pair_sync(rt);
    // e2 = (w_head * dout) * (1 - h2^2); w_head and b2 sums
    {
      const float w = wh[col];
      float sw = 0.0f, sb = 0.0f;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const float d = rnd(dout[t0 + r]);
        float* p = h2 + (t0 + r) * LDT + col;
        const float hv = *p;
        sw += d * rnd(hv);
        const float e = (w * d) * (1.0f - hv * hv);
        e2b[(t0 + r) * LDB + col] = __float2bfloat16_rn(e);
        sb += e;
      }
      g_wh += sw;
      g_b2 += sb;
    }
    __syncthreads();
    // e1 = (e2 W2) * (1 - h1^2) on the row tile; dW2 += e2^T h1 on rows
    // 16 rt.. and columns c0.. over all rows
    {
      float z[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t a[4];
        ldsm4(a, e2b + t0 * LDB + 16 * ks + ldm_rows);
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          uint32_t b[4];
          ldsm4_t(b, w2b + 16 * ks * LDB + c0 + 16 * qq + ldm_rows);
          mma_bf16(z[2 * qq], a, b[0], b[1]);
          mma_bf16(z[2 * qq + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = c0 + 8 * q;
        store_c(e1 + t0 * LDT + n0, LDT, z[q], [](float v, int) { return v; });
      }
    }
    {
      float z[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < T / 16; ++ks) {
        uint32_t a[4];
        ldsm4_t(a, e2b + 16 * ks * LDB + t0 + ldm_cols);
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          uint32_t b[4];
          ldsm4_t(b, h1b + 16 * ks * LDB + c0 + 16 * qq + ldm_rows);
          mma_bf16(z[2 * qq], a, b[0], b[1]);
          mma_bf16(z[2 * qq + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) add_tile(dw2[q], z[q]);
    }
    __syncwarp();
    {
      float sb = 0.0f;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const float hv = h1[(t0 + r) * LDT + col];
        float* p = e1 + (t0 + r) * LDT + col;
        const float e = *p * (1.0f - hv * hv);
        e1b[(t0 + r) * LDB + col] = __float2bfloat16_rn(e);
        sb += e;
      }
      g_b1 += sb;
    }
    __syncthreads();
    // dW1 += e1^T x: rows 16 (warp & 3).. over half (warp >> 2) of the rows
    {
      const int k0 = 16 * (warp & 3), tr = (warp >> 2) * (T / 2);
      float z[4] = {};
#pragma unroll
      for (int ks = 0; ks < T / 32; ++ks) {
        uint32_t a[4], b[2];
        ldsm4_t(a, e1b + (tr + 16 * ks) * LDB + k0 + ldm_cols);
        ldsm2_t(b, xb + (tr + 16 * ks + ((lane >> 3) & 1) * 8
                         + (lane & 7)) * OBS);
        mma_bf16(z, a, b[0], b[1]);
      }
      add_tile(dw1, z);
    }
    __syncthreads();
  }

  // dW2 and dW1 tiles, the per-lane sums and the loss sums go through
  // shared memory, then out in coalesced stores; every sum in fixed order
  float* rec = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * REC;
  const auto id = [](float v, int) { return v; };
#pragma unroll
  for (int q = 0; q < 4; ++q)
    store_c(h1 + t0 * LDT + c0 + 8 * q, LDT, dw2[q], id);
  store_c(e1 + (warp >> 2) * H * OBS + 16 * (warp & 3) * OBS, OBS, dw1, id);
  float* lanes = h2;               // [b1, b2, w_head][rt][feature]
  float* stat = h2 + 3 * 4 * H;    // [NSTAT + 1][row owner]
  lanes[rt * H + col] = g_b1;
  lanes[4 * H + rt * H + col] = g_b2;
  lanes[8 * H + rt * H + col] = g_wh;
  if (hq == 0) {
    const float s[NSTAT + 1] = {s_pl, s_vl, s_kl, s_cf, s_dls, s_bh};
#pragma unroll
    for (int q = 0; q <= NSTAT; ++q) stat[q * T + hr] = s[q];
  }
  __syncthreads();
  for (int i = tid; i < H * H; i += THREADS)
    rec[O_W2 + i] = h1[(i >> 6) * LDT + (i & 63)];
  for (int i = tid; i < H * OBS; i += THREADS)
    rec[i] = e1[i] + e1[H * OBS + i];
  if (tid < 3 * H) {
    const int q = tid >> 6, j = tid & 63;
    const float* p = lanes + q * 4 * H + j;
    const float s = ((p[0] + p[H]) + p[2 * H]) + p[3 * H];
    rec[(q == 0 ? O_B1 : q == 1 ? O_B2 : O_WH) + j] = s;
  } else if (tid <= 3 * H + NSTAT) {
    const int q = tid - 3 * H;
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += stat[q * T + t];
    rec[q < NSTAT ? TOWER + q : O_BH] = s;
  }
}

__global__ void __launch_bounds__(THREADS, 2) grad_partials_bf16mma(
    const GradConsts c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  grad_partials_bf16(c, data, n, rows_per_block, params, partial);
}

// ------------------------------------------------ f32 pass (wgmma, 3xTF32)
//
// A block is two warpgroups (4 warps each) over one (member, tower); after
// the block has split its weights, warpgroup v takes tiles v, v + 2, ...
// of the block's rows and walks each from start to finish alone, meeting
// only its own 128 threads at named barriers (ids 1 and 2):
//   rows    staged by cp.async into one of two buffers a tile ahead;
//   layer 1 h1 = tanh(x W1^T + b1): one k-step, A = x from registers;
//   layer 2 h2 = tanh(h1 W2^T + b2): A = h1 from the accumulator's own
//           registers, 8 k-steps, each started from zero and added in a
//           float32 add (the tensor cores' float32 sums do not round to
//           nearest; two accumulators in turn keep a k-step in flight);
//   head    o = h2 . w_head + b_head in registers: an accumulator row lives
//           in the 4 lanes of a quad, 16 FMAs a row and two quad shuffles;
//           the loss in those lanes, dO and e2 = (w_head dO)(1 - h2^2)
//           without a round trip through shared memory;
//   dW2    += e2^T h1 (shared A and B, chained over the tile's 64 rows,
//           started from zero every tile) and e1 = (e2 W2)(1 - h1^2)
//           (A = e2 from registers, chained over 64) in one group;
//   dW1    += e1^T x (m64n8, shared A and B, started from zero every tile).
// The bias and head-weight sums and the loss sums stay float32 in
// registers: a thread holds 2 rows x 16 columns of each tile, summed over
// the 8 lanes of a column by a reduce-scatter of shuffles (each lane keeps
// 2 columns).  Each activation and error is split into {hi, lo} once, as
// it is stored; the weights once a block.
//
// TF32 wgmma reads both operands K-major (wgmma_tf32.cuh), so the
// products that run over rows (dW2, dW1) read h1, e2, e1 and x transposed,
// [feature][row] in shared memory, and W2 is held twice, [out][in] for the
// forward and [in][out] for e1, each as hi and lo.  Layer 2 and e1 read A
// from an accumulator's registers: a thread holds columns 2q and 2q + 1 of
// each 8 where an A fragment wants k = q and q + 4, so within each 8 of K
// both copies of W2 store input p at position (p >> 1) + 4 (p & 1)
// (kperm); the tensor cores' sum of an instruction's 8 products does not
// depend on their order (the same errors in order, on the card).
// A thread holds rows g and g + 8 of its warp's 16, which the transposed
// tiles store side by side, row 16 w + g + 8 h at position 16 w + 2 g + h,
// so one float2 store writes both (x^T the same).  Sums over K keep their
// chains: 8 deep in layer 2, 64 in e1, a tile's 64 rows in dW2 and dW1, as
// on mma.sync before.
//
// Shared memory (floats): W2 [out][in'] hi, lo; W2^T [in][out'] hi, lo
// (each 64 x 64, K-chunks 256 apart); W1 hi, lo; VEC; then a warpgroup's
// region each: 2 row buffers of 64 x 13, x^T hi, lo (8 x 64), h1^T hi, lo
// (64 x 64, K-chunks KLD = 260 apart so that a warp's float2 stores hit
// distinct banks; e1^T reuses it once dW2 has read it), e2^T hi, lo, and
// the loss and head sums of its 32 row owners (8 w + g) with their
// compensations.  69,632 + 800 + 2 x 78,848 = 228,128 bytes, one block an
// SM; 255
// registers a thread and no spill (ptxas -v, kernel_attrs): dW2's 32
// accumulators, layer 2's three 32-float sums, e2's split parts for e1.

constexpr int WGS = 2;                  // warpgroups a block
constexpr int WG_THREADS = 128;
constexpr int STAGE = T * NCOL;         // a tile's rows as stored: 832
constexpr int KLD = 260;                // floats between K-chunks of a
                                        // transposed tile
constexpr int TILE_T = 16 * KLD;        // a transposed 64 x 64 tile
constexpr int WMAT = H * H;             // a 64 x 64 weight copy
constexpr int F_W2F = 0, F_W2T = 2 * WMAT, F_W1 = 4 * WMAT;
constexpr int F_VEC = F_W1 + 2 * H * OBS;
constexpr int F_WG = F_VEC + VEC;       // the first warpgroup's region
constexpr int G_XT = 2 * STAGE, G_HT = G_XT + 2 * T * OBS;
constexpr int G_ET = G_HT + 2 * TILE_T;
constexpr int G_ST = G_ET + 2 * TILE_T;  // loss and head sums, and their c
constexpr int G_FLOATS = G_ST + 2 * (NSTAT + 1) * 32;
constexpr int F32_FLOATS = F_WG + WGS * G_FLOATS;
// descriptors' byte offsets: LBO between K-chunks, SBO between 8-row groups
constexpr uint32_t W_LBO = 1024, T_LBO = 4 * KLD, X_LBO = 128, SBO = 128;

// Element (n, k) of a weight copy (N x K, K-major), of a transposed tile,
// and of x^T (N = 8).
__device__ __forceinline__ int at_w(int n, int k) {
  return (k >> 2) * 256 + (n >> 3) * 32 + (n & 7) * 4 + (k & 3);
}
__device__ __forceinline__ int at_t(int n, int k) {
  return (k >> 2) * KLD + (n >> 3) * 32 + (n & 7) * 4 + (k & 3);
}
__device__ __forceinline__ int at_x(int n, int k) {
  return (k >> 2) * 32 + n * 4 + (k & 3);
}
// Position in K of input p of a product whose A is an accumulator.
__device__ __forceinline__ int kperm(int p) {
  return (p & ~7) | ((p & 7) >> 1) | ((p & 1) << 2);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("barrier.sync.aligned %0, 128;" ::"r"(wg + 1) : "memory");
}

// 4 bytes to shared memory, or zeros where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// sum += v, with the rounding error carried in c (Kahan): sum - c is the
// running total.  The loss and head sums over a block's rows can cancel to
// a small part of their terms (the value head's bias gradient to 1 / 39,000
// of them at 32,768 rows); a plain float32 running sum then errs ~1.5e-4
// of the result, a compensated one ~7e-6.
__device__ __forceinline__ void kahan_add(float& sum, float& c, float v) {
  const float y = v - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float2 as_float2(uint32_t a, uint32_t b) {
  return make_float2(__uint_as_float(a), __uint_as_float(b));
}

// v (16 columns of a thread's rows) summed over the 8 lanes of each column
// (lane bits 2-4), added to out: lane 4 g + q keeps entries m0 and m0 + 1,
// m0 = 8 (g & 1) + 4 ((g >> 1) & 1) + 2 (g >> 2).
__device__ __forceinline__ void sum_rows(const float (&v)[16],
                                         float (&out)[2]) {
  const int lane = threadIdx.x & 31;
  float a[8], b[4];
  const bool b0 = lane & 4, b1 = lane & 8, b2 = lane & 16;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = (b0 ? v[8 + k] : v[k])
         + __shfl_xor_sync(0xffffffffu, b0 ? v[k] : v[8 + k], 4);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = (b1 ? a[4 + k] : a[k])
         + __shfl_xor_sync(0xffffffffu, b1 ? a[k] : a[4 + k], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    out[k] += (b2 ? b[2 + k] : b[k])
            + __shfl_xor_sync(0xffffffffu, b2 ? b[k] : b[2 + k], 16);
}

__global__ void __launch_bounds__(THREADS, 1) grad_partials_tf32x3(
    const GradConsts c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int member = blockIdx.y >> 1;
  const int tower = blockIdx.y & 1;
  params += (size_t)member * N_PARAMS;
  data += (size_t)member * n * NCOL;
  const int tid = threadIdx.x;
  float* w2f = sm + F_W2F;  // hi, then lo at + WMAT
  float* w2t = sm + F_W2T;
  float* w1 = sm + F_W1;    // hi, then lo at + H * OBS
  float* b1 = sm + F_VEC;
  float* b2 = b1 + H;
  float* wh = b2 + H;
  float* bh = wh + H;

  const float* tp = params + tower * TOWER;
  for (int i = tid; i < H * H; i += THREADS) {
    const int o = i >> 6, j = i & 63;
    uint32_t hi, lo;
    split(tp[O_W2 + i], hi, lo);
    const int f = at_w(o, kperm(j)), t = at_w(j, kperm(o));
    w2f[f] = __uint_as_float(hi);
    w2f[WMAT + f] = __uint_as_float(lo);
    w2t[t] = __uint_as_float(hi);
    w2t[WMAT + t] = __uint_as_float(lo);
  }
  for (int i = tid; i < H * OBS; i += THREADS) {
    uint32_t hi, lo;
    split(tp[i], hi, lo);
    const int f = at_w(i >> 3, i & 7);
    w1[f] = __uint_as_float(hi);
    w1[H * OBS + f] = __uint_as_float(lo);
  }
  if (tid < H) {
    b1[tid] = tp[O_B1 + tid];
    b2[tid] = tp[O_B2 + tid];
    wh[tid] = tp[O_WH + tid];
  } else if (tid == H) {
    bh[0] = tp[O_BH];
  }
  const float cls = fminf(fmaxf(params[2 * TOWER], -4.0f), 2.0f);
  const float var = expf(2.0f * cls);
  fence_async_smem();
  __syncthreads();

  const int wg = tid >> 7, wt = tid & 127;
  const int w = wt >> 5, lane = wt & 31, g = lane >> 2, q = lane & 3;
  float* region = sm + F_WG + wg * G_FLOATS;
  float* xt = region + G_XT;  // hi, then lo at + T * OBS
  float* ht = region + G_HT;  // h1^T, then e1^T; hi, then lo at + TILE_T
  float* et = region + G_ET;  // e2^T
  // loss and head sums [NSTAT + 1][owner 8 w + g], then their c (kahan_add)
  float* ss = region + G_ST;
  float* sc = ss + (NSTAT + 1) * 32;
  const int owner = 8 * w + g;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(n, r_begin + rows_per_block);
  const int ntiles = (r_end - r_begin + T - 1) / T;
  // a tile's 64 rows of 13 floats, zeros past the block's rows
  const auto stage_tile = [&](float* buf, int tile) {
    const int r0 = r_begin + tile * T;
    const int nf = min(T, r_end - r0) * NCOL;
    const float* src = data + (size_t)r0 * NCOL;
    for (int i = wt; i < STAGE; i += WG_THREADS)
      cp_async4(buf + i, i < nf ? src + i : data, i < nf);
  };

  float dw2[32], dw1[4];  // dW2 (64 x 64), dW1 (64 x 8) accumulators
#pragma unroll
  for (int i = 0; i < 32; ++i) dw2[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dw1[i] = 0.0f;
  float s_b1[2] = {}, s_b2[2] = {}, s_wh[2] = {};  // sum_rows' 2 columns
  if (q == 0) {
#pragma unroll
    for (int k = 0; k <= NSTAT; ++k) {
      ss[k * 32 + owner] = 0.0f;
      sc[k * 32 + owner] = 0.0f;
    }
  }

  if (wg < ntiles) stage_tile(region, wg);
  cp_async_commit();
  int it = 0;
  for (int tile = wg; tile < ntiles; tile += WGS, ++it) {
    const float* st = region + (it & 1) * STAGE;
    if (tile + WGS < ntiles)
      stage_tile(region + ((it + 1) & 1) * STAGE, tile + WGS);
    cp_async_commit();
    cp_async_wait<1>();
    wg_sync(wg);
    const int nt = min(T, r_end - (r_begin + tile * T));

    // x^T: feature f, row pair p (rows 16 (p >> 3) + (p & 7), + 8)
    {
      const int f = wt & 7;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = (wt >> 3) + 16 * j;
        const int r = 16 * (p >> 3) + (p & 7);
        uint32_t h0, l0, h8, l8;
        split(st[r * NCOL + f], h0, l0);
        split(st[(r + 8) * NCOL + f], h8, l8);
        const int a = at_x(f, 2 * p);
        *reinterpret_cast<float2*>(xt + a) = as_float2(h0, h8);
        *reinterpret_cast<float2*>(xt + T * OBS + a) = as_float2(l0, l8);
      }
    }
    // layer 1: h1 = tanh(x W1^T + b1), K = 8
    float h1[32];
    {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split(st[(16 * w + g + 8 * h) * NCOL + q + 4 * e], ah[h + 2 * e],
                al[h + 2 * e]);
#pragma unroll
      for (int i = 0; i < 32; ++i) h1[i] = 0.0f;
      wg_fence();
      wg3_rs(h1, ah, al, wg_desc(w1, W_LBO, SBO),
             wg_desc(w1 + H * OBS, W_LBO, SBO), true);
      wg_commit();
      wg_wait<0>();
      fence_regs(h1);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        h1[i] = tanhf(h1[i] + b1[8 * (i >> 2) + 2 * q + (i & 1)]);
    }
    // layer 2: h2 = tanh(h1 W2^T + b2); h1^T stored as it is split
    float h2[32];
    {
      float z[2][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        h2[i] = 0.0f;
        z[0][i] = 0.0f;
        z[1][i] = 0.0f;
      }
#pragma unroll
      for (int s = 0; s < H / 8; ++s) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split(h1[4 * s + 2 * h + e], ah[h + 2 * e], al[h + 2 * e]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = at_t(8 * s + 2 * q + e, 16 * w + 2 * g);
          *reinterpret_cast<float2*>(ht + a) = as_float2(ah[2 * e],
                                                         ah[2 * e + 1]);
          *reinterpret_cast<float2*>(ht + TILE_T + a) =
              as_float2(al[2 * e], al[2 * e + 1]);
        }
        wg_fence();
        wg3_rs(z[s & 1], ah, al, wg_desc(w2f + 512 * s, W_LBO, SBO),
               wg_desc(w2f + WMAT + 512 * s, W_LBO, SBO), true);
        wg_commit();
        if (s > 0) {
          wg_wait<1>();
          fence_regs(z[(s - 1) & 1]);
#pragma unroll
          for (int i = 0; i < 32; ++i) h2[i] += z[(s - 1) & 1][i];
        }
      }
      wg_wait<0>();
      fence_regs(z[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        h2[i] = tanhf((h2[i] + z[1][i]) + b2[8 * (i >> 2) + 2 * q + (i & 1)]);
    }
    // head and the loss: rows 16 w + g + 8 h, in all 4 lanes of the quad
    float d[2];
    {
      float sv[NSTAT + 1] = {};  // this tile's rows: pl, vl, kl, cf, dls, bh
      float o[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[(i >> 1) & 1] += wh[8 * (i >> 2) + 2 * q + (i & 1)] * h2[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[h] += __shfl_xor_sync(0xffffffffu, o[h], 1);
        o[h] += __shfl_xor_sync(0xffffffffu, o[h], 2);
        o[h] += bh[0];
        const int t = 16 * w + g + 8 * h;
        const float* rv = st + t * NCOL;
        float dd = 0.0f;
        if (t < nt) {
          if (tower == 0) {
            const float act = rv[8], old_logp = rv[9], adv = rv[11];
            const float diff = act - o[h];
            const float logp = -0.5f * (diff * diff / var + 2.0f * cls
                                        + c.log_2pi);
            const float delta = logp - old_logp;
            const bool delta_in = fabsf(delta) < 20.0f;
            const float dc = fminf(fmaxf(delta, -20.0f), 20.0f);
            const float ratio = expf(dc);
            const bool in_band = (ratio > c.lo) && (ratio < c.hi);
            const float unclipped = adv * ratio;
            const float clipped = adv * fminf(fmaxf(ratio, c.lo), c.hi);
            sv[0] += -fminf(unclipped, clipped);
            sv[2] += (ratio - 1.0f) - dc;
            sv[3] += fabsf(ratio - 1.0f) > c.eps ? 1.0f : 0.0f;
            // min() picks the unclipped branch inside the band, and outside
            // it where clipping would have helped the objective
            const bool sel = in_band || (adv > 0.0f && ratio < c.lo)
                          || (adv < 0.0f && ratio > c.hi);
            const float dlogp = (-(adv * ratio) * c.inv_n)
                              * ((sel && delta_in) ? 1.0f : 0.0f);
            dd = dlogp * (diff / var);
            // straight-through log_std: d logp / d log_std = diff^2/var - 1
            sv[4] += dlogp * (diff * diff / var - 1.0f);
          } else {
            const float verr = o[h] - rv[12];
            sv[1] += verr * verr;
            dd = c.dvalue_scale * verr;
          }
        }
        d[h] = dd;
        sv[5] += dd;
      }
      if (q == 0) {
#pragma unroll
        for (int k = 0; k <= NSTAT; ++k)
          kahan_add(ss[k * 32 + owner], sc[k * 32 + owner], sv[k]);
      }
    }
    // e2 = (w_head * dO) * (1 - h2^2); w_head and b2 sums; e2^T stored
    uint32_t eh[32], el[32];
    {
      float sw[16], sb[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i0 = 4 * (m >> 1) + (m & 1), i1 = i0 + 2;  // rows h = 0, 1
        const float wv = wh[8 * (m >> 1) + 2 * q + (m & 1)];
        const float v0 = h2[i0], v1 = h2[i1];
        sw[m] = d[0] * v0 + d[1] * v1;
        const float e0 = (wv * d[0]) * (1.0f - v0 * v0);
        const float e1 = (wv * d[1]) * (1.0f - v1 * v1);
        sb[m] = e0 + e1;
        split(e0, eh[i0], el[i0]);
        split(e1, eh[i1], el[i1]);
        const int a = at_t(8 * (m >> 1) + 2 * q + (m & 1), 16 * w + 2 * g);
        *reinterpret_cast<float2*>(et + a) = as_float2(eh[i0], eh[i1]);
        *reinterpret_cast<float2*>(et + TILE_T + a) =
            as_float2(el[i0], el[i1]);
      }
      sum_rows(sw, s_wh);
      sum_rows(sb, s_b2);
    }
    fence_async_smem();
    wg_sync(wg);
    // dW2 += e2^T h1 and e1 = e2 W2, one group
    float zd[32], ze[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      zd[i] = 0.0f;
      ze[i] = 0.0f;
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < T / 8; ++s)
      wg3_ss(zd, wg_desc(et + 2 * KLD * s, T_LBO, SBO),
             wg_desc(et + TILE_T + 2 * KLD * s, T_LBO, SBO),
             wg_desc(ht + 2 * KLD * s, T_LBO, SBO),
             wg_desc(ht + TILE_T + 2 * KLD * s, T_LBO, SBO), s == 0);
#pragma unroll
    for (int s = 0; s < H / 8; ++s) {
      const uint32_t ah[4] = {eh[4 * s], eh[4 * s + 2], eh[4 * s + 1],
                              eh[4 * s + 3]};
      const uint32_t al[4] = {el[4 * s], el[4 * s + 2], el[4 * s + 1],
                              el[4 * s + 3]};
      wg3_rs(ze, ah, al, wg_desc(w2t + 512 * s, W_LBO, SBO),
             wg_desc(w2t + WMAT + 512 * s, W_LBO, SBO), s == 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(zd);
    fence_regs(ze);
#pragma unroll
    for (int i = 0; i < 32; ++i) dw2[i] += zd[i];
    wg_sync(wg);  // every warp's dW2 has read h1^T
    // e1 = (e2 W2) * (1 - h1^2); b1 sums; e1^T stored over h1^T
    {
      float sb[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int i0 = 4 * (m >> 1) + (m & 1), i1 = i0 + 2;
        const float x0 = ze[i0] * (1.0f - h1[i0] * h1[i0]);
        const float x1 = ze[i1] * (1.0f - h1[i1] * h1[i1]);
        sb[m] = x0 + x1;
        uint32_t h0, l0, h8, l8;
        split(x0, h0, l0);
        split(x1, h8, l8);
        const int a = at_t(8 * (m >> 1) + 2 * q + (m & 1), 16 * w + 2 * g);
        *reinterpret_cast<float2*>(ht + a) = as_float2(h0, h8);
        *reinterpret_cast<float2*>(ht + TILE_T + a) = as_float2(l0, l8);
      }
      sum_rows(sb, s_b1);
    }
    fence_async_smem();
    wg_sync(wg);
    // dW1 += e1^T x
    {
      float zx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      wg_fence();
#pragma unroll
      for (int s = 0; s < T / 8; ++s)
        wg3_ss_n8(zx, wg_desc(ht + 2 * KLD * s, T_LBO, SBO),
                  wg_desc(ht + TILE_T + 2 * KLD * s, T_LBO, SBO),
                  wg_desc(xt + 64 * s, X_LBO, 2 * SBO),
                  wg_desc(xt + T * OBS + 64 * s, X_LBO, 2 * SBO), s == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(zx);
#pragma unroll
      for (int i = 0; i < 4; ++i) dw1[i] += zx[i];
    }
  }

  // each warpgroup's sums into its own region, then the record: every sum
  // over warpgroups, warps and lanes in a fixed order
  __syncthreads();
  float* p2 = ht;                  // dW2 [out][in]
  float* p1 = ht + TILE_T;         // dW1 [out][in]
  float* pc = et;                  // [b1, b2, w_head][warp][feature]
#pragma unroll
  for (int i = 0; i < 32; ++i)
    p2[(16 * w + g + 8 * ((i >> 1) & 1)) * H + 8 * (i >> 2) + 2 * q
       + (i & 1)] = dw2[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p1[(16 * w + g + 8 * (i >> 1)) * OBS + 2 * q + (i & 1)] = dw1[i];
  const int m0 = 8 * (g & 1) + 4 * ((g >> 1) & 1) + 2 * (g >> 2);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = 4 * m0 + 2 * q + k;
    pc[w * H + f] = s_b1[k];
    pc[4 * H + w * H + f] = s_b2[k];
    pc[8 * H + w * H + f] = s_wh[k];
  }
  __syncthreads();
  float* rec = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * REC;
  const float* r0 = sm + F_WG;
  const float* r1 = r0 + G_FLOATS;
  for (int i = tid; i < H * H; i += THREADS)
    rec[O_W2 + i] = r0[G_HT + i] + r1[G_HT + i];
  for (int i = tid; i < H * OBS; i += THREADS)
    rec[i] = r0[G_HT + TILE_T + i] + r1[G_HT + TILE_T + i];
  if (tid < 3 * H) {
    const int k = tid >> 6, j = tid & 63;
    float s[WGS];
#pragma unroll
    for (int v = 0; v < WGS; ++v) {
      const float* p = (v ? r1 : r0) + G_ET + k * 4 * H + j;
      s[v] = ((p[0] + p[H]) + p[2 * H]) + p[3 * H];
    }
    rec[(k == 0 ? O_B1 : k == 1 ? O_B2 : O_WH) + j] = s[0] + s[1];
  } else if (tid <= 3 * H + NSTAT) {
    const int k = tid - 3 * H;
    float s = 0.0f, s_c = 0.0f, lost = 0.0f;
    for (int v = 0; v < WGS; ++v) {
      const float* p = (v ? r1 : r0) + G_ST + k * 32;
      for (int t = 0; t < 32; ++t) {
        kahan_add(s, s_c, p[t]);
        lost += p[(NSTAT + 1) * 32 + t];
      }
    }
    rec[k < NSTAT ? TOWER + k : O_BH] = s - (s_c + lost);
  }
}

// Per member: grads (2 * TOWER + 1), both towers' gradients in
// partial-record order, then d log_std - ent_coef; sums (4): policy loss,
// value loss, kl, clips.  One thread per output entry of all P members.
__global__ void grad_reduce_kernel(const float* __restrict__ partial, int P,
                                   int nblocks, float ent_coef,
                                   float* __restrict__ grads,
                                   float* __restrict__ sums) {
  constexpr int PER = 2 * TOWER + NSTAT;
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= P * PER) return;
  const int m = gi / PER, i = gi - m * PER;
  const float* mp = partial + (size_t)m * 2 * nblocks * REC;
  if (i < 2 * TOWER) {
    const int tower = i / TOWER, o = i - tower * TOWER;
    const float* p = mp + (size_t)tower * nblocks * REC + o;
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += p[(size_t)b * REC];
    grads[(size_t)m * N_PARAMS + i] = s;
  } else {
    const int q = i - 2 * TOWER;
    float s = 0.0f;
    for (int tower = 0; tower < 2; ++tower)
      for (int b = 0; b < nblocks; ++b)
        s += mp[((size_t)tower * nblocks + b) * REC + TOWER + q];
    if (q == NSTAT - 1) grads[(size_t)m * N_PARAMS + 2 * TOWER] = s - ent_coef;
    else sums[m * 4 + q] = s;
  }
}

using PartialsKernel = void (*)(GradConsts, const float*, int, int,
                                const float*, float*);

// The first pass of a variant, its dynamic shared bytes, and the attribute
// that lets it take them.
PartialsKernel partials_kernel(int bf16) {
  return bf16 ? grad_partials_bf16mma : grad_partials_tf32x3;
}

size_t partials_smem(int bf16) {
  return (bf16 ? BF16_FLOATS : F32_FLOATS) * sizeof(float);
}

// Sets that attribute once a variant: an eager launch before a CUDA
// graph's capture sets it, and the capture records no attribute call.
cudaError_t set_partials_smem(int bf16) {
  static bool set[2] = {false, false};
  if (set[bf16 != 0]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel(bf16), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)partials_smem(bf16));
  if (err == cudaSuccess) set[bf16 != 0] = true;
  return err;
}

// ------------------------------------------ advantage normalisation
//
// SB3's advantage normalisation, (adv - mean) / (std + 1e-8) with the
// population std (ddof 0), of every minibatch of an epoch at once and in
// place: the epoch's packed copy is G groups (minibatch x member) of M rows
// of 13, and each group's column 11 is normalised over its M rows.  Plain
// version: ops/ppo_grads.py:normalize_adv_minibatches on CPU tensors
// (normalize_adv_column's torch ops).  It replaces no TPU kernel: JAX
// normalises each minibatch with jnp outside its Pallas kernel
// (acas2d_tpu/ops/pallas_update.py:290-297).  The learner ran the same
// chain of torch ops once a minibatch step (seven launches, two of them
// reductions of one long strided row); it runs these two launches once an
// epoch.
//
// What bounds it: bytes.  A 52-byte row puts each advantage in a 32-byte
// sector of its own, so a row costs one sector read by each kernel and one
// written back: ~96 bytes a row (0.12 ms for an epoch of 4.19 M rows at
// 3.35 TB/s).  So each thread loads NORM_ITEMS rows before it uses one,
// and the grid is about NORM_WAVE blocks an SM deep at any shape.
//
// Two launches, since every block of a group needs the whole group's
// statistics and blocks cannot wait on each other:
//   adv_norm_partials_kernel: block (g, s) takes the s-th of S contiguous
//   row ranges of group g and writes its (count, mean, M2) in float64, of
//   the advantages less the group's first (its shift, which block 0 writes
//   out).  A thread takes NORM_ITEMS rows at a time (their mean, then the
//   squares about it, from registers) and merges them into its own by
//   Chan's formula; then the warps' and the block's merges, in a fixed
//   order.
//   adv_norm_apply_kernel: every block of group g merges the S partials in
//   the same fixed order, so all of them agree bit for bit; adds the shift
//   back and rounds the mean, and std = sqrt(M2 / M), to the data's type
//   once; and normalises its rows in place.  Block s = 0 writes the mean
//   and std out.
// No sum is kept in float32, whose running sums over thousands of rows
// lose the digits a cancelling column needs, and E[x^2] - E[x]^2 is never
// formed.  The shift keeps the merged means near 0, so a column of mean
// 1e4 and std 1e-2 keeps float64's digits (unshifted, a merge rounds its
// mean at 1e4's ulp, and the float64 std is ~1e-12 off).  S = min(32,
// blocks to fill the card, NORM_ITEMS x NORM_THREADS row chunks of a
// group), so one warp merges a group's partials.

constexpr int ADV = 11;               // the advantage column
constexpr int NORM_THREADS = 256;
constexpr int NORM_ITEMS = 4;         // rows a thread loads before it uses one
constexpr int NORM_MAX_SPLIT = 32;    // blocks a group: a warp lane each
constexpr int NORM_WAVE = 8;          // blocks an SM the grid aims at

struct Moments {
  double n, mean, m2;                 // count, mean, sum of squares about it
};

// Chan's merge of two disjoint sets' moments.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// Lane 0 gets the merge of the warp's 32, always in the same order.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_down_sync(0xffffffffu, m.n, off),
                    __shfl_down_sync(0xffffffffu, m.mean, off),
                    __shfl_down_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

// The rows [r0, r1) of group g's column that block s takes.
__device__ __forceinline__ void norm_rows(int M, int rows_per_block,
                                          int& r0, int& r1) {
  r0 = blockIdx.y * rows_per_block;
  r1 = min(M, r0 + rows_per_block);
}

template <typename Real>
__global__ void __launch_bounds__(NORM_THREADS) adv_norm_partials_kernel(
    const Real* __restrict__ data, int M, int rows_per_block,
    Moments* __restrict__ partial, double* __restrict__ shift) {
  int r0, r1;
  norm_rows(M, rows_per_block, r0, r1);
  const Real* col = data + (size_t)blockIdx.x * M * NCOL + ADV;
  const double k0 = (double)col[0];
  if (blockIdx.y == 0 && threadIdx.x == 0) shift[blockIdx.x] = k0;
  Moments m{0.0, 0.0, 0.0};
  for (int base = r0 + threadIdx.x; base < r1;
       base += NORM_ITEMS * NORM_THREADS) {
    double x[NORM_ITEMS];
    int c = 0;
#pragma unroll
    for (int k = 0; k < NORM_ITEMS; ++k) {
      const int r = base + k * NORM_THREADS;
      x[k] = r < r1 ? (double)col[(size_t)r * NCOL] - k0 : 0.0;
      c += r < r1;
    }
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < NORM_ITEMS; ++k) s += x[k];
    const double mean = s / c;
    double m2 = 0.0;
#pragma unroll
    for (int k = 0; k < NORM_ITEMS; ++k) {
      const double d = x[k] - mean;
      if (k < c) m2 += d * d;
    }
    m = merge(m, Moments{(double)c, mean, m2});
  }
  __shared__ Moments warps[NORM_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  m = warp_merge(m);
  if (lane == 0) warps[w] = m;
  __syncthreads();
  if (w == 0) {
    m = warp_merge(lane < NORM_THREADS / 32 ? warps[lane]
                                            : Moments{0.0, 0.0, 0.0});
    if (lane == 0) partial[(size_t)blockIdx.x * gridDim.y + blockIdx.y] = m;
  }
}

template <typename Real>
__global__ void __launch_bounds__(NORM_THREADS) adv_norm_apply_kernel(
    Real* __restrict__ data, int M, int rows_per_block,
    const Moments* __restrict__ partial, const double* __restrict__ shift,
    Real* __restrict__ stats) {
  __shared__ Real ms[2];
  const int g = blockIdx.x;
  if (threadIdx.x < 32) {
    const Moments m = warp_merge(
        threadIdx.x < gridDim.y
            ? partial[(size_t)g * gridDim.y + threadIdx.x]
            : Moments{0.0, 0.0, 0.0});
    if (threadIdx.x == 0) {
      ms[0] = (Real)(shift[g] + m.mean);
      ms[1] = (Real)sqrt(m.m2 / m.n);
      if (blockIdx.y == 0) {
        stats[2 * g] = ms[0];
        stats[2 * g + 1] = ms[1];
      }
    }
  }
  __syncthreads();
  const Real mean = ms[0], den = ms[1] + (Real)1e-8;
  int r0, r1;
  norm_rows(M, rows_per_block, r0, r1);
  Real* col = data + (size_t)g * M * NCOL + ADV;
  for (int base = r0 + threadIdx.x; base < r1;
       base += NORM_ITEMS * NORM_THREADS) {
    Real x[NORM_ITEMS];
#pragma unroll
    for (int k = 0; k < NORM_ITEMS; ++k) {
      const int r = base + k * NORM_THREADS;
      if (r < r1) x[k] = col[(size_t)r * NCOL];
    }
#pragma unroll
    for (int k = 0; k < NORM_ITEMS; ++k) {
      const int r = base + k * NORM_THREADS;
      if (r < r1) col[(size_t)r * NCOL] = (x[k] - mean) / den;
    }
  }
}

// Blocks a group: enough to give the card NORM_WAVE blocks an SM over all
// groups, at most NORM_MAX_SPLIT and at most a group's row chunks.  The SM
// count is read once a device, by the first (eager) launch, so a graph's
// capture makes no query.
int norm_split(int groups, int M, int& split) {
  constexpr int MAX_DEVICES = 64;
  static int sm_count[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = dev < MAX_DEVICES ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) sm_count[dev] = sms;
  }
  const int chunks = (M + NORM_ITEMS * NORM_THREADS - 1)
                   / (NORM_ITEMS * NORM_THREADS);
  const int fill = (NORM_WAVE * sms + groups - 1) / groups;
  split = std::max(1, std::min({NORM_MAX_SPLIT, fill, chunks}));
  return 0;
}

template <typename Real>
int adv_norm(Real* data, int groups, int M, double* scratch, Real* stats,
             cudaStream_t st) {
  int split = 1;
  const int err = norm_split(groups, M, split);
  if (err != 0) return err;
  const int rows_per_block = (M + split - 1) / split;
  const dim3 grid(groups, split);
  Moments* partial = reinterpret_cast<Moments*>(scratch);
  double* shift = scratch + (size_t)groups * NORM_MAX_SPLIT * 3;
  adv_norm_partials_kernel<Real><<<grid, NORM_THREADS, 0, st>>>(
      data, M, rows_per_block, partial, shift);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  adv_norm_apply_kernel<Real><<<grid, NORM_THREADS, 0, st>>>(
      data, M, rows_per_block, partial, shift, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The first pass of the f32 (bf16 == 0) or bf16 variant as built: out[0]
// registers a thread, [1] local (spilled) bytes a thread, [2] static and
// [3] dynamic shared bytes a block, [4] resident blocks an SM.  Returns the
// calls' CUDA error.
int acas_ppo_grads_attrs(int bf16, int* out) {
  cudaFuncAttributes a;
  const PartialsKernel first = partials_kernel(bf16);
  cudaError_t err = set_partials_smem(bf16);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, first);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, first, THREADS, partials_smem(bf16));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)partials_smem(bf16);
  out[4] = blocks;
  return 0;
}

// Scratch floats the wrapper allocates for `partial`.
long long acas_ppo_grads_partial_floats(int P, int nblocks) {
  return (long long)P * 2 * nblocks * REC;
}

// P members: data (P, n, 13) row-major with each member's advantage column
// normalised; params (P, 9603) in the port's flat layout; partial
// (P, 2, nblocks, REC); grads (P, 9603); sums (P, 4).  nblocks blocks per
// member and tower, rows_per_block rows each; bf16 != 0 rounds the
// products' operands to bf16.  Returns the launches' cudaGetLastError().
int acas_ppo_grads(float inv_n, float eps, float lo, float hi,
                   float dvalue_scale, float log_2pi, float ent_coef,
                   const float* data, int P, int n, int rows_per_block,
                   int nblocks, int bf16, const float* params, float* partial,
                   float* grads, float* sums, void* stream) {
  const GradConsts c{inv_n, eps, lo, hi, dvalue_scale, log_2pi};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = set_partials_smem(bf16);
  if (err != cudaSuccess) return (int)err;
  const PartialsKernel first = partials_kernel(bf16);
  first<<<dim3(nblocks, 2 * P), THREADS, partials_smem(bf16), st>>>(
      c, data, n, rows_per_block, params, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = P * (2 * TOWER + NSTAT);
  grad_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      partial, P, nblocks, ent_coef, grads, sums);
  return (int)cudaGetLastError();
}

// Scratch float64s the wrapper allocates for the normalisation: the most
// a launch over `groups` groups uses (its partials, then its shifts).
long long acas_adv_norm_partial_doubles(int groups) {
  return (long long)groups * (NORM_MAX_SPLIT * 3 + 1);
}

// Normalises column 11 of each of `groups` row-major (M, 13) groups of
// `data` (float64 if f64 != 0, else float32) over its M rows, in place;
// stats (groups, 2) gets each group's mean and std.  Two launches.  Returns
// the launches' cudaGetLastError().
int acas_adv_norm(void* data, int groups, int M, int f64, double* partial,
                  void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? adv_norm((double*)data, groups, M, partial, (double*)stats, st)
             : adv_norm((float*)data, groups, M, partial, (float*)stats, st);
}

}  // extern "C"
