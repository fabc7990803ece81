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
// One body, grad_partials<BF16>, launched as two kernels.  Every product
// runs on the tensor cores (mma.sync), and the fragment layouts are PTX's,
// so the bias and tanh of a layer are applied to the accumulators in
// registers.
//   grad_partials_tf32x3 (f32): m16n8k8 TF32 as 3xTF32: each operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
//   hi*lo + lo*hi + hi*hi is summed in float32, which carries ~22 bits of
//   each operand, close to float32 (1xTF32 would keep 11).  The weights are
//   split once per block into {hi, lo} pairs in shared memory; activations
//   and errors are split as a fragment is loaded.
//   grad_partials_bf16mma (bf16, the JAX kernel's bf16=True,
//   pallas_update.py:109-127): the two operands of each of the eight
//   products (forward W1 x, W2 h1, w_head h2; backward dO h2, w_head dO,
//   e2^T h1, e2 W2, e1^T x) are rounded to bf16 (round to nearest even) and
//   the products summed in float32; biases, bias sums, the tanh derivatives
//   and the loss stay float32.  Each operand is rounded once: the weights
//   as a block loads them, x, h1, e2 and e1 as a tile builds them, into
//   bf16 copies beside the float32 tiles (which the derivatives and bias
//   sums read).  Products m16n8k16 bf16 (layer 1, K = 8: m16n8k8), one
//   term each; fragments come from the bf16 copies by ldmatrix, whose
//   .trans form reads the column-major operands (e2 and h1 in dW2, W2 in
//   e1, e1 and x in dW1) from the same row-major copy.  The head's two
//   products and w_head * dO are scalar, on rounded values.
// A block has 8 warps and walks its rows in tiles of 64; the tile's
// activations live in shared memory row-major (h1, h2 -> e2, e1; row stride
// 68 floats, 72 in bf16).  Warps 2r and 2r+1 own rows 16r..16r+15 of the
// forward, the head and loss (four lanes a row, reduced by shuffles) and
// e1, each warp 32 of the 64 features, and meet at 64-thread named
// barriers; only the cross-row products dW2 = e2^T h1 (a 16 x 32 tile a
// warp) and dW1 = e1^T x (16 x 8 over half the rows a warp) and the end of
// a tile wait for the whole block: 3 block barriers a tile.  The dW2 and
// dW1 accumulators stay in registers across the tile loop; the bias and
// head-weight sums are per-lane registers over the warp's rows.  96,288
// (f32) / 93,216 (bf16) bytes of shared memory a block, 2 blocks an SM.
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

#include "tf32x3.cuh"

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

struct GradConsts {
  float inv_n, eps, lo, hi, dvalue_scale, log_2pi;
};

using bf16 = __nv_bfloat16;

// A product operand: rounded to bf16 and back under BF16, else itself.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

constexpr int LDT = 68;  // row stride of the (T, 64) tiles: rows 4 banks
                         // apart, so a row-major fragment load (8 rows x 4
                         // columns a step) hits 32 distinct banks
constexpr int XLD = 12;  // row stride of x, likewise
constexpr int LDB = 72;  // row stride of the bf16 copies: 144 bytes, so the
                         // 8 rows of an ldmatrix hit 32 distinct banks
constexpr int VEC = 200; // b1, b2, w_head, b_head (padded to 8 floats)

// Shared memory in floats, every region a multiple of 16 bytes: weights
// (f32: W2 (64 x LDT) and W1 as {hi, lo} pairs; bf16: W2 (64 x LDB) and W1
// rounded), VEC, x (f32 [t][XLD]; bf16 [t][OBS]), h1, h2/e2, e1 (float32,
// [t][LDT]), row fields, dout, and under bf16 the copies of h1, e2, e1
// ([t][LDB]).
template <bool BF16>
struct Layout {
  static constexpr int WEIGHTS =
      BF16 ? (H * LDB + H * OBS) / 2 : 2 * H * LDT + 2 * H * OBS;
  static constexpr int X = BF16 ? T * OBS / 2 : T * XLD;
  static constexpr int FLOATS = WEIGHTS + VEC + X + 3 * T * LDT + 4 * T + T
                              + (BF16 ? 3 * T * LDB / 2 : 0);
};

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

template <bool BF16>
__device__ __forceinline__ void grad_partials(
    const GradConsts& c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  using L = Layout<BF16>;
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
  float2* w2 = reinterpret_cast<float2*>(tc);   // f32: (64, LDT), [out][in]
  float2* w1 = w2 + H * LDT;                    // f32: (64, 8)
  bf16* w2b = reinterpret_cast<bf16*>(tc);      // bf16: (64, LDB)
  bf16* w1b = w2b + H * LDB;                    // bf16: (64, 8)
  float* b1 = tc + L::WEIGHTS;
  float* b2 = b1 + H;
  float* wh = b2 + H;                // rounded under BF16
  float* bh = wh + H;
  float* xs = b1 + VEC;              // f32: [t][XLD]
  bf16* xb = reinterpret_cast<bf16*>(xs);  // bf16: [t][OBS]
  float* h1 = xs + L::X;             // [t][LDT]
  float* h2 = h1 + T * LDT;          // [t][LDT]; f32: overwritten by e2
  float* e1 = h2 + T * LDT;          // [t][LDT]
  float* rowv = e1 + T * LDT;        // act, old_logp, adv, ret: [4][T]
  float* dout = rowv + 4 * T;        // [T]
  bf16* h1b = reinterpret_cast<bf16*>(dout + T);  // bf16: [t][LDB]
  bf16* e2b = h1b + T * LDB;
  bf16* e1b = e2b + T * LDB;

  const float* tp = params + tower * TOWER;
  if constexpr (BF16) {
    for (int i = tid; i < H * H; i += THREADS)
      w2b[(i >> 6) * LDB + (i & 63)] = __float2bfloat16_rn(tp[O_W2 + i]);
    for (int i = tid; i < H * OBS; i += THREADS)
      w1b[i] = __float2bfloat16_rn(tp[i]);
  } else {
    for (int i = tid; i < H * H; i += THREADS)
      w2[(i >> 6) * LDT + (i & 63)] = split_pair(tp[O_W2 + i]);
    for (int i = tid; i < H * OBS; i += THREADS) w1[i] = split_pair(tp[i]);
  }
  if (tid < H) {
    b1[tid] = tp[O_B1 + tid];
    b2[tid] = tp[O_B2 + tid];
    wh[tid] = rnd<BF16>(tp[O_WH + tid]);
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
      if (cl < OBS) {
        if constexpr (BF16) xb[t * OBS + cl] = __float2bfloat16_rn(v);
        else xs[t * XLD + cl] = v;
      }
      else if (cl == 8) rowv[t] = v;
      else if (cl == 9) rowv[T + t] = v;
      else if (cl == 11) rowv[2 * T + t] = v;
      else if (cl == 12) rowv[3 * T + t] = v;
    }
    pair_sync(rt);
    // layer 1: h1 = tanh(x W1^T + b1), K = 8
    {
      FragA a;
      uint32_t ax[2];
      if constexpr (BF16) {
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(xb);
        ax[0] = xw[(t0 + g) * (OBS / 2) + tq];
        ax[1] = xw[(t0 + g + 8) * (OBS / 2) + tq];
      } else {
        a = load_a(xs + t0 * XLD, XLD, 1);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = c0 + 8 * q;
        float z[4] = {};
        if constexpr (BF16) {
          const uint32_t* ww = reinterpret_cast<const uint32_t*>(w1b);
          mma_bf16_k8(z, ax[0], ax[1], ww[(n0 + g) * (OBS / 2) + tq]);
        } else {
          mma3(z, a, load_w(w1 + n0 * OBS, 1, OBS));
        }
        store_c<BF16>(h1 + t0 * LDT + n0, LDT, z,
                      [&](float v, int j) { return tanhf(v + b1[n0 + j]); },
                      h1b + t0 * LDB + n0);
      }
    }
    pair_sync(rt);
    // layer 2: h2 = tanh(h1 W2^T + b2)
    {
      float z[4][4] = {};
      if constexpr (BF16) {
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
      } else {
#pragma unroll
        for (int ks = 0; ks < H / 8; ++ks) {
          const FragA a = load_a(h1 + t0 * LDT + 8 * ks, LDT, 1);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma3_rn(z[q], a,
                    load_w(w2 + (c0 + 8 * q) * LDT + 8 * ks, 1, LDT));
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
        o += wh[hq + 4 * i] * rnd<BF16>(h2[t * LDT + hq + 4 * i]);
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
        const float d = rnd<BF16>(dout[t0 + r]);
        float* p = h2 + (t0 + r) * LDT + col;
        const float hv = *p;
        sw += d * rnd<BF16>(hv);
        const float e = (w * d) * (1.0f - hv * hv);
        if constexpr (BF16) e2b[(t0 + r) * LDB + col] = __float2bfloat16_rn(e);
        else *p = e;
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
      if constexpr (BF16) {
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
      } else {
#pragma unroll
        for (int ks = 0; ks < H / 8; ++ks) {
          const FragA a = load_a(h2 + t0 * LDT + 8 * ks, LDT, 1);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma3(z[q], a, load_w(w2 + 8 * ks * LDT + c0 + 8 * q, LDT, 1));
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
      if constexpr (BF16) {
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
      } else {
#pragma unroll 2
        for (int ks = 0; ks < T / 8; ++ks) {
          const FragA a = load_a(h2 + 8 * ks * LDT + t0, 1, LDT);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma3(z[q], a, load_b(h1 + 8 * ks * LDT + c0 + 8 * q, LDT, 1));
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
        if constexpr (BF16) e1b[(t0 + r) * LDB + col] = __float2bfloat16_rn(e);
        else *p = e;
        sb += e;
      }
      g_b1 += sb;
    }
    __syncthreads();
    // dW1 += e1^T x: rows 16 (warp & 3).. over half (warp >> 2) of the rows
    {
      const int k0 = 16 * (warp & 3), tr = (warp >> 2) * (T / 2);
      float z[4] = {};
      if constexpr (BF16) {
#pragma unroll
        for (int ks = 0; ks < T / 32; ++ks) {
          uint32_t a[4], b[2];
          ldsm4_t(a, e1b + (tr + 16 * ks) * LDB + k0 + ldm_cols);
          ldsm2_t(b, xb + (tr + 16 * ks + ((lane >> 3) & 1) * 8
                           + (lane & 7)) * OBS);
          mma_bf16(z, a, b[0], b[1]);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < T / 16; ++ks)
          mma3(z, load_a(e1 + (tr + 8 * ks) * LDT + k0, 1, LDT),
               load_b(xs + (tr + 8 * ks) * XLD, XLD, 1));
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

__global__ void __launch_bounds__(THREADS, 2) grad_partials_tf32x3(
    const GradConsts c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  grad_partials<false>(c, data, n, rows_per_block, params, partial);
}

__global__ void __launch_bounds__(THREADS, 2) grad_partials_bf16mma(
    const GradConsts c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  grad_partials<true>(c, data, n, rows_per_block, params, partial);
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
  return (bf16 ? Layout<true>::FLOATS : Layout<false>::FLOATS)
         * sizeof(float);
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

}  // extern "C"
