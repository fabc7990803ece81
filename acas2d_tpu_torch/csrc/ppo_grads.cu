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
// BF16 (the JAX kernel's bf16=True, pallas_update.py:109-127): the two
// operands of each of the eight products (forward W1 x, W2 h1, w_head h2;
// backward dO h2, w_head dO, e2 h1, W2^T e2, e1 x) are rounded to bf16
// (round to nearest even); the products and sums stay float32, and so do
// the bias sums, the tanh derivatives and the loss.  The weights and x
// enter only products, so they are rounded once as a tile is loaded; the
// activations and errors, which the biases and derivatives also read, are
// rounded where a product reads them.  Without BF16 the rounding is the
// identity and the code is the f32 kernel's.
//
// What bounds it on an H100: ~54,000 flop per row (forward 2 x 9,344,
// backward about twice that) against 52 bytes read per row, so operations:
// float32 on the CUDA cores here (no tensor cores, with or without BF16).
// Design: blocks run in no order, so the TPU kernel's sequential
// accumulation becomes two passes.  Pass 1: block (b, member * 2 + tower)
// takes a contiguous range of one member's rows for one tower (the
// members are independent, and so are the towers: the
// policy tower needs only the mean, the value tower only the value) and
// walks it in tiles of 64 rows.  Per tile the activations live in shared
// memory, feature-major (h1, h2 -> e2, e1); the weight gradients are small
// GEMMs over the tile's rows into per-thread register accumulators (each
// thread owns a 4x4 block of dW2, two dW1 entries and one bias / head
// entry).  Each block writes its partial sums of the 4,801 tower gradients
// and the loss sums.  Pass 2 sums the partials of every entry in block
// order: the result is deterministic, with no float atomics.  Only the real
// 64x64 blocks are computed; the TPU kernel's off-diagonal packing is not,
// so the packed path's masked gradients are exactly the flat vector.  The
// wrapper bounds the blocks of a launch (about 256 over all members), so
// the partials stay small at any population size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int LD = T + 1;    // padded row stride of the feature-major tiles
constexpr int THREADS = 256;
// shared floats: tower weights (padded to 4), x, h1, h2/e2, e1, row fields,
// dout, stat scratch
constexpr int SMEM_FLOATS = (TOWER + 3) + OBS * LD + 3 * H * LD + 4 * T + T
                          + NSTAT * T;

struct GradConsts {
  float inv_n, eps, lo, hi, dvalue_scale, log_2pi;
};

// A product operand: rounded to bf16 and back under BF16, else itself.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Tower entries that are product operands: W1, W2 and the head weight.
__device__ __forceinline__ bool is_weight(int i) {
  return i < O_B1 || (i >= O_W2 && i < O_B2) || (i >= O_WH && i < O_BH);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) grad_partials_kernel(
    const GradConsts c, const float* __restrict__ data, int n,
    int rows_per_block, const float* __restrict__ params,
    float* __restrict__ partial) {
  extern __shared__ float sm[];
  const int member = blockIdx.y >> 1;
  const int tower = blockIdx.y & 1;
  params += (size_t)member * N_PARAMS;
  data += (size_t)member * n * NCOL;
  const int tid = threadIdx.x;
  float* w1 = sm;                    // (64, 8)
  float* b1 = w1 + O_B1;
  float* w2 = w1 + O_W2;             // (64, 64), [out][in]
  float* wh = w1 + O_WH;
  float* xs = w1 + TOWER + 3;        // [f][t]
  float* h1 = xs + OBS * LD;         // [k][t]
  float* h2 = h1 + H * LD;           // [j][t]; overwritten by e2
  float* e1 = h2 + H * LD;           // [k][t]
  float* rowv = e1 + H * LD;         // act, old_logp, adv, ret: [4][T]
  float* dout = rowv + 4 * T;        // [T]
  float* stat = dout + T;            // [NSTAT][T]

  const float* tp = params + tower * TOWER;
  for (int i = tid; i < TOWER; i += THREADS)
    w1[i] = is_weight(i) ? rnd<BF16>(tp[i]) : tp[i];
  const float cls = fminf(fmaxf(params[2 * TOWER], -4.0f), 2.0f);
  const float var = expf(2.0f * cls);

  const int j0 = (tid >> 4) * 4, k0 = (tid & 15) * 4;  // dW2 block
  float a2[4][4] = {};
  float aw1[2] = {0.0f, 0.0f};  // dW1 entries tid, tid + 256
  float av = 0.0f;              // tid <64: b1, <128: b2, <192: w_head, 192: b_head
  float s_pl = 0.0f, s_vl = 0.0f, s_kl = 0.0f, s_cf = 0.0f, s_dls = 0.0f;

  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(n, r_begin + rows_per_block);
  __syncthreads();
  for (int r0 = r_begin; r0 < r_end; r0 += T) {
    const int nt = min(T, r_end - r0);
    // tile load: nt contiguous rows of 13 floats
    for (int i = tid; i < T * NCOL; i += THREADS) {
      const int t = i / NCOL, col = i - t * NCOL;
      const float v = t < nt ? data[(size_t)r0 * NCOL + i] : 0.0f;
      if (col < OBS) xs[col * LD + t] = rnd<BF16>(v);
      else if (col == 8) rowv[t] = v;
      else if (col == 9) rowv[T + t] = v;
      else if (col == 11) rowv[2 * T + t] = v;
      else if (col == 12) rowv[3 * T + t] = v;
    }
    __syncthreads();
    // layer 1: h1 = tanh(W1 x + b1)
    for (int i = tid; i < H * T; i += THREADS) {
      const int k = i / T, t = i - k * T;
      float a = 0.0f;
#pragma unroll
      for (int f = 0; f < OBS; ++f) a += w1[k * OBS + f] * xs[f * LD + t];
      h1[k * LD + t] = tanhf(a + b1[k]);
    }
    __syncthreads();
    // layer 2: h2 = tanh(W2 h1 + b2)
    for (int i = tid; i < H * T; i += THREADS) {
      const int j = i / T, t = i - j * T;
      float a = 0.0f;
#pragma unroll 16
      for (int k = 0; k < H; ++k)
        a += w2[j * H + k] * rnd<BF16>(h1[k * LD + t]);
      h2[j * LD + t] = tanhf(a + w1[O_B2 + j]);
    }
    __syncthreads();
    // head and the loss, one thread per row
    if (tid < T) {
      const int t = tid;
      float o = 0.0f;
      for (int j = 0; j < H; ++j) o += wh[j] * rnd<BF16>(h2[j * LD + t]);
      o += w1[O_BH];
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
    }
    __syncthreads();
    // head gradients, before h2 is overwritten
    if (tid >= 128 && tid < 192) {
      const int j = tid - 128;
      float s = 0.0f;
      for (int t = 0; t < T; ++t)
        s += rnd<BF16>(dout[t]) * rnd<BF16>(h2[j * LD + t]);
      av += s;
    } else if (tid == 192) {
      float s = 0.0f;
      for (int t = 0; t < T; ++t) s += dout[t];
      av += s;
    }
    __syncthreads();
    // e2 = (w_head * dout) * (1 - h2^2), in place
    for (int i = tid; i < H * T; i += THREADS) {
      const int j = i / T, t = i - j * T;
      const float hv = h2[j * LD + t];
      h2[j * LD + t] = (wh[j] * rnd<BF16>(dout[t])) * (1.0f - hv * hv);
    }
    __syncthreads();
    // dW2 += e2 h1^T over the tile's rows; b2
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      float ev[4], hv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ev[a] = rnd<BF16>(h2[(j0 + a) * LD + t]);
#pragma unroll
      for (int b = 0; b < 4; ++b) hv[b] = rnd<BF16>(h1[(k0 + b) * LD + t]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) a2[a][b] += ev[a] * hv[b];
    }
    if (tid >= 64 && tid < 128) {
      const int j = tid - 64;
      float s = 0.0f;
      for (int t = 0; t < T; ++t) s += h2[j * LD + t];
      av += s;
    }
    // e1 = (W2^T e2) * (1 - h1^2)
    for (int i = tid; i < H * T; i += THREADS) {
      const int k = i / T, t = i - k * T;
      float s = 0.0f;
#pragma unroll 16
      for (int j = 0; j < H; ++j)
        s += w2[j * H + k] * rnd<BF16>(h2[j * LD + t]);
      const float hv = h1[k * LD + t];
      e1[k * LD + t] = s * (1.0f - hv * hv);
    }
    __syncthreads();
    // dW1 += e1 x^T; b1
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS, k = idx >> 3, f = idx & 7;
      float s = 0.0f;
      for (int t = 0; t < T; ++t)
        s += rnd<BF16>(e1[k * LD + t]) * xs[f * LD + t];
      aw1[q] += s;
    }
    if (tid < 64) {
      float s = 0.0f;
      for (int t = 0; t < T; ++t) s += e1[tid * LD + t];
      av += s;
    }
    __syncthreads();
  }

  float* rec = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * REC;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) rec[O_W2 + (j0 + a) * H + k0 + b] = a2[a][b];
  rec[tid] = aw1[0];
  rec[tid + THREADS] = aw1[1];
  if (tid < 64) rec[O_B1 + tid] = av;
  else if (tid < 128) rec[O_B2 + tid - 64] = av;
  else if (tid < 192) rec[O_WH + tid - 128] = av;
  else if (tid == 192) rec[O_BH] = av;
  // loss sums: rows were owned by threads 0..T-1; fixed-order reduction
  if (tid < T) {
    stat[0 * T + tid] = s_pl;
    stat[1 * T + tid] = s_vl;
    stat[2 * T + tid] = s_kl;
    stat[3 * T + tid] = s_cf;
    stat[4 * T + tid] = s_dls;
  }
  __syncthreads();
  if (tid < NSTAT) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += stat[tid * T + t];
    rec[TOWER + tid] = s;
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

template <bool BF16>
cudaError_t launch_partials(const GradConsts& c, const float* data, int P,
                            int n, int rows_per_block, int nblocks,
                            const float* params, float* partial,
                            cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grad_partials_kernel<BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grad_partials_kernel<BF16><<<dim3(nblocks, 2 * P), THREADS, smem, stream>>>(
      c, data, n, rows_per_block, params, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
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
  cudaError_t err =
      bf16 ? launch_partials<true>(c, data, P, n, rows_per_block, nblocks,
                                   params, partial, st)
           : launch_partials<false>(c, data, P, n, rows_per_block, nblocks,
                                    params, partial, st);
  if (err != cudaSuccess) return (int)err;
  const int total = P * (2 * TOWER + NSTAT);
  grad_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      partial, P, nblocks, ent_coef, grads, sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
