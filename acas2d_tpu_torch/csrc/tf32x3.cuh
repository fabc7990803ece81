// 3xTF32 products on the TF32 tensor cores (mma.sync.m16n8k8), shared by
// the PPO-gradient kernel (ppo_grads.cu, grad_partials_tf32x3) and the
// policy rollout (policy_rollout.cu).
//
// A float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away from zero), and a product is
// hi*lo + lo*hi + hi*hi summed in float32, which carries ~22 bits of each
// operand, close to float32 (1xTF32, hi*hi alone, would keep 11).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acas {

// Fragments of mma.sync.m16n8k8 (TF32 operands, float32 accumulators), as
// two TF32 parts each: lane = 4 g + t holds A (16 x 8) elements (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) elements (t, g),
// (t + 4, g); C (16 x 8) elements (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
struct FragA { uint32_t h[4], l[4]; };
struct FragB { uint32_t h[2], l[2]; };

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as hi = tf32(x) and lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& h, uint32_t& l) {
  h = tf32_rna(x);
  l = tf32_rna(x - __uint_as_float(h));
}

__device__ __forceinline__ float2 split_pair(float x) {
  uint32_t h, l;
  split(x, h, l);
  return make_float2(__uint_as_float(h), __uint_as_float(l));
}

// A operand, element (m, k) at p[m * sm + k * sk], split as it loads.
__device__ __forceinline__ FragA load_a(const float* p, int sm, int sk) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FragA a;
  split(p[g * sm + t * sk], a.h[0], a.l[0]);
  split(p[(g + 8) * sm + t * sk], a.h[1], a.l[1]);
  split(p[g * sm + (t + 4) * sk], a.h[2], a.l[2]);
  split(p[(g + 8) * sm + (t + 4) * sk], a.h[3], a.l[3]);
  return a;
}

// B operand, element (k, n) at p[k * sk + n * sn], split as it loads.
__device__ __forceinline__ FragB load_b(const float* p, int sk, int sn) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FragB b;
  split(p[t * sk + g * sn], b.h[0], b.l[0]);
  split(p[(t + 4) * sk + g * sn], b.h[1], b.l[1]);
  return b;
}

// B operand from a weight split once per block into {hi, lo} pairs.
__device__ __forceinline__ FragB load_w(const float2* p, int sk, int sn) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 u = p[t * sk + g * sn], v = p[(t + 4) * sk + g * sn];
  FragB b;
  b.h[0] = __float_as_uint(u.x);
  b.l[0] = __float_as_uint(u.y);
  b.h[1] = __float_as_uint(v.x);
  b.l[1] = __float_as_uint(v.y);
  return b;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.h, b.l);
  mma(c, a.l, b.h);
  mma(c, a.h, b.h);
}

// acc += tile in float32 adds (round to nearest).  The tensor cores'
// float32 accumulation does not round to nearest and drifts with the
// length of the chain (in the gradient kernel: dW2 carried through them
// over a block's 8,192 rows erred 1.8e-4 of its scale), so long sums start
// each part from zero and add the parts here.
__device__ __forceinline__ void add_tile(float (&acc)[4],
                                         const float (&tile)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += tile[i];
}

// c += a b as one 3xTF32 step that starts from zero, added to c in a
// float32 add.  Both kernels' layer-2 forward takes it: there the drift of
// the 64-long chains moves every row's value the same way, which the
// gradient kernel's value-head bias gradient (one cancelling sum over all
// rows) shows (7.7e-5 of it through the tensor cores alone, 3.7e-5 so, at
// 32,768 rows).
__device__ __forceinline__ void mma3_rn(float (&c)[4], const FragA& a,
                                        const FragB& b) {
  float z[4] = {};
  mma3(z, a, b);
  add_tile(c, z);
}

}  // namespace acas
