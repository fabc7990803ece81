// Hopper warpgroup MMA (wgmma.mma_async, sm_90a) with TF32 operands and
// float32 accumulators, as the f32 PPO-gradient first pass takes it
// (ppo_grads.cu, grad_partials_tf32x3).
//
// A warpgroup is 4 consecutive warps (128 threads) that issue one product
// of a 64-row tile together.  TF32 wgmma reads both operands K-major: B
// (N x K) always from shared memory, A (64 x K) from shared memory or from
// registers.  Shared operands here have no swizzle: a "core matrix" is
// 8 rows x 4 values (16 bytes a row), 128 contiguous bytes; core matrices
// adjacent in K lie LBO bytes apart, those adjacent in M or N SBO bytes
// apart.  One instruction takes K = 8, two core matrices deep.
//
// Accumulator (m64nN, N / 2 floats a thread): thread 32 w + 4 g + q holds
// d[4 c + 2 h + e] = D(16 w + g + 8 h, 8 c + 2 q + e).  A from registers
// (m64nNk8): a[h + 2 e] = A(16 w + g + 8 h, q + 4 e).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acas {

// Descriptor of a shared operand with no swizzle: start address, LBO and
// SBO in 16-byte units (bits 0-13, 16-29, 32-45), layout type 0 (bits
// 62-63).
__device__ __forceinline__ uint64_t wg_desc(const float* p, uint32_t lbo,
                                            uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Orders this thread's writes to shared memory before later reads of it by
// wgmma (the async proxy); a barrier then orders the other threads'.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Keeps the compiler from moving accesses of r across this point (around
// an in-flight product's accumulators).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACAS_WG_D32                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define ACAS_WG_R32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B^T, m64n64k8, A from registers; scale_d == 0 starts from zero.
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACAS_WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACAS_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= A B^T, m64n64k8, both from shared memory.
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACAS_WG_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : ACAS_WG_D32
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A B^T, m64n8k8, both from shared memory.
__device__ __forceinline__ void wg_ss_n8(float (&d)[4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef ACAS_WG_D32
#undef ACAS_WG_R32

// One k-step as 3xTF32: hi*lo, lo*hi, then hi*hi into d; first != 0
// starts d from zero.  The operands' {hi, lo} parts: A in registers (ah,
// al) or shared (dah, dal), B shared (dbh, dbl).
__device__ __forceinline__ void wg3_rs(float (&d)[32], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t dbh,
                                       uint64_t dbl, bool first) {
  wg_rs(d, ah, dbl, first ? 0 : 1);
  wg_rs(d, al, dbh, 1);
  wg_rs(d, ah, dbh, 1);
}

__device__ __forceinline__ void wg3_ss(float (&d)[32], uint64_t dah,
                                       uint64_t dal, uint64_t dbh,
                                       uint64_t dbl, bool first) {
  wg_ss(d, dah, dbl, first ? 0 : 1);
  wg_ss(d, dal, dbh, 1);
  wg_ss(d, dah, dbh, 1);
}

__device__ __forceinline__ void wg3_ss_n8(float (&d)[4], uint64_t dah,
                                          uint64_t dal, uint64_t dbh,
                                          uint64_t dbl, bool first) {
  wg_ss_n8(d, dah, dbl, first ? 0 : 1);
  wg_ss_n8(d, dal, dbh, 1);
  wg_ss_n8(d, dah, dbh, 1);
}

}  // namespace acas
