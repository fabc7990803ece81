// Operand-precision probe: one (128, 128) x (128, 128) float32 product
// computed three ways in one launch.
//
// Replaces the TPU kernel scripts/pallas_tpu_check.py:244 (_probe_kernel),
// which asks whether the target's default float32 dot already rounds its
// operands to bf16, and so whether the bf16 update kernel can differ from
// the f32 one.  Plain version: acas2d_tpu_torch/ops/precision_probe.py:
// _probe_plain.
//
// What it computes, for each output (i, j) over k = 0 .. 127:
//   o_def: a float32 fused multiply-add loop, the arithmetic of the port's
//          gradient kernel (csrc/ppo_grads.cu) on its default path;
//   o_bf:  the same loop on operands rounded to bf16 (round to nearest
//          even), the arithmetic of the gradient kernel's bf16 variant;
//   o_hi:  the products summed in float64 and rounded once at the end, the
//          counterpart of Precision.HIGHEST.
//
// What bounds it on an H100: 3 x 2 x 128^3 flop against 320 KB moved, a few
// microseconds of launch at most; the probe is about rounding, not speed.
// Design: one thread per output, 128 blocks of 128 threads; block i reads
// row i of A, thread j column j of B (coalesced across the warp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int N = 128;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(N) probe_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ o_def, float* __restrict__ o_bf,
    float* __restrict__ o_hi) {
  const int i = blockIdx.x, j = threadIdx.x;
  float s_def = 0.0f, s_bf = 0.0f;
  double s_hi = 0.0;
  for (int k = 0; k < N; ++k) {
    const float x = a[i * N + k], y = b[k * N + j];
    s_def = fmaf(x, y, s_def);
    s_bf = fmaf(bf16_round(x), bf16_round(y), s_bf);
    s_hi += (double)x * (double)y;
  }
  o_def[i * N + j] = s_def;
  o_bf[i * N + j] = s_bf;
  o_hi[i * N + j] = (float)s_hi;
}

}  // namespace

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// a, b: (128, 128) float32, row-major; o_def, o_bf, o_hi: the same.
// Returns the launch's cudaGetLastError().
int acas_precision_probe(const float* a, const float* b, float* o_def,
                         float* o_bf, float* o_hi, void* stream) {
  probe_kernel<<<N, N, 0, (cudaStream_t)stream>>>(a, b, o_def, o_bf, o_hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
