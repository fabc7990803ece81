// Phase marks: one empty kernel of one thread for each boundary of a PPO
// training iteration, launched in the iteration's stream.
//
// No TPU kernel is replaced: the marks are the port's tracing.  A replayed
// iteration is one CUDA graph, which no host span can split; a mark
// launched as the iteration runs is captured into the graph with it, so
// every replay carries its four marks, and the device trace times the
// phases between them by the marks' start times.  Each boundary is a
// kernel of its own name (`extern "C"`, unmangled), so the trace tells
// them apart:
//   phase_mark_start    the iteration starts (before its rollout);
//   phase_mark_rollout  the rollout has ended;
//   phase_mark_gae      GAE has ended;
//   phase_mark_update   the epochs of minibatch steps have ended.
// A mark reads and writes nothing: it changes no tensor, and costs a
// graph node of ~2 us on the card.  Wrapper: acas2d_tpu_torch/ops/
// phase_mark.py.
#include <cuda_runtime.h>

#define PHASE_MARK(NAME)                                            \
  __global__ void phase_mark_##NAME() {}                            \
  int acas_phase_mark_##NAME(void* stream) {                        \
    phase_mark_##NAME<<<1, 1, 0, (cudaStream_t)stream>>>();         \
    return (int)cudaGetLastError();                                 \
  }

extern "C" {

const char* acas_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// each: launch the mark on `stream`; returns the launch's
// cudaGetLastError()
PHASE_MARK(start)
PHASE_MARK(rollout)
PHASE_MARK(gae)
PHASE_MARK(update)

}  // extern "C"
