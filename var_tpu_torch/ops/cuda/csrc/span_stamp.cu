// Span stamps: the device's clock at a layer boundary inside a captured
// program (utils/profiling.py). Replaces no TPU kernel: the JAX package's
// programs are timed by XLA's profiler, and inside a CUDA graph the host runs
// nothing, so a layer's bounds can only be read on the device.
//
// One thread reads %globaltimer (ns), writes it to ring[pos mod slots] and
// advances pos. A graph replays its nodes in order, so the stamps of one
// replay land in consecutive slots and the host, which knows how many stamps
// each graph holds, knows where each replay starts without reading pos back.
// Bound: launch latency, a microsecond or two a stamp; it moves 16 bytes.

#include "common.cuh"

// C linkage: the profiler's timeline names the kernel var_span_stamp_kernel.
extern "C" __global__ void var_span_stamp_kernel(long long* __restrict__ ring,
                                                 unsigned long long* __restrict__ pos,
                                                 unsigned long long mask) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long p = *pos;
  ring[p & mask] = (long long)t;
  *pos = p + 1;
}

// slots: a power of two.
extern "C" int var_span_stamp(void* ring, void* pos, long long slots, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (slots <= 0 || (slots & (slots - 1)) != 0) return (int)cudaErrorInvalidValue;
  var_span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (unsigned long long*)pos, (unsigned long long)(slots - 1));
  return (int)cudaGetLastError();
}
