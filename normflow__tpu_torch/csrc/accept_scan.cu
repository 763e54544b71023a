// The Metropolis accept/reject recurrence for Hopper (sm_90a).
//
// Replaces `_accept_scan_core` of normflow__tpu/mcmc/metropolis.py, a
// jax.lax.scan on the device (standard rule), not a Pallas kernel.  Plain
// PyTorch version beside it:
// normflow__tpu_torch/ops/kernels/accept_scan.py::accept_scan_plain.
//
// Over a chain of n proposals, with ref the logqp of the last accepted one
// (*ref_in at the start):
//   accept[i]  = lrand[i] < ref - logqp[i]
//   ref        = accept[i] ? logqp[i] : ref
//   indices[i] = index of the last accepted proposal + 1 (0: none yet, the
//                incoming reference).
// The comparison is float32, written as in the plain version, so the two
// give the same bits; a NaN compares false, log u = -inf accepts.
//
// What bounds it on an H100: latency, not bytes or operations.  It moves 17
// bytes per proposal (17 KB at n = 1024, about 5 ns at 3.35 TB/s) and does
// two operations each, but each step needs the ref of the step before: a
// dependent chain of n subtract-compare-selects on one thread.  Design: one
// block of kThreads threads.  The block stages kChunk proposals' lrand and
// logqp into shared memory with coalesced loads, thread 0 runs the chain
// over shared memory (ref and the running index stay in its registers from
// chunk to chunk, so any n >= 1 works), and the block writes accept and
// indices back coalesced.  The ref is read from device memory, so a CUDA
// graph can hold the launch while the ref changes from replay to replay.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // 17 bytes each in shared memory: 34,816 B

__global__ void __launch_bounds__(kThreads)
accept_scan_kernel(const float* __restrict__ lrand,
                   const float* __restrict__ logqp,
                   const float* __restrict__ ref_in,
                   unsigned char* __restrict__ accept,
                   long long* __restrict__ indices, long long n) {
  __shared__ float s_lrand[kChunk];
  __shared__ float s_logqp[kChunk];
  __shared__ long long s_index[kChunk];
  __shared__ unsigned char s_accept[kChunk];

  float ref = 0.0f;
  long long index = 0;
  if (threadIdx.x == 0) ref = *ref_in;
  for (long long start = 0; start < n; start += kChunk) {
    const int len = (int)(n - start < kChunk ? n - start : kChunk);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      s_lrand[i] = __ldg(lrand + start + i);
      s_logqp[i] = __ldg(logqp + start + i);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const float lq = s_logqp[i];
        const bool a = s_lrand[i] < ref - lq;
        ref = a ? lq : ref;
        index = a ? start + i + 1 : index;
        s_accept[i] = a;
        s_index[i] = index;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      accept[start + i] = s_accept[i];
      indices[start + i] = s_index[i];
    }
    __syncthreads();  // the next chunk overwrites the stage
  }
}

}  // namespace

// lrand, logqp: (n,) float32; ref: one float32 on the device; accept: (n,)
// bool (one byte each); indices: (n,) int64.  n >= 1.
extern "C" int accept_scan_f32(const void* lrand, const void* logqp,
                               const void* ref, void* accept, void* indices,
                               long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  accept_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lrand), static_cast<const float*>(logqp),
      static_cast<const float*>(ref), static_cast<unsigned char*>(accept),
      static_cast<long long*>(indices), n);
  return (int)cudaGetLastError();
}
