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
// two operations each, but as written each step needs the ref of the step
// before: n dependent subtract-compare-selects.  The design takes the
// dependence out.  Number the states s = 0..n: 0 is the incoming
// reference, j + 1 means proposal j was accepted, and L_s is the state's
// logqp.  From state s the chain accepts next at
//   next(s) = 1 + min{ i >= s : lrand[i] < L_s - logqp[i] }  (n + 1: never),
// which depends on s alone, so every state's next is found at once; the
// path 0 -> next(0) -> next(next(0)) -> ... is the set of accepted states,
// found by pointer doubling.  One block of kThreads threads takes the chain
// kChunk proposals at a time:
//   1. the chunk's lrand and logqp are staged coalesced into shared memory
//      (the next chunk's loads are issued before this one is worked on);
//   2. thread t searches for next(t): first alone over kLaneTries
//      candidates (at the flagship's accept rate of about 0.65 that finds
//      nearly all), then each warp takes the states its lanes did not
//      resolve one at a time, its 32 lanes testing 32 candidates a step
//      (__ballot_sync, __ffs) to the end of the chunk;
//   3. pointer doubling with marking interleaved: J_0 = next; in round k
//      every marked state marks J_k[s] and J_{k+1}[s] = J_k[J_k[s]], two
//      ping-pong buffers, so after round k the path's first 2^(k+1) states
//      are marked; it stops once J[0] leaves the chunk (at most
//      ceil(log2(kChunk + 1)) rounds).  A state marked during a round may
//      or may not mark its own successor in that round: either way only
//      states of the path are marked;
//   4. accept[i] is the mark of state i + 1; indices[i] is the last marked
//      state <= i + 1, a block-wide max-scan by ballots (the last marked
//      lane at or below each lane, then the last warp before it with a
//      mark), both written coalesced;
//   5. the last marked state's logqp and global index carry into the next
//      chunk as its state 0, so any n >= 1 works.
// Every comparison that decides the path is the sequential chain's own:
// the same operands in the same float32 operations (built with
// --fmad=false), so the kernel gives accept_scan_plain's bits on every
// input, NaN, +-inf and ties included.  The ref is read from device memory,
// so a CUDA graph holds the launch while the ref changes between replays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = kThreads;  // proposals a chunk: one state a thread
constexpr int kLaneTries = 4;     // candidates a lane tests alone
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "the max-scan reads one warp total a lane");

__global__ void __launch_bounds__(kThreads)
accept_scan_kernel(const float* __restrict__ lrand,
                   const float* __restrict__ logqp,
                   const float* __restrict__ ref_in,
                   unsigned char* __restrict__ accept,
                   long long* __restrict__ indices, long long n) {
  __shared__ float s_lrand[kChunk];
  __shared__ float s_logqp[kChunk];
  __shared__ int s_jump[2][kChunk + 2];  // states 0..len, exit len + 1
  __shared__ unsigned char s_mark[kChunk + 2];
  __shared__ int s_last[kWarps];  // the last accepted state of each warp

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float ref = *ref_in;  // the chunk's state 0: its logqp and global index
  long long index = 0;
  float lr = 0.0f, lq = 0.0f;
  if (t < n) {
    lr = __ldg(lrand + t);
    lq = __ldg(logqp + t);
  }
  for (long long start = 0; start < n; start += kChunk) {
    const int len = (int)(n - start < kChunk ? n - start : kChunk);
    const int exit = len + 1;
    s_lrand[t] = lr;
    s_logqp[t] = lq;
    s_mark[t] = t == 0;
    if (t < 2) s_mark[kChunk + t] = 0;
    if (t < 4) s_jump[t >> 1][len + (t & 1)] = exit;
    __syncthreads();
    if (start + kChunk + t < n) {
      lr = __ldg(lrand + start + kChunk + t);
      lq = __ldg(logqp + start + kChunk + t);
    }

    // 2. next(t): alone over kLaneTries candidates, then by the warp
    const float L = t == 0 ? ref : s_logqp[t > 0 ? t - 1 : 0];
    int next = exit, i = t;
    for (int k = 0; k < kLaneTries && i < len; ++k, ++i) {
      if (s_lrand[i] < L - s_logqp[i]) {
        next = i + 1;
        break;
      }
    }
    unsigned todo = __ballot_sync(kFull, next == exit && i < len);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float Ls = __shfl_sync(kFull, L, src);
      int found = exit;
      for (int c = __shfl_sync(kFull, i, src); c < len; c += 32) {
        const int j = c + lane;
        const unsigned hits =
            __ballot_sync(kFull, j < len && s_lrand[j] < Ls - s_logqp[j]);
        if (hits) {
          found = c + __ffs(hits);  // candidate c + ffs - 1, its state + 1
          break;
        }
      }
      if (lane == src) next = found;
    }
    if (t < len) s_jump[0][t] = next;
    __syncthreads();

    // 3. pointer doubling, marking interleaved
    int cur = 0;
    while (s_jump[cur][0] != exit) {
      if (t < len) {
        const int j = s_jump[cur][t];
        if (s_mark[t]) s_mark[j] = 1;
        s_jump[cur ^ 1][t] = s_jump[cur][j];
      }
      cur ^= 1;
      __syncthreads();
    }

    // 4. accept from the marks, indices from a max-scan by ballots
    const bool a = t < len && s_mark[t + 1];
    const unsigned marks = __ballot_sync(kFull, a);
    if (lane == 0) s_last[warp] = marks ? (warp << 5) + 32 - __clz(marks) : 0;
    __syncthreads();
    const int w_last = s_last[lane];
    const unsigned warps = __ballot_sync(kFull, w_last != 0);
    const unsigned before = warps & ((1u << warp) - 1u);
    const int prior = __shfl_sync(kFull, w_last, 31 - __clz(before | 1u));
    const unsigned mine = marks & (kFull >> (31 - lane));
    const int s = mine ? (warp << 5) + 32 - __clz(mine)
                       : (before ? prior : 0);
    if (t < len) {
      accept[start + t] = a;
      indices[start + t] = s ? start + s : index;
    }

    // 5. the carry: the chunk's last accepted state
    const int end = __shfl_sync(kFull, w_last, 31 - __clz(warps | 1u));
    if (warps) {
      ref = s_logqp[end - 1];
      index = start + end;
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
