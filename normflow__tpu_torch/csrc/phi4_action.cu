// Fused phi^4 action for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_phi4_kernel` (the action) and
// `_phi4_grad_kernel` (its VJP) of normflow__tpu/ops/kernels/phi4.py, entry
// `phi4_action_pallas`.  Plain PyTorch versions beside them:
// normflow__tpu_torch/ops/kernels/phi4.py::phi4_action_plain and
// ::phi4_action_grad_plain.
//
// Per sample: S = sum_x (w2 phi^2 + w4 phi^4) - w0 sum_{x,mu} phi_x phi_{x-mu}
// on a periodic lattice of 1-3 dims; phi_{x-mu} is the site whose mu-th
// coordinate is (c_mu - 1 mod L_mu), which is jnp.roll(phi, 1, mu).
//
// What bounds it on an H100: memory, and at the flagship's size launch
// latency.  It reads each field value once (4 MB at (1024, 32, 32), about
// 1.25 us at 3.35 TB/s) and writes 4 B per sample, with ~10 operations per
// site.  The design:
// - one block per sample, threads stride over its sites, so consecutive
//   threads read consecutive addresses; the neighbour read hits the same
//   sample's lines again, in L1;
// - the sum is taken per thread, then across the warp with shuffles, then
//   across warps in shared memory, and written once per sample: a fixed
//   order with no atomics, so the result is deterministic.
//
// The gradient is the analytic force times the per-sample cotangent g,
//   dS/dphi_x = 2 w2 phi_x + 4 w4 phi_x^3 - w0 sum_mu (phi_{x-mu} + phi_{x+mu}),
// in the Pallas kernel's order of operations.  It is elementwise and bound
// by bytes: it reads the field and g and writes the force, 8 B per site
// (4.2 MB at (512, 32, 32), about 1.25 us at 3.35 TB/s).  One thread per
// (sample, site), so reads and writes are coalesced; the neighbour
// reads hit lines that neighbouring threads of the same sample read too.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
phi4_action_kernel(const float* __restrict__ cfgs, float* __restrict__ act,
                   int V, int nd, int L0, int L1, int L2, float w0, float w2,
                   float w4) {
  const float* phi = cfgs + (long long)blockIdx.x * V;
  // row-major strides of the (up to) three lattice axes
  const int dims[3] = {L0, L1, L2};
  const int strides[3] = {L1 * L2, L2, 1};

  float acc = 0.0f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float p = __ldg(phi + i);
    const float p2 = p * p;
    float a = w2 * p2 + w4 * p2 * p2;
    if (w0 != 0.0f) {
      float neigh = 0.0f;
#pragma unroll
      for (int mu = 0; mu < 3; ++mu) {
        if (mu < nd) {
          const int c = (i / strides[mu]) % dims[mu];
          const int j = c == 0 ? i + (dims[mu] - 1) * strides[mu]
                               : i - strides[mu];
          neigh += __ldg(phi + j);
        }
      }
      a -= w0 * p * neigh;
    }
    acc += a;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) act[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
phi4_action_grad_kernel(const float* __restrict__ cfgs,
                        const float* __restrict__ g, float* __restrict__ grad,
                        long long n, int V, int nd, int L0, int L1, int L2,
                        float w0, float w2, float w4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = i / V;
  const int s = (int)(i - b * V);
  const float* phi = cfgs + b * V;
  const float p = __ldg(phi + s);
  float dv = (2.0f * w2) * p + (4.0f * w4) * (p * p) * p;
  if (w0 != 0.0f) {
    const int dims[3] = {L0, L1, L2};
    const int strides[3] = {L1 * L2, L2, 1};
    float neigh = 0.0f;
#pragma unroll
    for (int mu = 0; mu < 3; ++mu) {
      if (mu < nd) {
        const int c = (s / strides[mu]) % dims[mu];
        const int wrap = (dims[mu] - 1) * strides[mu];
        const int jm = c == 0 ? s + wrap : s - strides[mu];
        const int jp = c == dims[mu] - 1 ? s - wrap : s + strides[mu];
        neigh = neigh + __ldg(phi + jm);  // roll(phi, 1, mu)
        neigh = neigh + __ldg(phi + jp);  // roll(phi, -1, mu)
      }
    }
    dv = dv - w0 * neigh;
  }
  grad[i] = dv * __ldg(g + b);
}

}  // namespace

// cfgs (B, L0, L1, L2) float32 contiguous with nd lattice dims, the unused
// trailing extents 1; act (B,).  Returns cudaGetLastError() after the launch.
extern "C" int phi4_action_f32(const void* cfgs, void* act, long long B,
                               int nd, int L0, int L1, int L2, float w0,
                               float w2, float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2;
  if (nd < 1 || nd > 3 || B > 2147483647LL || V > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_kernel<<<(unsigned int)B, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<float*>(act), (int)V, nd, L0,
      L1, L2, w0, w2, w4);
  return (int)cudaGetLastError();
}

// cfgs and grad (B, L0, L1, L2) float32 contiguous with nd lattice dims, the
// unused trailing extents 1; g (B,).  Returns cudaGetLastError() after the
// launch.
extern "C" int phi4_action_grad_f32(const void* cfgs, const void* g,
                                    void* grad, long long B, int nd, int L0,
                                    int L1, int L2, float w0, float w2,
                                    float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2;
  const long long n = B * V;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (nd < 1 || nd > 3 || V > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_grad_kernel<<<(unsigned int)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(g),
      static_cast<float*>(grad), n, (int)V, nd, L0, L1, L2, w0, w2, w4);
  return (int)cudaGetLastError();
}
