// Fused phi^4 action for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_phi4_kernel` (the action) and
// `_phi4_grad_kernel` (its VJP) of normflow__tpu/ops/kernels/phi4.py, entry
// `phi4_action_pallas`.  Plain PyTorch versions beside them:
// normflow__tpu_torch/ops/kernels/phi4.py::phi4_action_plain and
// ::phi4_action_grad_plain.
//
// Per sample: S = sum_x (w2 phi^2 + w4 phi^4) - w0 sum_{x,mu} phi_x phi_{x-mu}
// on a periodic lattice of 1-4 dims; phi_{x-mu} is the site whose mu-th
// coordinate is (c_mu - 1 mod L_mu), which is jnp.roll(phi, 1, mu).
//
// What bounds it on an H100: memory, and at the flagship's size latency.
// It reads each field value once (4 MB at (1024, 32, 32), about 1.25 us at
// 3.35 TB/s) and writes 4 B per sample, with ~10 operations per site.
// Three variants, chosen by the wrapper by shape and alignment:
// - the tiled kernel (phi4_action_tiled_f32, the 2-D flagship's) for 2-D
//   lattices whose rows split into float4s: one 16-byte load per thread
//   into shared memory, the neighbours from there and from the thread's own
//   registers, no division per site (notes at the kernel);
// - the tiled nd kernel (phi4_action_tiled_nd_f32, the 8^4 flagship's) for
//   3-D and 4-D lattices whose last axis splits into float4s and whose
//   sample is a whole number of warps of float4s up to 1024: the 2-D
//   tile's scheme with more axes, persistent blocks over samples, each
//   sample bulk-loaded whole into a ring in shared memory while the block
//   computes the one before (8^4: 16.8 MB at B = 1024, about 5 us at
//   3.35 TB/s; notes at the kernel);
// - the general kernel (phi4_action_f32) for every other lattice of 1-4
//   dims: one block per sample, threads stride over its sites, the
//   neighbour's index from a division and a modulo per dimension (issue-
//   bound on that arithmetic: 0.11 of the byte bound at (1024, 8^4)); a
//   field of fewer dims passes its missing trailing extents as 1 and runs
//   the loop over its own dims only, so it gives the bits it gave before
//   the fourth extent was added.
// Both sum per thread, then across the warp with shuffles, then across
// warps in shared memory, and write once per sample: a fixed order with no
// atomics, so the result is deterministic.

// The gradient is the analytic force times the per-sample cotangent g,
//   dS/dphi_x = 2 w2 phi_x + 4 w4 phi_x^3 - w0 sum_mu (phi_{x-mu} + phi_{x+mu}),
// in the Pallas kernel's order of operations.  It is elementwise and bound
// by bytes: it reads the field and g and writes the force, 8 B per site
// (4.2 MB at (512, 32, 32), about 1.25 us at 3.35 TB/s).  Two variants,
// chosen by the wrapper by the action's rule, applied to the field and the
// force:
// - the tiled kernel (phi4_action_grad_tiled_f32, the 2-D flagship's): the
//   tiled action's blocks and float4 staging, each thread's four forces
//   leaving as one 16-byte store, no division per site;
// - the tiled nd kernel (phi4_action_grad_tiled_nd_f32, the 8^4
//   flagship's): the tiled nd action's blocks and ring, g[b] read once a
//   sample, each thread's four forces one 16-byte store;
// - the general kernel (phi4_action_grad_f32): one thread per (sample,
//   site), reads and writes coalesced, the neighbours' indices from a
//   division and a modulo per dimension.
// The three sum each site's neighbours in the same order and return the
// same bits.
//
// The slab variants (phi4_action_slab_f32, phi4_action_slab_tiled_f32,
// phi4_action_slab_tiled_nd_f32, phi4_action_grad_slab_f32,
// phi4_action_grad_slab_tiled_f32, phi4_action_grad_slab_tiled_nd_f32) are
// what the two become under lattice (space) sharding, normflow__tpu_torch/
// parallel/space.py: the field is a rank's slab (B, l0, L1, L2, L3) of each
// sample's rows and `halo` (B, 2, L1, L2, L3) holds the row before the slab
// and the row after it.  Along the first axis nothing wraps: a neighbour
// across the slab's first row comes from halo row 0, across its last row
// (the force only) from halo row 1; the other axes stay periodic.  They port
// no Pallas kernel of their own (the JAX package's sharded action is XLA's
// roll with the partitioner's halos) and share the whole-lattice kernels'
// bodies, instantiated with kSlab = true, so each does the same work per
// site and reads one more row per sample (the action) or two (the force);
// the bounds are those above.  The three variants are the whole lattice's,
// by the same rules on the slab's extents: the 2-D tile, the tiled nd
// kernels at 3-D and 4-D (whose ring stage holds the halo rows around the
// slab's, notes at the kernel), the general kernels otherwise.  Plain
// versions: normflow__tpu_torch/ops/kernels/phi4.py::phi4_action_slab_plain
// and ::phi4_action_slab_grad_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;

// One block per sample; on a slab (kSlab) the backward neighbour across
// row 0 comes from halo row 0 (the site's offset in its row, i < L1 L2 L3).
template <bool kSlab>
__device__ __forceinline__ void action_general(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    float* __restrict__ act, int V, int nd, int L0, int L1, int L2, int L3,
    float w0, float w2, float w4) {
  const float* phi = cfgs + (long long)blockIdx.x * V;
  // row-major strides of the (up to) four lattice axes
  const int dims[4] = {L0, L1, L2, L3};
  const int strides[4] = {L1 * L2 * L3, L2 * L3, L3, 1};
  const float* before =
      kSlab ? halo + (long long)blockIdx.x * 2 * strides[0] : nullptr;

  float acc = 0.0f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float p = __ldg(phi + i);
    const float p2 = p * p;
    float a = w2 * p2 + w4 * p2 * p2;
    if (w0 != 0.0f) {
      float neigh = 0.0f;
#pragma unroll
      for (int mu = 0; mu < 4; ++mu) {
        if (mu < nd) {
          const int c = (i / strides[mu]) % dims[mu];
          if (kSlab && mu == 0 && c == 0) {
            neigh += __ldg(before + i);
          } else {
            const int j = c == 0 ? i + (dims[mu] - 1) * strides[mu]
                                 : i - strides[mu];
            neigh += __ldg(phi + j);
          }
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
phi4_action_kernel(const float* __restrict__ cfgs, float* __restrict__ act,
                   int V, int nd, int L0, int L1, int L2, int L3, float w0,
                   float w2, float w4) {
  action_general<false>(cfgs, nullptr, act, V, nd, L0, L1, L2, L3, w0, w2,
                        w4);
}

__global__ void __launch_bounds__(kThreads)
phi4_action_slab_kernel(const float* __restrict__ cfgs,
                        const float* __restrict__ halo,
                        float* __restrict__ act, int V, int nd, int L0,
                        int L1, int L2, int L3, float w0, float w2,
                        float w4) {
  action_general<true>(cfgs, halo, act, V, nd, L0, L1, L2, L3, w0, w2, w4);
}

// One thread per (sample, site); on a slab (kSlab) the neighbours across
// row 0 and row L0 - 1 come from halo rows 0 and 1.
template <bool kSlab>
__device__ __forceinline__ void grad_general(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    const float* __restrict__ g, float* __restrict__ grad, long long n, int V,
    int nd, int L0, int L1, int L2, int L3, float w0, float w2, float w4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = i / V;
  const int s = (int)(i - b * V);
  const float* phi = cfgs + b * V;
  const float p = __ldg(phi + s);
  float dv = (2.0f * w2) * p + (4.0f * w4) * (p * p) * p;
  if (w0 != 0.0f) {
    const int dims[4] = {L0, L1, L2, L3};
    const int strides[4] = {L1 * L2 * L3, L2 * L3, L3, 1};
    float neigh = 0.0f;
#pragma unroll
    for (int mu = 0; mu < 4; ++mu) {
      if (mu < nd) {
        const int c = (s / strides[mu]) % dims[mu];
        const int wrap = (dims[mu] - 1) * strides[mu];
        float down, up;
        if (kSlab && mu == 0) {
          const float* rows = halo + b * 2 * strides[0];
          down = c == 0 ? __ldg(rows + s) : __ldg(phi + s - strides[0]);
          up = c == dims[0] - 1 ? __ldg(rows + strides[0] + s - wrap)
                                : __ldg(phi + s + strides[0]);
        } else {
          const int jm = c == 0 ? s + wrap : s - strides[mu];
          const int jp = c == dims[mu] - 1 ? s - wrap : s + strides[mu];
          down = __ldg(phi + jm);
          up = __ldg(phi + jp);
        }
        neigh = neigh + down;  // roll(phi, 1, mu)
        neigh = neigh + up;    // roll(phi, -1, mu)
      }
    }
    dv = dv - w0 * neigh;
  }
  grad[i] = dv * __ldg(g + b);
}

__global__ void __launch_bounds__(kThreads)
phi4_action_grad_kernel(const float* __restrict__ cfgs,
                        const float* __restrict__ g, float* __restrict__ grad,
                        long long n, int V, int nd, int L0, int L1, int L2,
                        int L3, float w0, float w2, float w4) {
  grad_general<false>(cfgs, nullptr, g, grad, n, V, nd, L0, L1, L2, L3, w0,
                      w2, w4);
}

__global__ void __launch_bounds__(kThreads)
phi4_action_grad_slab_kernel(const float* __restrict__ cfgs,
                             const float* __restrict__ halo,
                             const float* __restrict__ g,
                             float* __restrict__ grad, long long n, int V,
                             int nd, int L0, int L1, int L2, int L3,
                             float w0, float w2, float w4) {
  grad_general<true>(cfgs, halo, g, grad, n, V, nd, L0, L1, L2, L3, w0, w2,
                     w4);
}

// The tiled action for 2-D lattices with L1 % 4 == 0 and L0 * L1 / 4 a
// multiple of 32, at most 1024: a block of (L0 L1 / 4, P) threads takes P
// samples; thread (g, p) loads sites 4g..4g+3 of sample p as one float4
// (row r = g / (L1/4), columns c..c+3) into shared memory, then takes the
// up neighbours (row r-1) as one float4 and the left neighbour of column c
// as one float from there, the other three left neighbours from its own
// registers.  Per site the terms are those of phi4_action_kernel in its
// order; the thread's four sites are summed in order, then the warp's by
// shuffles, then each sample's warps by its first warp.
// On a slab (kSlab) the up neighbours of row 0 come from halo row 0, one
// float4 per thread of that row (16-byte aligned: L1 % 4 == 0).
template <bool kSlab>
__device__ __forceinline__ void action_tiled(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    float* __restrict__ act, long long B, int L0, int L1, float w0, float w2,
    float w4) {
  const int G = blockDim.x;  // float4 groups per sample
  const int g = threadIdx.x;
  const int p = threadIdx.y;
  const long long b = (long long)blockIdx.x * blockDim.y + p;
  float4* field = reinterpret_cast<float4*>(dynamic_smem()) + p * G;
  const float* f = reinterpret_cast<const float*>(field);

  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (b < B) v = __ldg(reinterpret_cast<const float4*>(cfgs) + b * G + g);
  field[g] = v;
  __syncthreads();

  const int q = L1 >> 2;
  const int r = g / q;
  const int c = (g - r * q) << 2;
  const float sites[4] = {v.x, v.y, v.z, v.w};
  float ups[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float lefts[4] = {0.0f, v.x, v.y, v.z};
  if (w0 != 0.0f) {
    float4 u;
    if (kSlab && r == 0) {
      u = b < B ? __ldg(reinterpret_cast<const float4*>(halo) + b * 2 * q +
                        (c >> 2))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      u = reinterpret_cast<const float4*>(
          f + (r == 0 ? L0 - 1 : r - 1) * L1)[c >> 2];
    }
    ups[0] = u.x;
    ups[1] = u.y;
    ups[2] = u.z;
    ups[3] = u.w;
    lefts[0] = f[r * L1 + (c == 0 ? L1 - 1 : c - 1)];
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ph = sites[k];
    const float p2 = ph * ph;
    float a = w2 * p2 + w4 * p2 * p2;
    if (w0 != 0.0f) {
      float neigh = 0.0f;
      neigh += ups[k];
      neigh += lefts[k];
      a -= w0 * ph * neigh;
    }
    acc += a;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[32];
  const int warps = G >> 5;  // per sample
  const int lane = g & 31;
  const int warp = g >> 5;
  if (lane == 0) warp_sums[p * warps + warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < warps ? warp_sums[p * warps + lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0 && b < B) act[b] = acc;
  }
}

__global__ void __launch_bounds__(1024)
phi4_action_tiled_kernel(const float* __restrict__ cfgs,
                         float* __restrict__ act, long long B, int L0,
                         int L1, float w0, float w2, float w4) {
  action_tiled<false>(cfgs, nullptr, act, B, L0, L1, w0, w2, w4);
}

__global__ void __launch_bounds__(1024)
phi4_action_slab_tiled_kernel(const float* __restrict__ cfgs,
                              const float* __restrict__ halo,
                              float* __restrict__ act, long long B, int L0,
                              int L1, float w0, float w2, float w4) {
  action_tiled<true>(cfgs, halo, act, B, L0, L1, w0, w2, w4);
}

// The tiled force, on the tiled action's lattices and blocks: thread
// (g, p) loads sites 4g..4g+3 of sample p (row r, columns c..c+3) as one
// float4 into shared memory, then takes the rows above and below as
// float4s and the left neighbour of column c and the right neighbour of
// column c+3 as one float each from there, the other six neighbours from
// its own registers; it reads g[b] once and stores its four forces as one
// float4.  Per site the terms are those of phi4_action_grad_kernel in its
// order: 0 + phi[x-e0] + phi[x+e0] + phi[x-e1] + phi[x+e1].
// On a slab (kSlab) the rows above row 0 and below row L0 - 1 come from
// halo rows 0 and 1, one float4 per thread.
template <bool kSlab>
__device__ __forceinline__ void grad_tiled(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    const float* __restrict__ g, float* __restrict__ grad, long long B,
    int L0, int L1, float w0, float w2, float w4) {
  const int G = blockDim.x;  // float4 groups per sample
  const int gr = threadIdx.x;
  const int p = threadIdx.y;
  const long long b = (long long)blockIdx.x * blockDim.y + p;
  float4* field = reinterpret_cast<float4*>(dynamic_smem()) + p * G;
  const float* f = reinterpret_cast<const float*>(field);

  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (b < B) v = __ldg(reinterpret_cast<const float4*>(cfgs) + b * G + gr);
  field[gr] = v;
  __syncthreads();
  if (b >= B) return;

  const int q = L1 >> 2;
  const int r = gr / q;
  const int c = (gr - r * q) << 2;
  const float sites[4] = {v.x, v.y, v.z, v.w};
  float force[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ph = sites[k];
    force[k] = (2.0f * w2) * ph + (4.0f * w4) * (ph * ph) * ph;
  }
  if (w0 != 0.0f) {
    const float4* rows = reinterpret_cast<const float4*>(halo) + b * 2 * q;
    const float4 u =
        kSlab && r == 0
            ? __ldg(rows + (c >> 2))
            : reinterpret_cast<const float4*>(
                  f + (r == 0 ? L0 - 1 : r - 1) * L1)[c >> 2];
    const float4 d =
        kSlab && r == L0 - 1
            ? __ldg(rows + q + (c >> 2))
            : reinterpret_cast<const float4*>(
                  f + (r == L0 - 1 ? 0 : r + 1) * L1)[c >> 2];
    const float ups[4] = {u.x, u.y, u.z, u.w};
    const float downs[4] = {d.x, d.y, d.z, d.w};
    const float lefts[4] = {f[r * L1 + (c == 0 ? L1 - 1 : c - 1)], v.x, v.y,
                            v.z};
    const float rights[4] = {v.y, v.z, v.w,
                             f[r * L1 + (c + 4 == L1 ? 0 : c + 4)]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float neigh = 0.0f;
      neigh = neigh + ups[k];     // roll(phi, 1, 0)
      neigh = neigh + downs[k];   // roll(phi, -1, 0)
      neigh = neigh + lefts[k];   // roll(phi, 1, 1)
      neigh = neigh + rights[k];  // roll(phi, -1, 1)
      force[k] = force[k] - w0 * neigh;
    }
  }
  const float gb = __ldg(g + b);
  reinterpret_cast<float4*>(grad)[b * G + gr] =
      make_float4(force[0] * gb, force[1] * gb, force[2] * gb, force[3] * gb);
}

__global__ void __launch_bounds__(1024)
phi4_action_grad_tiled_kernel(const float* __restrict__ cfgs,
                              const float* __restrict__ g,
                              float* __restrict__ grad, long long B, int L0,
                              int L1, float w0, float w2, float w4) {
  grad_tiled<false>(cfgs, nullptr, g, grad, B, L0, L1, w0, w2, w4);
}

__global__ void __launch_bounds__(1024)
phi4_action_grad_slab_tiled_kernel(const float* __restrict__ cfgs,
                                   const float* __restrict__ halo,
                                   const float* __restrict__ g,
                                   float* __restrict__ grad, long long B,
                                   int L0, int L1, float w0, float w2,
                                   float w4) {
  grad_tiled<true>(cfgs, halo, g, grad, B, L0, L1, w0, w2, w4);
}

// The tiled action and force on 3-D and 4-D lattices (ND lattice dims),
// whose last extent is a multiple of 4 and whose G = V / 4 float4 groups a
// sample are a whole number of warps, at most kNdMaxGroups.  A block of T
// threads takes a sample at a time, persistent over samples (block k takes
// samples k, k + gridDim.x, ...); a ring of kNdStages stages in dynamic
// shared memory holds whole samples: warp 0 bulk-loads the next samples
// into the free stages (one mbarrier each) while the block computes the
// current one.
//
// T is the smallest multiple of axis 0's float4 stride s0 = G / L0 that is
// a whole number of warps, divides G and holds at least kNdThreads threads
// (or G): thread t takes the groups t, t + T, ..., G / T of them, which
// share every coordinate but the first, j = T / s0 apart.  So each thread
// works out its first group's coordinates once, before the loop: the group
// g = ((c0 L1 + c1) L2 + c2) q + cq at 4-D (q = L_{ND-1} / 4 groups a row
// of the last axis), and from them the offsets of its neighbour groups
// along axes 1 .. ND-2 (float4 strides q, q L_{ND-2}, ..., with the wrap)
// and of the sites left of its first site and right of its last one in its
// row, the same for all its groups; along axis 0 a group's neighbours are
// s0 away, its wrap tested on c0 + m j.  Per sample it reads each group's
// float4 and the neighbour float4s from the stage, the last axis's inner
// neighbours from its own registers, with no division.  At 8^4 (G = 1024,
// s0 = 128) a block is 256 threads of 4 groups: several blocks share an
// SM, so one block's wait, reduction and barrier overlap the others' work.
// Designs timed on an H100 (tools/const_sweep.py over the constants below,
// PERF.md): a block of G threads, a group each, held one block an SM (46
// and 64 registers) and reached 0.32 and 0.54 of the byte bound (action at
// (1024, 8^4), force at (512, 8^4)), with a ring of 2, 3 or 4 stages alike
// and 0.43 at 32 registers; 256 threads of 4 groups reach 0.60 and 0.76,
// 128 and 512 threads less, a ring of 1 stage or 32 registers less too,
// the groups' loop unrolled or not alike (kept rolled: its SASS is one
// group's).
//
// On a slab (kSlab; the slab's l0 rows are the tile's L0) the halo lives in
// the ring: a stage holds halo row 0, then the slab's l0 rows, then halo
// row 1, contiguous, so a site's axis-0 neighbours are always s0 float4s
// before and after it, with no wrap and no branch; the general slab
// kernels' division, modulo and branch per axis and site are gone.  The
// action loads halo row 0 only, the force both: one or two more bulk
// copies a sample, from the (B, 2, *rest) halo tensor.  At (4, 8, 8, 8)
// (G = 512, s0 = 128) a block is 256 threads of 2 groups; the three rows a
// rank holds of 8 rows over three ranks, (3, 8, 8, 8), make blocks of 384
// threads, a group each.
//
// Per site the terms are those of the general kernels in their order: the
// action's w2 p^2 + w4 p^4 - w0 p (0 + phi[x-e0] + ... + phi[x-e_{ND-1}]),
// the force's (2 w2) p + (4 w4)(p p) p - w0 (0 + phi[x-e0] + phi[x+e0] +
// ... + phi[x+e_{ND-1}]) times g[b], so the force has the general force's
// bits (the slab force the general slab force's).  The action sums each
// thread's sites in order, then the warp's by shuffles, then the block's
// warps by warp 0: a fixed order, no atomics.
constexpr int kNdStages = 2;        // samples in flight per block
constexpr int kNdMaxGroups = 1024;  // float4 groups a sample
constexpr int kNdThreads = 256;     // threads a block, at least (or G)
constexpr int kNdMinBlocks = 1;     // blocks of 1024 threads per SM asked
constexpr int kNdUnroll = 1;        // a thread's groups unrolled

// a lattice the tiled nd kernels take, L[ND-1] % 4 == 0, the unused
// trailing extent 1: G float4 groups a sample, T threads a block, axis 0's
// float4 stride s0, the step j = T / s0 in c0 between a thread's groups and
// the float4s of a ring stage (G; on a slab G + 2 s0, the halo rows around
// the slab's)
struct NdTile {
  int L[4], G, T, s0, j, stage;
};

// What a thread's groups share: the first one's coordinate on axis 0, the
// offsets of the neighbour groups along axes 1 .. ND-2 and of the sites
// left of a group's first site and right of its last.
template <int ND>
struct NdSite {
  int c0, dn[ND - 2], up[ND - 2], left, right;
};

template <int ND>
__device__ __forceinline__ NdSite<ND> nd_site(const NdTile& t, int gi) {
  NdSite<ND> s;
  const int L = t.L[ND - 1];
  const int q = L >> 2;
  int rest = gi / q;
  const int cq = gi - rest * q;
  int stride = q;
#pragma unroll
  for (int mu = ND - 2; mu >= 1; --mu) {
    const int next = rest / t.L[mu];
    const int c = rest - next * t.L[mu];
    const int wrap = (t.L[mu] - 1) * stride;
    s.dn[mu - 1] = c == 0 ? wrap : -stride;
    s.up[mu - 1] = c == t.L[mu] - 1 ? -wrap : stride;
    rest = next;
    stride *= t.L[mu];
  }
  s.c0 = rest;
  s.left = cq == 0 ? L - 1 : -1;
  s.right = cq == q - 1 ? 4 - L : 4;
  return s;
}

// Warp 0 fills stage `st` with sample b: lane 0 arms the barrier with the
// stage's bytes, each lane copies its 1/32 of the sample (G % 32 == 0, so
// each part is a whole number of 16-byte float4s).  With kHalo halo rows (a
// slab's) the sample goes s0 float4s into the stage, lane 0 copies halo row
// 0 before it and, with kHalo == 2, lane 1 halo row 1 after it.
template <int kHalo>
__device__ __forceinline__ void nd_load(const float* __restrict__ cfgs,
                                        const float* __restrict__ halo,
                                        float4* ring, uint64_t* full,
                                        long long b, int st,
                                        const NdTile& t) {
  const int lane = threadIdx.x & 31;
  const uint32_t part = (uint32_t)t.G / 32;  // float4s a lane copies
  float4* stage = ring + st * t.stage;
  if (lane == 0)
    mbar_arrive_expect_tx(&full[st],
                          (uint32_t)(t.G + kHalo * t.s0) * sizeof(float4));
  __syncwarp();
  bulk_load(stage + (kHalo ? t.s0 : 0) + lane * part,
            reinterpret_cast<const float4*>(cfgs) + b * t.G + lane * part,
            part * sizeof(float4), &full[st]);
  if (kHalo && lane < kHalo)
    bulk_load(stage + lane * (t.s0 + t.G),
              reinterpret_cast<const float4*>(halo) + (b * 2 + lane) * t.s0,
              (uint32_t)t.s0 * sizeof(float4), &full[st]);
}

// The barriers, then warp 0 loads the block's first kNdStages samples.
template <int kHalo>
__device__ __forceinline__ void nd_start(const float* __restrict__ cfgs,
                                         const float* __restrict__ halo,
                                         float4* ring, uint64_t* full,
                                         long long B, const NdTile& t) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kNdStages; ++st) mbar_init(&full[st], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int st = 0; st < kNdStages; ++st) {
      const long long b = blockIdx.x + (long long)st * gridDim.x;
      if (b < B) nd_load<kHalo>(cfgs, halo, ring, full, b, st, t);
    }
  }
}

template <int ND, bool kSlab>
__device__ __forceinline__ void action_tiled_nd(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    float* __restrict__ act, long long B, const NdTile& t, float w0,
    float w2, float w4) {
  constexpr int kHalo = kSlab ? 1 : 0;
  const int gi = threadIdx.x;
  const int lane = gi & 31;
  const int warp = gi >> 5;
  const int wrap0 = (t.L[0] - 1) * t.s0;
  float4* ring = reinterpret_cast<float4*>(dynamic_smem());
  __shared__ uint64_t full[kNdStages];
  __shared__ float sums[2][32];  // by parity of the iteration
  const NdSite<ND> s = nd_site<ND>(t, gi);
  nd_start<kHalo>(cfgs, halo, ring, full, B, t);

  int st = 0, it = 0;
  uint32_t parity = 0;
  for (long long b = blockIdx.x; b < B; b += gridDim.x, ++it) {
    // the sample's first float4; on a slab halo row 0 is the s0 before it
    const float4* f4 = ring + st * t.stage + (kSlab ? t.s0 : 0);
    const float* f = reinterpret_cast<const float*>(f4);
    mbar_wait(&full[st], parity);
    float acc = 0.0f;
#pragma unroll (kNdUnroll)
    for (int g = gi, c0 = s.c0; g < t.G; g += t.T, c0 += t.j) {
      const float4 v = f4[g];
      const float sites[4] = {v.x, v.y, v.z, v.w};
      float neigh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (w0 != 0.0f) {
        const float4 d =
            f4[kSlab ? g - t.s0 : c0 == 0 ? g + wrap0 : g - t.s0];
        neigh[0] += d.x;
        neigh[1] += d.y;
        neigh[2] += d.z;
        neigh[3] += d.w;
#pragma unroll
        for (int mu = 0; mu < ND - 2; ++mu) {
          const float4 u = f4[g + s.dn[mu]];
          neigh[0] += u.x;
          neigh[1] += u.y;
          neigh[2] += u.z;
          neigh[3] += u.w;
        }
        neigh[0] += f[4 * g + s.left];
        neigh[1] += v.x;
        neigh[2] += v.y;
        neigh[3] += v.z;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ph = sites[k];
        const float p2 = ph * ph;
        float a = w2 * p2 + w4 * p2 * p2;
        if (w0 != 0.0f) a -= w0 * ph * neigh[k];
        acc += a;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) sums[it & 1][warp] = acc;
    __syncthreads();  // the stage is read; the warps' sums are written
    if (warp == 0) {
      const long long next = b + (long long)kNdStages * gridDim.x;
      if (next < B) nd_load<kHalo>(cfgs, halo, ring, full, next, st, t);
      acc = lane < (t.T >> 5) ? sums[it & 1][lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) act[b] = acc;
    }
    if (++st == kNdStages) {
      st = 0;
      parity ^= 1u;
    }
  }
}

template <int ND, bool kSlab>
__device__ __forceinline__ void grad_tiled_nd(
    const float* __restrict__ cfgs, const float* __restrict__ halo,
    const float* __restrict__ g, float* __restrict__ grad, long long B,
    const NdTile& t, float w0, float w2, float w4) {
  constexpr int kHalo = kSlab ? 2 : 0;
  const int gi = threadIdx.x;
  const int wrap0 = (t.L[0] - 1) * t.s0;
  float4* ring = reinterpret_cast<float4*>(dynamic_smem());
  __shared__ uint64_t full[kNdStages];
  const NdSite<ND> s = nd_site<ND>(t, gi);
  nd_start<kHalo>(cfgs, halo, ring, full, B, t);

  int st = 0;
  uint32_t parity = 0;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    // the sample's first float4; on a slab the halo rows are the s0
    // before it and the s0 after its last
    const float4* f4 = ring + st * t.stage + (kSlab ? t.s0 : 0);
    const float* f = reinterpret_cast<const float*>(f4);
    float4* out = reinterpret_cast<float4*>(grad) + b * t.G;
    const float gb = __ldg(g + b);
    mbar_wait(&full[st], parity);
#pragma unroll (kNdUnroll)
    for (int gr = gi, c0 = s.c0; gr < t.G; gr += t.T, c0 += t.j) {
      const float4 v = f4[gr];
      const float sites[4] = {v.x, v.y, v.z, v.w};
      float force[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ph = sites[k];
        force[k] = (2.0f * w2) * ph + (4.0f * w4) * (ph * ph) * ph;
      }
      if (w0 != 0.0f) {
        const float4 d =
            f4[kSlab ? gr - t.s0 : c0 == 0 ? gr + wrap0 : gr - t.s0];
        const float4 u =
            f4[kSlab ? gr + t.s0 : c0 == t.L[0] - 1 ? gr - wrap0 : gr + t.s0];
        float neigh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        neigh[0] = neigh[0] + d.x;  // roll(phi, 1, 0)
        neigh[0] = neigh[0] + u.x;  // roll(phi, -1, 0)
        neigh[1] = neigh[1] + d.y;
        neigh[1] = neigh[1] + u.y;
        neigh[2] = neigh[2] + d.z;
        neigh[2] = neigh[2] + u.z;
        neigh[3] = neigh[3] + d.w;
        neigh[3] = neigh[3] + u.w;
#pragma unroll
        for (int mu = 0; mu < ND - 2; ++mu) {
          const float4 dm = f4[gr + s.dn[mu]];
          const float4 um = f4[gr + s.up[mu]];
          neigh[0] = neigh[0] + dm.x;
          neigh[0] = neigh[0] + um.x;
          neigh[1] = neigh[1] + dm.y;
          neigh[1] = neigh[1] + um.y;
          neigh[2] = neigh[2] + dm.z;
          neigh[2] = neigh[2] + um.z;
          neigh[3] = neigh[3] + dm.w;
          neigh[3] = neigh[3] + um.w;
        }
        const float lefts[4] = {f[4 * gr + s.left], v.x, v.y, v.z};
        const float rights[4] = {v.y, v.z, v.w, f[4 * gr + s.right]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          neigh[k] = neigh[k] + lefts[k];   // roll(phi, 1, ND - 1)
          neigh[k] = neigh[k] + rights[k];  // roll(phi, -1, ND - 1)
          force[k] = force[k] - w0 * neigh[k];
        }
      }
      out[gr] = make_float4(force[0] * gb, force[1] * gb, force[2] * gb,
                            force[3] * gb);
    }
    __syncthreads();  // every thread has read the stage
    if (gi < 32) {
      const long long next = b + (long long)kNdStages * gridDim.x;
      if (next < B) nd_load<kHalo>(cfgs, halo, ring, full, next, st, t);
    }
    if (++st == kNdStages) {
      st = 0;
      parity ^= 1u;
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(kNdMaxGroups, kNdMinBlocks)
phi4_action_tiled_nd_kernel(const float* __restrict__ cfgs,
                            float* __restrict__ act, long long B, NdTile t,
                            float w0, float w2, float w4) {
  action_tiled_nd<ND, false>(cfgs, nullptr, act, B, t, w0, w2, w4);
}

template <int ND>
__global__ void __launch_bounds__(kNdMaxGroups, kNdMinBlocks)
phi4_action_slab_tiled_nd_kernel(const float* __restrict__ cfgs,
                                 const float* __restrict__ halo,
                                 float* __restrict__ act, long long B,
                                 NdTile t, float w0, float w2, float w4) {
  action_tiled_nd<ND, true>(cfgs, halo, act, B, t, w0, w2, w4);
}

template <int ND>
__global__ void __launch_bounds__(kNdMaxGroups, kNdMinBlocks)
phi4_action_grad_tiled_nd_kernel(const float* __restrict__ cfgs,
                                 const float* __restrict__ g,
                                 float* __restrict__ grad, long long B,
                                 NdTile t, float w0, float w2, float w4) {
  grad_tiled_nd<ND, false>(cfgs, nullptr, g, grad, B, t, w0, w2, w4);
}

template <int ND>
__global__ void __launch_bounds__(kNdMaxGroups, kNdMinBlocks)
phi4_action_grad_slab_tiled_nd_kernel(const float* __restrict__ cfgs,
                                      const float* __restrict__ halo,
                                      const float* __restrict__ g,
                                      float* __restrict__ grad, long long B,
                                      NdTile t, float w0, float w2,
                                      float w4) {
  grad_tiled_nd<ND, true>(cfgs, halo, g, grad, B, t, w0, w2, w4);
}

// The tile of a lattice the tiled nd kernels take, or false: nd 3 or 4,
// the unused trailing extent 1, the last extent a multiple of 4, G = V / 4
// a multiple of 32 up to kNdMaxGroups; T the smallest j s0 (j dividing L0)
// that is a multiple of 32 and at least min(kNdThreads, G).
bool nd_tile(int nd, int L0, int L1, int L2, int L3, NdTile& t) {
  if (nd < 3 || nd > 4 || L0 < 1 || L1 < 1 || L2 < 1 || L3 < 1 ||
      (nd == 3 && L3 != 1))
    return false;
  const int L[4] = {L0, L1, L2, L3};
  const long long V = (long long)L0 * L1 * L2 * L3;
  if (L[nd - 1] % 4 || V % 128 || V / 4 > kNdMaxGroups) return false;
  const int G = (int)(V / 4), s0 = G / L0;
  const int want = G < kNdThreads ? G : kNdThreads;
  int j = 1;
  while (L0 % j || (j * s0) % 32 || j * s0 < want) ++j;  // ends at L0
  t = NdTile{{L0, L1, L2, L3}, G, j * s0, s0, j, G};
  return true;
}

// The tile of a slab (l0 = L0 rows and the rest) the tiled nd slab kernels
// take, or false: nd_tile's on the slab's extents, the twin of
// normflow__tpu_torch/ops/kernels/phi4.py::slab_plan_nd, and a ring stage
// of G + 2 s0 float4s, halo row 0, the slab's rows, halo row 1.
bool slab_nd_tile(int nd, int L0, int L1, int L2, int L3, NdTile& t) {
  if (!nd_tile(nd, L0, L1, L2, L3, t)) return false;
  t.stage = t.G + 2 * t.s0;
  return true;
}

// Launch `kern` persistent: as many blocks of T threads and the ring's
// shared memory of t.stage float4s a stage as the card holds at once, at
// most one a sample.  `max_stage` is the most float4s a stage of `kern`
// takes, which its shared-memory attribute allows once.  The blocks an SM
// holds depend on T and the stage alone: cached per kernel.
template <auto kern, typename... Args>
int nd_launch(long long B, const NdTile& t, int max_stage,
              cudaStream_t stream, Args... args) {
  const size_t smem = (size_t)kNdStages * t.stage * sizeof(float4);
  struct Seen {
    int T, stage, per_sm;
  };
  static bool sized = false;
  static Seen seen[16] = {};
  static int n_seen = 0;
  int per_sm = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].T == t.T && seen[i].stage == t.stage) per_sm = seen[i].per_sm;
  cudaError_t err = cudaSuccess;
  if (!sized) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)kNdStages * max_stage * sizeof(float4)));
    sized = err == cudaSuccess;
  }
  if (err == cudaSuccess && per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, t.T,
                                                        smem);
    if (err == cudaSuccess && n_seen < 16)
      seen[n_seen++] = Seen{t.T, t.stage, per_sm};
  }
  int dev = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)n_sm * per_sm;
  const unsigned int grid = (unsigned int)(B < resident ? B : resident);
  kern<<<grid, t.T, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// cfgs (B, L0, L1, L2, L3) float32 contiguous with nd lattice dims, the
// unused trailing extents 1; act (B,).  Returns cudaGetLastError() after the
// launch.
extern "C" int phi4_action_f32(const void* cfgs, void* act, long long B,
                               int nd, int L0, int L1, int L2, int L3,
                               float w0, float w2, float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2 * L3;
  if (nd < 1 || nd > 4 || B > 2147483647LL || V > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_kernel<<<(unsigned int)B, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<float*>(act), (int)V, nd, L0,
      L1, L2, L3, w0, w2, w4);
  return (int)cudaGetLastError();
}

// cfgs and grad (B, L0, L1, L2, L3) float32 contiguous with nd lattice dims,
// the unused trailing extents 1; g (B,).  Returns cudaGetLastError() after
// the launch.
extern "C" int phi4_action_grad_f32(const void* cfgs, const void* g,
                                    void* grad, long long B, int nd, int L0,
                                    int L1, int L2, int L3, float w0,
                                    float w2, float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2 * L3;
  const long long n = B * V;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (nd < 1 || nd > 4 || V > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_grad_kernel<<<(unsigned int)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(g),
      static_cast<float*>(grad), n, (int)V, nd, L0, L1, L2, L3, w0, w2, w4);
  return (int)cudaGetLastError();
}

// The tiled action: cfgs (B, L0, L1) float32 contiguous and 16-byte
// aligned, L1 % 4 == 0, G = L0 L1 / 4 a multiple of 32 and at most 1024,
// `samples` per block with G * samples <= 1024 (the wrapper sends other
// shapes to phi4_action_f32).  Returns cudaErrorInvalidValue for what it
// does not take, else cudaGetLastError() after the launch.
extern "C" int phi4_action_tiled_f32(const void* cfgs, void* act, long long B,
                                     int L0, int L1, int samples, float w0,
                                     float w2, float w4, void* stream) {
  const long long G = (long long)L0 * L1 / 4;
  if (B < 1 || L0 < 1 || L1 < 4 || L1 % 4 || G % 32 || G > 1024 ||
      samples < 1 || G * samples > 1024 ||
      reinterpret_cast<uintptr_t>(cfgs) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + samples - 1) / samples;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned int)G, (unsigned int)samples);
  phi4_action_tiled_kernel<<<(unsigned int)blocks, block,
                             (size_t)samples * G * sizeof(float4),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<float*>(act), B, L0, L1,
      w0, w2, w4);
  return (int)cudaGetLastError();
}

// The tiled force: cfgs and grad (B, L0, L1) float32 contiguous and 16-byte
// aligned, g (B,), on the lattices and blocks phi4_action_tiled_f32 takes
// (the wrapper sends other shapes to phi4_action_grad_f32).  Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launch.
extern "C" int phi4_action_grad_tiled_f32(const void* cfgs, const void* g,
                                          void* grad, long long B, int L0,
                                          int L1, int samples, float w0,
                                          float w2, float w4, void* stream) {
  const long long G = (long long)L0 * L1 / 4;
  if (B < 1 || L0 < 1 || L1 < 4 || L1 % 4 || G % 32 || G > 1024 ||
      samples < 1 || G * samples > 1024 ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(grad) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + samples - 1) / samples;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned int)G, (unsigned int)samples);
  phi4_action_grad_tiled_kernel<<<(unsigned int)blocks, block,
                                  (size_t)samples * G * sizeof(float4),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(g),
      static_cast<float*>(grad), B, L0, L1, w0, w2, w4);
  return (int)cudaGetLastError();
}

// The slab action (see the note at the top): cfgs (B, L0, L1, L2, L3)
// float32 contiguous with nd lattice dims, the unused trailing extents 1;
// halo (B, 2, L1, L2, L3); act (B,).  Returns cudaGetLastError() after the
// launch.
extern "C" int phi4_action_slab_f32(const void* cfgs, const void* halo,
                                    void* act, long long B, int nd, int L0,
                                    int L1, int L2, int L3, float w0,
                                    float w2, float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2 * L3;
  if (nd < 1 || nd > 4 || B > 2147483647LL || V > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_slab_kernel<<<(unsigned int)B, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(halo),
      static_cast<float*>(act), (int)V, nd, L0, L1, L2, L3, w0, w2, w4);
  return (int)cudaGetLastError();
}

// The slab force: cfgs and grad (B, L0, L1, L2, L3), halo (B, 2, L1, L2,
// L3), g (B,), float32 contiguous.  Returns cudaGetLastError() after the
// launch.
extern "C" int phi4_action_grad_slab_f32(const void* cfgs, const void* halo,
                                         const void* g, void* grad,
                                         long long B, int nd, int L0, int L1,
                                         int L2, int L3, float w0, float w2,
                                         float w4, void* stream) {
  const long long V = (long long)L0 * L1 * L2 * L3;
  const long long n = B * V;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (nd < 1 || nd > 4 || V > 2147483647LL || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  phi4_action_grad_slab_kernel<<<(unsigned int)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(halo),
      static_cast<const float*>(g), static_cast<float*>(grad), n, (int)V, nd,
      L0, L1, L2, L3, w0, w2, w4);
  return (int)cudaGetLastError();
}

// The tiled slab action: the slab on the tiled action's lattices and
// blocks, halo (B, 2, L1) 16-byte aligned.  Returns cudaErrorInvalidValue
// for what it does not take, else cudaGetLastError() after the launch.
extern "C" int phi4_action_slab_tiled_f32(const void* cfgs, const void* halo,
                                          void* act, long long B, int L0,
                                          int L1, int samples, float w0,
                                          float w2, float w4, void* stream) {
  const long long G = (long long)L0 * L1 / 4;
  if (B < 1 || L0 < 1 || L1 < 4 || L1 % 4 || G % 32 || G > 1024 ||
      samples < 1 || G * samples > 1024 ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(halo) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + samples - 1) / samples;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned int)G, (unsigned int)samples);
  phi4_action_slab_tiled_kernel<<<(unsigned int)blocks, block,
                                  (size_t)samples * G * sizeof(float4),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(halo),
      static_cast<float*>(act), B, L0, L1, w0, w2, w4);
  return (int)cudaGetLastError();
}

// The tiled slab force: cfgs and grad (B, L0, L1), halo (B, 2, L1), all
// 16-byte aligned, g (B,), on the tiled action's lattices and blocks.
// Returns cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after the launch.
extern "C" int phi4_action_grad_slab_tiled_f32(
    const void* cfgs, const void* halo, const void* g, void* grad,
    long long B, int L0, int L1, int samples, float w0, float w2, float w4,
    void* stream) {
  const long long G = (long long)L0 * L1 / 4;
  if (B < 1 || L0 < 1 || L1 < 4 || L1 % 4 || G % 32 || G > 1024 ||
      samples < 1 || G * samples > 1024 ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(halo) % 16 ||
      reinterpret_cast<uintptr_t>(grad) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + samples - 1) / samples;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned int)G, (unsigned int)samples);
  phi4_action_grad_slab_tiled_kernel<<<(unsigned int)blocks, block,
                                       (size_t)samples * G * sizeof(float4),
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cfgs), static_cast<const float*>(halo),
      static_cast<const float*>(g), static_cast<float*>(grad), B, L0, L1, w0,
      w2, w4);
  return (int)cudaGetLastError();
}

// The tiled action on 3-D and 4-D lattices (notes at the kernel): cfgs
// (B, L0, L1, L2, L3) float32 contiguous and 16-byte aligned with nd = 3 or
// 4 lattice dims, the unused trailing extent 1, the last extent a multiple
// of 4 and V / 4 a multiple of 32 up to 1024; act (B,).  The arguments are
// phi4_action_f32's.  Returns cudaErrorInvalidValue for what it does not
// take (the wrapper sends other shapes to phi4_action_f32), else
// cudaGetLastError() after the launch.
extern "C" int phi4_action_tiled_nd_f32(const void* cfgs, void* act,
                                        long long B, int nd, int L0, int L1,
                                        int L2, int L3, float w0, float w2,
                                        float w4, void* stream) {
  NdTile t;
  if (B < 1 || !nd_tile(nd, L0, L1, L2, L3, t) ||
      reinterpret_cast<uintptr_t>(cfgs) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cfgs);
  auto* a = static_cast<float*>(act);
  return nd == 3 ? nd_launch<phi4_action_tiled_nd_kernel<3>>(
                       B, t, kNdMaxGroups, st, c, a, B, t, w0, w2, w4)
                 : nd_launch<phi4_action_tiled_nd_kernel<4>>(
                       B, t, kNdMaxGroups, st, c, a, B, t, w0, w2, w4);
}

// The tiled force on 3-D and 4-D lattices: cfgs and grad (B, L0, L1, L2,
// L3), both 16-byte aligned, g (B,), on the lattices
// phi4_action_tiled_nd_f32 takes; the arguments are phi4_action_grad_f32's.
// Returns cudaErrorInvalidValue for what it does not take (the wrapper
// sends other shapes to phi4_action_grad_f32), else cudaGetLastError()
// after the launch.
extern "C" int phi4_action_grad_tiled_nd_f32(const void* cfgs, const void* g,
                                             void* grad, long long B, int nd,
                                             int L0, int L1, int L2, int L3,
                                             float w0, float w2, float w4,
                                             void* stream) {
  NdTile t;
  if (B < 1 || !nd_tile(nd, L0, L1, L2, L3, t) ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(grad) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cfgs);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<float*>(grad);
  return nd == 3 ? nd_launch<phi4_action_grad_tiled_nd_kernel<3>>(
                       B, t, kNdMaxGroups, st, c, gg, out, B, t, w0, w2, w4)
                 : nd_launch<phi4_action_grad_tiled_nd_kernel<4>>(
                       B, t, kNdMaxGroups, st, c, gg, out, B, t, w0, w2, w4);
}

// The tiled nd slab action (notes at the tiled nd kernels): a slab on the
// lattices phi4_action_tiled_nd_f32 takes, cfgs (B, L0, L1, L2, L3) and halo
// (B, 2, L1, L2, L3) float32 contiguous and 16-byte aligned; the arguments
// are phi4_action_slab_f32's.  Returns cudaErrorInvalidValue for what it
// does not take (the wrapper sends other slabs to phi4_action_slab_f32),
// else cudaGetLastError() after the launch.
extern "C" int phi4_action_slab_tiled_nd_f32(const void* cfgs,
                                             const void* halo, void* act,
                                             long long B, int nd, int L0,
                                             int L1, int L2, int L3, float w0,
                                             float w2, float w4,
                                             void* stream) {
  NdTile t;
  if (B < 1 || !slab_nd_tile(nd, L0, L1, L2, L3, t) ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(halo) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cfgs);
  const auto* h = static_cast<const float*>(halo);
  auto* a = static_cast<float*>(act);
  return nd == 3 ? nd_launch<phi4_action_slab_tiled_nd_kernel<3>>(
                       B, t, 3 * kNdMaxGroups, st, c, h, a, B, t, w0, w2, w4)
                 : nd_launch<phi4_action_slab_tiled_nd_kernel<4>>(
                       B, t, 3 * kNdMaxGroups, st, c, h, a, B, t, w0, w2,
                       w4);
}

// The tiled nd slab force: cfgs and grad (B, L0, L1, L2, L3) and halo (B,
// 2, L1, L2, L3), all 16-byte aligned, g (B,), on the slabs
// phi4_action_slab_tiled_nd_f32 takes; the arguments are
// phi4_action_grad_slab_f32's.  Returns cudaErrorInvalidValue for what it
// does not take (the wrapper sends other slabs to
// phi4_action_grad_slab_f32), else cudaGetLastError() after the launch.
extern "C" int phi4_action_grad_slab_tiled_nd_f32(
    const void* cfgs, const void* halo, const void* g, void* grad,
    long long B, int nd, int L0, int L1, int L2, int L3, float w0, float w2,
    float w4, void* stream) {
  NdTile t;
  if (B < 1 || !slab_nd_tile(nd, L0, L1, L2, L3, t) ||
      reinterpret_cast<uintptr_t>(cfgs) % 16 ||
      reinterpret_cast<uintptr_t>(halo) % 16 ||
      reinterpret_cast<uintptr_t>(grad) % 16)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cfgs);
  const auto* h = static_cast<const float*>(halo);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<float*>(grad);
  return nd == 3 ? nd_launch<phi4_action_grad_slab_tiled_nd_kernel<3>>(
                       B, t, 3 * kNdMaxGroups, st, c, h, gg, out, B, t, w0,
                       w2, w4)
                 : nd_launch<phi4_action_grad_slab_tiled_nd_kernel<4>>(
                       B, t, 3 * kNdMaxGroups, st, c, h, gg, out, B, t, w0,
                       w2, w4);
}
