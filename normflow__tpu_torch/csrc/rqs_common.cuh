// Per-site pieces shared by the RQ-spline coupling kernels
// (rqs_coupling.cu, forward and inverse; rqs_coupling_bwd.cu, their VJP):
// the knots from the conditioner's 3m-2 channels, the segment search and
// gather, and the closed-form inverse.  The forward order of operations is
// that of the Pallas body `_rqs_core` (normflow__tpu/ops/kernels/
// spline_coupling.py:37-118), repeated by the plain PyTorch versions in
// normflow__tpu_torch/ops/kernels/spline_coupling.py.  On the host side,
// the template dispatch of both files' C entry points and the grid of
// their persistent (tiled) kernels.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLn2 = 0.69314718055994530942f;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN == finfo(float32).tiny

__device__ __forceinline__ float softplus_log2(float w) {
  // logaddexp(w ln2, 0) / ln2, exact for every w
  const float z = w * kLn2;
  return (fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)))) / kLn2;
}

// Where a kernel reads the conditioner's values: global memory through the
// read-only cache (the per-site kernels), or a shared-memory stage (the
// tiled and the channels-last kernels).
struct FromGlobal {
  static __device__ __forceinline__ float at(const float* p) {
    return __ldg(p);
  }
};
struct FromShared {
  static __device__ __forceinline__ float at(const float* p) { return *p; }
};

// Softmax + cumsum knot coordinates of M-1 weights at stride `stride`:
// writes M values lo + width * c_j, c_0 = 0, into k[0..M-1].
template <int M, typename From = FromGlobal, typename Stride>
__device__ __forceinline__ void coords(const float* __restrict__ w,
                                       Stride stride, float lo, float width,
                                       float* k) {
  float e[M - 1];
  float mx = From::at(w);
  e[0] = mx;
#pragma unroll
  for (int j = 1; j < M - 1; ++j) {
    e[j] = From::at(w + j * stride);
    mx = fmaxf(mx, e[j]);
  }
  float tot = 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    e[j] = expf(e[j] - mx);
    tot += e[j];
  }
  const float inv = 1.0f / tot;
  float cum = 0.0f;
  k[0] = lo + width * 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    cum += e[j];
    k[j + 1] = lo + width * (cum * inv);
  }
}

// All K = M + LEFT + RIGHT knots of one site; `o` points at channel 0 of
// the site, channels `S` apart, read through `From`.
template <int M, bool LEFT, bool RIGHT, typename From = FromGlobal>
__device__ __forceinline__ void knots(const float* __restrict__ o,
                                      long long S, float xlo, float xw,
                                      float ylo, float yw, float* kx,
                                      float* ky, float* kd) {
  constexpr int L = LEFT ? 1 : 0;
  constexpr int K = M + L + (RIGHT ? 1 : 0);
  coords<M, From>(o, S, xlo, xw, kx + L);
  coords<M, From>(o + (long long)(M - 1) * S, S, ylo, yw, ky + L);
#pragma unroll
  for (int j = 0; j < M; ++j)
    kd[L + j] = softplus_log2(From::at(o + (long long)(2 * (M - 1) + j) * S));

  // linear boundary knots (ops.spline.augment_knots, 'linear')
  if (LEFT) {
    kx[0] = kx[1] - 1.0f;
    ky[0] = ky[1] - kd[1];
    kd[0] = kd[1];
  }
  if (RIGHT) {
    kx[K - 1] = kx[K - 2] + 1.0f;
    ky[K - 1] = ky[K - 2] + kd[K - 2];
    kd[K - 1] = kd[K - 2];
  }
}

struct Segment {
  int idx;  // clip(#{knots < x}, 1, K-1) - 1
  float x0, x1, y0, y1, d0, d1;
};

// The segment of `xv` (searched among the y knots for the inverse) and its
// end points, gathered by a select chain with static indices so that the
// knot arrays stay in registers.
template <int K, bool INVERSE>
__device__ __forceinline__ Segment segment(float xv, const float* kx,
                                           const float* ky,
                                           const float* kd) {
  int idx = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) idx += (xv > (INVERSE ? ky[j] : kx[j])) ? 1 : 0;
  idx = min(max(idx, 1), K - 1) - 1;

  Segment sg = {idx, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (idx == j) {
      sg.x0 = kx[j]; sg.x1 = kx[j + 1];
      sg.y0 = ky[j]; sg.y1 = ky[j + 1];
      sg.d0 = kd[j]; sg.d1 = kd[j + 1];
    }
  }
  return sg;
}

// theta of the inverse map: the root of the segment's quadratic in the
// cancellation-free "citardauq" form, with the Pallas body's guards.
__device__ __forceinline__ float inverse_theta(float xv, float y0, float dy,
                                               float mm, float spread,
                                               float d0) {
  const float eta = (xv - y0) / dy;
  const float a2 = -spread * eta + d0 - mm;
  const float a1 = -a2 - mm;
  const float a0 = mm * eta;
  const float delta = sqrtf(fmaxf(a1 * a1 - 4.0f * a0 * a2, 0.0f));
  if (a1 <= 0.0f) {
    float q = 0.5f * (-a1 + delta);
    if (fabsf(q) < kTiny) q = 1.0f;
    return a0 / q;
  }
  const float q = -0.5f * (a1 + delta);
  const float a = fabsf(a2) < kTiny ? 1.0f : a2;
  return q / a;
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
struct Inst {};

// Calls f(Inst<M, LEFT, RIGHT, INVERSE>{}) for the template instance of
// these flags; cudaErrorInvalidValue for a knot count without one.
template <typename F>
int visit(int m, int left, int right, int inverse, F&& f) {
  const int key = (left ? 4 : 0) | (right ? 2 : 0) | (inverse ? 1 : 0);
#define NF_KEYS(MM)                                  \
  case MM:                                           \
    switch (key) {                                   \
      case 0: return f(Inst<MM, false, false, false>{}); \
      case 1: return f(Inst<MM, false, false, true>{});  \
      case 2: return f(Inst<MM, false, true, false>{});  \
      case 3: return f(Inst<MM, false, true, true>{});   \
      case 4: return f(Inst<MM, true, false, false>{});  \
      case 5: return f(Inst<MM, true, false, true>{});   \
      case 6: return f(Inst<MM, true, true, false>{});   \
      default: return f(Inst<MM, true, true, true>{});   \
    }
  switch (m) {
    NF_KEYS(4)
    NF_KEYS(6)
    NF_KEYS(8)
    NF_KEYS(12)
#undef NF_KEYS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of a persistent kernel that takes `tiles` tiles with `per_sm`
// blocks resident per SM: as many as stay resident on the card at once,
// at most one per tile.  A tiled kernel asks its `per_sm` once per
// instance (every sm_90 card has the same registers and shared memory per
// SM) and passes it here.
inline cudaError_t persistent_grid(int per_sm, long long tiles,
                                   unsigned int& grid) {
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long resident = (long long)n_sm * per_sm;
  grid = (unsigned int)(tiles < resident ? tiles : resident);
  return err;
}

}  // namespace
