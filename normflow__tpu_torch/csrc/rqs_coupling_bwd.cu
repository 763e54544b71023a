// VJP of the fused RQ-spline coupling transform for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rqs_bwd_kernel` of
// normflow__tpu/ops/kernels/spline_coupling.py (l.133-145, launched by
// `pallas_bwd`), which recomputes the forward on a tile and transposes it
// with jax.vjp at trace time.  CUDA has no autodiff, so the adjoint here is
// derived by hand; the plain PyTorch version beside it,
// normflow__tpu_torch/ops/kernels/spline_coupling.py::rqs_coupling_vjp_plain,
// carries the same formulas in the same order, and the CPU tests hold that
// against jax.vjp of the Pallas kernel.
//
// Per site: recompute the knots, the segment and theta (rqs_common.cuh),
// then, from the cotangents (ybar, loggbar), the adjoints of the segment's
// end points, scattered onto knots s and s+1, the linear boundary knots
// folded back onto the first and last knot, and transposed through
// softplus_log2 and the softmax + cumsum coordinates onto all 3m-2
// conditioner channels:
// - coordinates c_j = cum_j / tot: dc_j/dw_i = s_i ([i < j] - c_j) with
//   s_i = e_i / tot, so  wbar_i = s_i (sum_{j>i} cbar_j - sum_j cbar_j c_j);
//   the max shift's gradient is zero in exact arithmetic and is dropped;
// - the inverse direction uses the implicit-function form: theta solves
//   F(theta; p) = x, so dtheta = (dx - dF/dp dp) / (dF/dtheta), with
//   dF/dtheta = g * (x1 - x0); log g's adjoint enters with a minus sign.
//
// What bounds it on an H100: memory.  A site reads x, ybar, loggbar and the
// 3m-2 channels of out and writes xbar and 3m-2 channels of outbar: at
// m = 8, 4 (3 + 22 + 1 + 22) = 192 B, against a few hundred float32
// operations.  The design follows the forward kernel: one thread per
// (sample, site), per-channel reads and writes coalesced across
// neighbouring threads, m a template parameter with unrolled loops so the
// knot arrays and the adjoint selects use static indices and stay in
// registers, no shared memory, no atomics (each site owns its outbar).  The
// knot arrays live only until the segment is gathered; the coordinate
// weights are read again for the transposition rather than held, to keep
// the live registers near the forward kernel's.

#include "rqs_common.cuh"

namespace {

// Adjoints of the rational-quadratic map's parameters at fixed theta.
struct Adj {
  float mm, sp, d0, dy, y0, th;
};

// lg = log(mm^2 num / denom^2) with num = d0 + 2 (mm - d0) t + sp t^2 and
// denom = mm + sp t (1 - t); adds lgb * dlg/d(mm, sp, d0, t).
__device__ __forceinline__ void lg_adjoint(float t, float mm, float sp,
                                           float d0, float lgb, Adj& a) {
  const float omt = 1.0f - t;
  const float denom = mm + sp * t * omt;
  const float num = d0 + 2.0f * (mm - d0) * t + sp * t * t;
  const float num_b = lgb / num;
  const float den_b = -2.0f * lgb / denom;
  a.mm += 2.0f * lgb / mm + num_b * 2.0f * t + den_b;
  a.d0 += num_b * (1.0f - 2.0f * t);
  a.sp += num_b * t * t + den_b * t * omt;
  a.th += num_b * (2.0f * (mm - d0) + 2.0f * sp * t) +
          den_b * sp * (1.0f - 2.0f * t);
}

// F = y0 + dy t q / denom with q = mm t + d0 (1 - t); adds
// fb * dF/d(mm, sp, d0, dy, y0, t).
__device__ __forceinline__ void f_adjoint(float t, float mm, float sp,
                                          float d0, float dy, float fb,
                                          Adj& a) {
  const float omt = 1.0f - t;
  const float denom = mm + sp * t * omt;
  const float q = mm * t + d0 * omt;
  const float r = t * q / denom;
  const float tb = fb * dy / denom;
  const float den_b = -fb * dy * r / denom;
  a.y0 += fb;
  a.dy += fb * r;
  a.mm += tb * t * t + den_b;
  a.d0 += tb * t * omt;
  a.sp += den_b * t * omt;
  a.th += tb * (q + t * (mm - d0)) + den_b * sp * (1.0f - 2.0f * t);
}

// Adjoint of original knot j (0..M-1) from the adjoints b0, b1 of the
// segment's end points (augmented indices idx, idx+1); a linear boundary
// knot copies the first or last knot, so its adjoint lands there.
template <int M, bool LEFT, bool RIGHT>
__device__ __forceinline__ float knot_adj(int j, int idx, float b0,
                                          float b1) {
  constexpr int L = LEFT ? 1 : 0;
  constexpr int K = M + L + (RIGHT ? 1 : 0);
  float v = (idx == j + L ? b0 : 0.0f) + (idx == j + L - 1 ? b1 : 0.0f);
  if (LEFT && j == 0) v += idx == 0 ? b0 : 0.0f;
  if (RIGHT && j == M - 1) v += idx == K - 2 ? b1 : 0.0f;
  return v;
}

// Transpose lo + width * c_j through the softmax + cumsum of the M-1
// weights at `w` (stride `stride`); writes their adjoints to `wb`.
template <int M, bool LEFT, bool RIGHT>
__device__ __forceinline__ void coords_adjoint(const float* __restrict__ w,
                                               float* __restrict__ wb,
                                               long long stride, float width,
                                               int idx, float b0, float b1) {
  float e[M - 1];
  float mx = __ldg(w);
  e[0] = mx;
#pragma unroll
  for (int j = 1; j < M - 1; ++j) {
    e[j] = __ldg(w + j * stride);
    mx = fmaxf(mx, e[j]);
  }
  float tot = 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    e[j] = expf(e[j] - mx);
    tot += e[j];
  }
  const float inv = 1.0f / tot;
  // cb[j] = width * kbar_{j+1}; A = sum_j cb[j] c_{j+1}
  float cb[M - 1];
  float cum = 0.0f, A = 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    cum += e[j];
    cb[j] = width * knot_adj<M, LEFT, RIGHT>(j + 1, idx, b0, b1);
    A += cb[j] * (cum * inv);
  }
  float suffix = 0.0f;  // sum_{j > i} cbar_j
#pragma unroll
  for (int i = M - 2; i >= 0; --i) {
    suffix += cb[i];
    wb[i * stride] = (e[i] * inv) * (suffix - A);
  }
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(256)
rqs_coupling_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ out,
                        const float* __restrict__ ybar,
                        const float* __restrict__ loggbar,
                        float* __restrict__ xbar, float* __restrict__ outbar,
                        long long n_sites, long long S, float xlo, float xw,
                        float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int K = M + (LEFT ? 1 : 0) + (RIGHT ? 1 : 0);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites) return;
  const long long b = i / S;
  const long long s = i - b * S;
  const long long site = b * (long long)K3 * S + s;
  const float* o = out + site;
  float* ob = outbar + site;

  const float xv = __ldg(x + i);
  Segment sg;
  {
    float kx[K], ky[K], kd[K];
    knots<M, LEFT, RIGHT>(o, S, xlo, xw, ylo, yw, kx, ky, kd);
    sg = segment<K, INVERSE>(xv, kx, ky, kd);
  }
  const int idx = sg.idx;
  const float dx = sg.x1 - sg.x0;
  const float dy = sg.y1 - sg.y0;
  const float mm = dy / dx;
  const float spread = sg.d1 + sg.d0 - 2.0f * mm;
  const float theta = INVERSE
      ? inverse_theta(xv, sg.y0, dy, mm, spread, sg.d0)
      : (xv - sg.x0) / dx;

  const float gy = __ldg(ybar + i);
  const float gl = __ldg(loggbar + i);
  Adj a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float xb, x0b, dxb;
  if (!INVERSE) {
    lg_adjoint(theta, mm, spread, sg.d0, gl, a);
    f_adjoint(theta, mm, spread, sg.d0, dy, gy, a);
    xb = a.th / dx;
    x0b = -xb;
    dxb = -xb * theta;
  } else {
    // y = x0 + dx theta, log g = -lg(theta); theta solves F(theta) = x
    lg_adjoint(theta, mm, spread, sg.d0, -gl, a);
    const float thb = a.th + gy * dx;
    x0b = gy;
    dxb = gy * theta;
    const float omt = 1.0f - theta;
    const float denom = mm + spread * theta * omt;
    const float num = sg.d0 + 2.0f * (mm - sg.d0) * theta +
                      spread * theta * theta;
    const float c = thb / (mm * mm * num / (denom * denom) * dx);
    xb = c;
    f_adjoint(theta, mm, spread, sg.d0, dy, -c, a);
  }
  xbar[i] = xb;

  // spread = d1 + d0 - 2 mm, mm = dy / dx, dx = x1 - x0, dy = y1 - y0
  const float d1b = a.sp;
  const float d0b = a.d0 + a.sp;
  const float mmb = a.mm - 2.0f * a.sp;
  const float dyb = a.dy + mmb / dx;
  dxb += -mmb * mm / dx;
  const float x1b = dxb;
  x0b += -dxb;
  const float y1b = dyb;
  const float y0b = a.y0 - dyb;

  coords_adjoint<M, LEFT, RIGHT>(o, ob, S, xw, idx, x0b, x1b);
  coords_adjoint<M, LEFT, RIGHT>(o + (long long)(M - 1) * S,
                                 ob + (long long)(M - 1) * S, S, yw, idx, y0b,
                                 y1b);
  // derivatives: kd = softplus_log2(w), dkd/dw = sigmoid(w ln2); the
  // boundary y knots ky[0] - kd[0] and ky[-1] + kd[-1] add -y0b / +y1b
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float kdb = knot_adj<M, LEFT, RIGHT>(j, idx, d0b, d1b);
    if (LEFT && j == 0) kdb += idx == 0 ? -y0b : 0.0f;
    if (RIGHT && j == M - 1) kdb += idx == K - 2 ? y1b : 0.0f;
    const long long c = (long long)(2 * (M - 1) + j) * S;
    const float z = __ldg(o + c) * kLn2;
    ob[c] = kdb * (1.0f / (1.0f + expf(-z)));
  }
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
void launch(const float* x, const float* out, const float* ybar,
            const float* loggbar, float* xbar, float* outbar, long long n,
            long long S, float xlo, float xw, float ylo, float yw,
            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  rqs_coupling_bwd_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, threads, 0, stream>>>(
          x, out, ybar, loggbar, xbar, outbar, n, S, xlo, xw, ylo, yw);
}

template <int M>
void dispatch(const float* x, const float* out, const float* ybar,
              const float* loggbar, float* xbar, float* outbar, long long n,
              long long S, float xlo, float xw, float ylo, float yw, int left,
              int right, int inverse, cudaStream_t stream) {
  const int key = (left ? 4 : 0) | (right ? 2 : 0) | (inverse ? 1 : 0);
  switch (key) {
#define NF_CASE(K, LL, RR, II)                                             \
  case K:                                                                  \
    launch<M, LL, RR, II>(x, out, ybar, loggbar, xbar, outbar, n, S, xlo,  \
                          xw, ylo, yw, stream);                            \
    break;
    NF_CASE(0, false, false, false)
    NF_CASE(1, false, false, true)
    NF_CASE(2, false, true, false)
    NF_CASE(3, false, true, true)
    NF_CASE(4, true, false, false)
    NF_CASE(5, true, false, true)
    NF_CASE(6, true, true, false)
    NF_CASE(7, true, true, true)
#undef NF_CASE
  }
}

}  // namespace

// x, ybar, loggbar, xbar (B, S); out, outbar (B, 3m-2, S); all float32,
// contiguous.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a knot count without a template instance.
extern "C" int rqs_coupling_bwd_f32(const void* x, const void* out,
                                    const void* ybar, const void* loggbar,
                                    void* xbar, void* outbar, long long B,
                                    long long S, int m, float xlo, float xw,
                                    float ylo, float yw, int left_linear,
                                    int right_linear, int inverse,
                                    void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* op = static_cast<const float*>(out);
  const float* yb = static_cast<const float*>(ybar);
  const float* gb = static_cast<const float*>(loggbar);
  float* xbp = static_cast<float*>(xbar);
  float* obp = static_cast<float*>(outbar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = B * S;
  switch (m) {
#define NF_M(MM)                                                            \
  case MM:                                                                  \
    dispatch<MM>(xp, op, yb, gb, xbp, obp, n, S, xlo, xw, ylo, yw,          \
                 left_linear, right_linear, inverse, st);                   \
    break;
    NF_M(4)
    NF_M(6)
    NF_M(8)
    NF_M(12)
#undef NF_M
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
