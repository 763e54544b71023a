// Fused RQ-spline coupling transform for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rqs_kernel` (body `_rqs_core`) of
// normflow__tpu/ops/kernels/spline_coupling.py, entry `rqs_transform_fused`,
// forward direction (`inverse=False`) and its closed-form inverse
// (`inverse=True`).  Plain PyTorch version beside it:
// normflow__tpu_torch/ops/kernels/spline_coupling.py::rqs_coupling_plain.
//
// Per site: 3m-2 conditioner channels -> m knots (softmax + cumsum x/y
// coordinates in the xlim/ylim box, log-2 softplus derivatives), optional
// linear boundary knots, segment by comparison count, then the
// rational-quadratic map or its "citardauq" inverse -> (y, log dy/dx).
//
// What bounds it on an H100: memory.  A site reads 4 B of x and 4(3m-2) B of
// conditioner output and writes 8 B; at m = 8 that is 100 B per site, about
// 52 MB per launch at B = 1024 and 512 packed sites, against roughly 300
// floating-point operations per site, far below the card's 67 TFLOP/s of
// float32 per 3.35 TB/s.  The design serves that bound:
// - one thread per (sample, site); for channel k, neighbouring threads read
//   neighbouring addresses of out[b, k, :], so every load is coalesced and
//   each input byte is read exactly once;
// - m is a template parameter and the knot loops are unrolled, so the knot
//   arrays live in registers and the segment "gather" is a chain of selects
//   with static indices (as the Pallas kernel unrolled the knot axis);
// - no shared memory, no padding to a tile: the ragged tail is masked.
// The division-heavy arithmetic is left in IEEE float32 (no fast math) so
// the kernel agrees with the plain version to float32 round-off.

#include "rqs_common.cuh"

namespace {

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(256)
rqs_coupling_kernel(const float* __restrict__ x, const float* __restrict__ out,
                    float* __restrict__ y, float* __restrict__ logg,
                    long long n_sites, long long S, float xlo, float xw,
                    float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int L = LEFT ? 1 : 0;
  constexpr int K = M + L + (RIGHT ? 1 : 0);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites) return;
  const long long b = i / S;
  const long long s = i - b * S;
  const float* o = out + b * (long long)K3 * S + s;

  float kx[K], ky[K], kd[K];
  knots<M, LEFT, RIGHT>(o, S, xlo, xw, ylo, yw, kx, ky, kd);
  const float xv = __ldg(x + i);
  const Segment sg = segment<K, INVERSE>(xv, kx, ky, kd);
  const float x0 = sg.x0, x1 = sg.x1, y0 = sg.y0, y1 = sg.y1, d0 = sg.d0,
              d1 = sg.d1;

  const float dx = x1 - x0;
  const float dy = y1 - y0;
  const float mm = dy / dx;
  const float spread = d1 + d0 - 2.0f * mm;

  float theta;
  if (!INVERSE) {
    theta = (xv - x0) / dx;
    const float denom = mm + spread * theta * (1.0f - theta);
    y[i] = y0 + dy * theta * (mm * theta + d0 * (1.0f - theta)) / denom;
  } else {
    theta = inverse_theta(xv, y0, dy, mm, spread, d0);
    y[i] = x0 + dx * theta;
  }
  const float denom = mm + spread * theta * (1.0f - theta);
  const float num = d0 + 2.0f * (mm - d0) * theta + spread * theta * theta;
  const float lg = logf(mm * mm * num / (denom * denom));
  logg[i] = INVERSE ? -lg : lg;
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
void launch(const float* x, const float* out, float* y, float* logg,
            long long n, long long S, float xlo, float xw, float ylo,
            float yw, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  rqs_coupling_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, threads, 0, stream>>>(x, out, y, logg, n, S,
                                                     xlo, xw, ylo, yw);
}

template <int M>
void dispatch(const float* x, const float* out, float* y, float* logg,
              long long n, long long S, float xlo, float xw, float ylo,
              float yw, int left, int right, int inverse,
              cudaStream_t stream) {
  const int key = (left ? 4 : 0) | (right ? 2 : 0) | (inverse ? 1 : 0);
  switch (key) {
#define NF_CASE(K, LL, RR, II)                                            \
  case K:                                                                 \
    launch<M, LL, RR, II>(x, out, y, logg, n, S, xlo, xw, ylo, yw, stream); \
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

// x (B, S), out (B, 3m-2, S), y and logg (B, S); all float32, contiguous.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a knot count without a template instance.
extern "C" int rqs_coupling_f32(const void* x, const void* out, void* y,
                                void* logg, long long B, long long S, int m,
                                float xlo, float xw, float ylo, float yw,
                                int left_linear, int right_linear,
                                int inverse, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* op = static_cast<const float*>(out);
  float* yp = static_cast<float*>(y);
  float* gp = static_cast<float*>(logg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = B * S;
  switch (m) {
    case 4:
      dispatch<4>(xp, op, yp, gp, n, S, xlo, xw, ylo, yw, left_linear,
                  right_linear, inverse, st);
      break;
    case 6:
      dispatch<6>(xp, op, yp, gp, n, S, xlo, xw, ylo, yw, left_linear,
                  right_linear, inverse, st);
      break;
    case 8:
      dispatch<8>(xp, op, yp, gp, n, S, xlo, xw, ylo, yw, left_linear,
                  right_linear, inverse, st);
      break;
    case 12:
      dispatch<12>(xp, op, yp, gp, n, S, xlo, xw, ylo, yw, left_linear,
                   right_linear, inverse, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
