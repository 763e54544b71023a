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
// What bounds it on an H100: memory, then instructions.  A site reads x,
// ybar, loggbar and the 3m-2 channels of out and writes xbar and 3m-2
// channels of outbar: at m = 8, 4 (3 + 22 + 1 + 22) = 192 B, 50.3 MB at the
// training batch (B = 512, 512 sites), against about a thousand float32
// instructions (IEEE divisions, expf, log1pf: --fmad=false).  Two variants,
// chosen by the wrapper by shape and alignment:
// - the tiled kernel (rqs_coupling_bwd_tiled_f32, the path's): persistent
//   blocks stage tiles through a ring of shared memory with bulk copies
//   (no tensor map, so nothing beyond the runtime is linked), the next
//   tiles arriving while this one computes, and the adjoints leave by bulk
//   stores; registers are capped by __launch_bounds__ so that 7 blocks of
//   128 threads fit on an SM at m <= 8 (design notes at the kernel);
// - the per-site kernel (rqs_coupling_bwd_f32) for S % 4 != 0 or an
//   address off 16 bytes, which the bulk copies cannot take: one thread per
//   (sample, site), per-channel reads and writes coalesced across
//   neighbouring threads, no shared memory.  Its knot arrays live only
//   until the segment is gathered; the coordinate weights are read again
//   for the transposition rather than held.
// For a channels-last `out`, (B, S, 3m-2) (the `pallas_reg` route, the
// Pallas kernel's `channels_last=True`), two more, outbar in the same
// layout, where the B S sites are one contiguous run of each tensor:
// - the channels-last tiled kernel (rqs_coupling_bwd_cl_tiled_f32, the
//   route's): the NCHW tiled kernel's ring and site_vjp_smem on flat tiles
//   of the run, four bulk copies in and two bulk stores out per tile
//   (notes at the kernel);
// - the channels-last per-site kernel (rqs_coupling_bwd_cl_f32) for
//   B S % 4 != 0 or an address off 16 bytes: a block's sites staged
//   through shared memory by coalesced loads and stores, each site's VJP
//   taken as the per-site kernel takes it.
// In all four, m is a template parameter with unrolled loops so the knot
// arrays and the adjoint selects use static indices and stay in registers,
// and each site owns its outbar (no atomics).  The four compute the same
// float32 operations in the same order and return the same bits.

#include "bulk_copy.cuh"
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
// weights at `w` (stride `stride`, read through `From`); writes their
// adjoints to `wb`.
template <int M, bool LEFT, bool RIGHT, typename From = FromGlobal>
__device__ __forceinline__ void coords_adjoint(const float* __restrict__ w,
                                               float* __restrict__ wb,
                                               long long stride, float width,
                                               int idx, float b0, float b1) {
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

// Site i of a per-site kernel: its 3m-2 values of out start at `o` and of
// outbar at `ob`, `S` floats apart (S in NCHW, 1 in a channels-last
// stage), `o` read through `From`.
template <int M, bool LEFT, bool RIGHT, bool INVERSE,
          typename From = FromGlobal>
__device__ __forceinline__ void site_vjp(
    const float* __restrict__ x, const float* __restrict__ o,
    const float* __restrict__ ybar, const float* __restrict__ loggbar,
    float* __restrict__ xbar, float* __restrict__ ob, long long S,
    long long i, float xlo, float xw, float ylo, float yw) {
  constexpr int K = M + (LEFT ? 1 : 0) + (RIGHT ? 1 : 0);

  const float xv = __ldg(x + i);
  Segment sg;
  {
    float kx[K], ky[K], kd[K];
    knots<M, LEFT, RIGHT, From>(o, S, xlo, xw, ylo, yw, kx, ky, kd);
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

  coords_adjoint<M, LEFT, RIGHT, From>(o, ob, S, xw, idx, x0b, x1b);
  coords_adjoint<M, LEFT, RIGHT, From>(o + (long long)(M - 1) * S,
                                       ob + (long long)(M - 1) * S, S, yw,
                                       idx, y0b, y1b);
  // derivatives: kd = softplus_log2(w), dkd/dw = sigmoid(w ln2); the
  // boundary y knots ky[0] - kd[0] and ky[-1] + kd[-1] add -y0b / +y1b
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float kdb = knot_adj<M, LEFT, RIGHT>(j, idx, d0b, d1b);
    if (LEFT && j == 0) kdb += idx == 0 ? -y0b : 0.0f;
    if (RIGHT && j == M - 1) kdb += idx == K - 2 ? y1b : 0.0f;
    const long long c = (long long)(2 * (M - 1) + j) * S;
    const float z = From::at(o + c) * kLn2;
    ob[c] = kdb * (1.0f / (1.0f + expf(-z)));
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
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites) return;
  const long long b = i / S;
  const long long s = i - b * S;
  const long long site = b * (long long)K3 * S + s;
  site_vjp<M, LEFT, RIGHT, INVERSE>(x, out + site, ybar, loggbar, xbar,
                                    outbar + site, S, i, xlo, xw, ylo, yw);
}

// The channels-last per-site kernel, for the shapes the channels-last tiled
// kernel below cannot take: out and outbar are (B, S, 3m-2), so the
// kClSites sites of a block are one contiguous run of kClSites (3m-2)
// floats in each.  The block copies out's run into a shared-memory stage
// with coalesced loads; each thread takes its site's VJP from its column
// (stride 1) into the same column of a second stage; the block stores that
// stage to outbar with coalesced stores.  The per-site kernel's arithmetic
// on the same values, so the same bits.
constexpr int kClSites = 128;  // sites per block, one thread each

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(kClSites)
rqs_coupling_bwd_cl_kernel(const float* __restrict__ x,
                           const float* __restrict__ out,
                           const float* __restrict__ ybar,
                           const float* __restrict__ loggbar,
                           float* __restrict__ xbar,
                           float* __restrict__ outbar, long long n_sites,
                           float xlo, float xw, float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  __shared__ float stage[kClSites * K3];
  __shared__ float stage_bar[kClSites * K3];
  const long long first = (long long)blockIdx.x * kClSites;
  const int n = (int)(n_sites - first < kClSites ? n_sites - first
                                                 : kClSites);
  const int t = threadIdx.x;
  for (int k = t; k < n * K3; k += kClSites)
    stage[k] = __ldg(out + first * K3 + k);
  __syncthreads();
  if (t < n)
    site_vjp<M, LEFT, RIGHT, INVERSE, FromShared>(
        x, stage + t * K3, ybar, loggbar, xbar, stage_bar + t * K3, 1,
        first + t, xlo, xw, ylo, yw);
  __syncthreads();
  for (int k = t; k < n * K3; k += kClSites)
    outbar[first * K3 + k] = stage_bar[k];
}

// The arguments of every C entry point.
struct Args {
  const float *x, *out, *ybar, *loggbar;
  float *xbar, *outbar;
  long long B, S;
  float xlo, xw, ylo, yw;
  cudaStream_t stream;
};

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_sites(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  const int threads = 256;
  const long long n = a.B * a.S;
  const long long blocks = (n + threads - 1) / threads;
  rqs_coupling_bwd_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, threads, 0, a.stream>>>(
          a.x, a.out, a.ybar, a.loggbar, a.xbar, a.outbar, n, a.S, a.xlo,
          a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_cl(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  const long long n = a.B * a.S;
  const long long blocks = (n + kClSites - 1) / kClSites;
  rqs_coupling_bwd_cl_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, kClSites, 0, a.stream>>>(
          a.x, a.out, a.ybar, a.loggbar, a.xbar, a.outbar, n, a.xlo, a.xw,
          a.ylo, a.yw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tiled kernel.  A tile is kTileSites consecutive sites of one sample;
// each of its R = 3m+1 rows (the 3m-2 channels of `out`, then x, ybar,
// loggbar) is kTileSites contiguous floats of global memory.  A ring of
// kStages shared-memory stages holds R x kTileSites floats each.  Warp 0
// fills a stage with one bulk copy per row (a row per lane), completing on
// the stage's mbarrier, kStages tiles ahead of the tile being computed;
// each thread takes one site, reads its column of the stage, and writes
// its adjoints over the same column (x's row takes xbar); the 3m-2 outbar
// rows and the xbar row leave by bulk stores, and the stage is refilled
// once the stores have read it.  The arithmetic is that of the per-site
// kernel above, operation for operation, except that the softmax's e_j of
// the first pass stay in the column (over w_j) and 1/sum e in a register,
// so the transposition reads them instead of recomputing the same values.

constexpr int kTileSites = 128;  // sites per tile, one thread each
constexpr int kStages = 2;       // tiles in flight per block

// Blocks of kTileSites threads per SM that __launch_bounds__ asks the
// register allocator to fit: 7 (at most 72 registers) up to m = 8; at
// m = 12 (34 channels) 4.  With the tile and ring sizes fixed at compile
// time the allocator uses every register it is given: at m = 8 on an H100,
// 8 blocks (64 registers, 80 bytes spilled) ran 10% slower than 7 (72, 48
// bytes spilled), and 6 (80, 20 bytes) 1-2% slower.
constexpr int min_blocks(int m) { return m <= 8 ? 7 : 4; }

// coords() of rqs_common.cuh on a shared-memory column: also leaves e_j in
// place of w_j and returns 1 / sum_j e_j in `inv`.
template <int M>
__device__ __forceinline__ void coords_smem(float* w, int stride, float lo,
                                            float width, float* k,
                                            float& inv) {
  float e[M - 1];
  float mx = w[0];
  e[0] = mx;
#pragma unroll
  for (int j = 1; j < M - 1; ++j) {
    e[j] = w[j * stride];
    mx = fmaxf(mx, e[j]);
  }
  float tot = 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    e[j] = expf(e[j] - mx);
    tot += e[j];
    w[j * stride] = e[j];
  }
  inv = 1.0f / tot;
  float cum = 0.0f;
  k[0] = lo + width * 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    cum += e[j];
    k[j + 1] = lo + width * (cum * inv);
  }
}

// coords_adjoint() on the e_j that coords_smem left in the column; writes
// the weights' adjoints over them.
template <int M, bool LEFT, bool RIGHT>
__device__ __forceinline__ void coords_adjoint_smem(float* w, int stride,
                                                   float inv, float width,
                                                   int idx, float b0,
                                                   float b1) {
  float cb[M - 1];
  float cum = 0.0f, A = 0.0f;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    cum += w[j * stride];
    cb[j] = width * knot_adj<M, LEFT, RIGHT>(j + 1, idx, b0, b1);
    A += cb[j] * (cum * inv);
  }
  float suffix = 0.0f;
#pragma unroll
  for (int i = M - 2; i >= 0; --i) {
    suffix += cb[i];
    w[i * stride] = (w[i * stride] * inv) * (suffix - A);
  }
}

// One site's VJP in a stage: its 3m-2 values of out at `o`, `cs` floats
// apart, receive outbar; its x at `xr` receives xbar, and its ybar and
// loggbar sit `rs` and 2 `rs` floats after x.  In the NCHW tiled kernel
// `o` is the site's column of the stage and the cells follow in it (cs =
// rs = ts, xr = o + (3m-2) ts); in the channels-last one `o` is the site's
// run in out's block (cs = 1) and xr its cell of x's row.
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__device__ __forceinline__ void site_vjp_smem(float* o, int cs, float* xr,
                                              int rs, float xlo, float xw,
                                              float ylo, float yw) {
  constexpr int L = LEFT ? 1 : 0;
  constexpr int K = M + L + (RIGHT ? 1 : 0);

  const float xv = xr[0];
  float invx, invy;
  Segment sg;
  {
    float kx[K], ky[K], kd[K];
    coords_smem<M>(o, cs, xlo, xw, kx + L, invx);
    coords_smem<M>(o + (M - 1) * cs, cs, ylo, yw, ky + L, invy);
#pragma unroll
    for (int j = 0; j < M; ++j)
      kd[L + j] = softplus_log2(o[(2 * (M - 1) + j) * cs]);
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

  const float gy = xr[rs];
  const float gl = xr[2 * rs];
  Adj a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float xb, x0b, dxb;
  if (!INVERSE) {
    lg_adjoint(theta, mm, spread, sg.d0, gl, a);
    f_adjoint(theta, mm, spread, sg.d0, dy, gy, a);
    xb = a.th / dx;
    x0b = -xb;
    dxb = -xb * theta;
  } else {
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
  xr[0] = xb;

  const float d1b = a.sp;
  const float d0b = a.d0 + a.sp;
  const float mmb = a.mm - 2.0f * a.sp;
  const float dyb = a.dy + mmb / dx;
  dxb += -mmb * mm / dx;
  const float x1b = dxb;
  x0b += -dxb;
  const float y1b = dyb;
  const float y0b = a.y0 - dyb;

  coords_adjoint_smem<M, LEFT, RIGHT>(o, cs, invx, xw, idx, x0b, x1b);
  coords_adjoint_smem<M, LEFT, RIGHT>(o + (M - 1) * cs, cs, invy, yw, idx,
                                      y0b, y1b);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float kdb = knot_adj<M, LEFT, RIGHT>(j, idx, d0b, d1b);
    if (LEFT && j == 0) kdb += idx == 0 ? -y0b : 0.0f;
    if (RIGHT && j == M - 1) kdb += idx == K - 2 ? y1b : 0.0f;
    float* w = o + (2 * (M - 1) + j) * cs;
    const float z = w[0] * kLn2;
    w[0] = kdb * (1.0f / (1.0f + expf(-z)));
  }
}

// Persistent: block k takes tiles k, k + gridDim.x, ...; tile -> (sample
// tile / tiles_per_sample, first site (tile % tiles_per_sample) * ts).
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(kTileSites, min_blocks(M))
rqs_coupling_bwd_tiled_kernel(const float* __restrict__ x,
                              const float* __restrict__ out,
                              const float* __restrict__ ybar,
                              const float* __restrict__ loggbar,
                              float* __restrict__ xbar,
                              float* __restrict__ outbar, long long S,
                              long long tiles_per_sample, long long n_tiles,
                              float xlo, float xw, float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int R = K3 + 3;
  constexpr int ts = kTileSites;
  static_assert(kStages * R * ts * sizeof(float) <= 48 * 1024,
                "the ring must fit in a block's static shared memory");
  __shared__ __align__(128) float smem[kStages * R * ts];
  __shared__ uint64_t full[kStages];
  const int t = threadIdx.x;

  if (t == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  // sample, first site and number of sites of a tile
  auto locate = [&](long long tile, long long& b, long long& s0, int& n) {
    b = tile / tiles_per_sample;
    s0 = (tile - b * tiles_per_sample) * ts;
    n = (int)(S - s0 < ts ? S - s0 : ts);
  };
  // warp 0 fills a stage: lane 0 arms the barrier, lane l copies rows
  // l, l + 32, ...
  const int lane = t & 31;
  auto load = [&](long long tile, int st) {
    long long b, s0;
    int n;
    locate(tile, b, s0, n);
    float* stage = smem + (long long)st * R * ts;
    const uint32_t bytes = (uint32_t)n * sizeof(float);
    if (lane == 0) mbar_arrive_expect_tx(&full[st], bytes * R);
    __syncwarp();
    for (int c = lane; c < R; c += 32) {
      const float* src = c < K3 ? out + (b * K3 + c) * S
                       : (c == K3 ? x : c == K3 + 1 ? ybar : loggbar) + b * S;
      bulk_load(stage + c * ts, src + s0, bytes, &full[st]);
    }
  };

  if (t < 32) {
    for (int st = 0; st < kStages; ++st) {
      const long long tile = blockIdx.x + (long long)st * gridDim.x;
      if (tile < n_tiles) load(tile, st);
    }
  }
  int st = 0;
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long b, s0;
    int n;
    locate(tile, b, s0, n);
    float* stage = smem + (long long)st * R * ts;
    float* o = stage + t;
    mbar_wait(&full[st], parity);
    if (t < n)
      site_vjp_smem<M, LEFT, RIGHT, INVERSE>(o, ts, o + K3 * ts, ts, xlo, xw,
                                             ylo, yw);
    fence_proxy_async();
    __syncthreads();
    if (t < 32) {  // lane l stores rows l, l + 32, ... (xbar's is K3)
      const uint32_t bytes = (uint32_t)n * sizeof(float);
      for (int c = lane; c <= K3; c += 32)
        bulk_store((c < K3 ? outbar + (b * K3 + c) * S : xbar + b * S) + s0,
                   stage + c * ts, bytes);
      bulk_commit();
      const long long next = tile + (long long)kStages * gridDim.x;
      if (next < n_tiles) {
        bulk_wait_read();
        __syncwarp();
        load(next, st);
      }
    }
    if (++st == kStages) {
      st = 0;
      parity ^= 1u;
    }
  }
  if (t < 32) bulk_wait_all();
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_tiled(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  auto kern = rqs_coupling_bwd_tiled_kernel<M, LEFT, RIGHT, INVERSE>;
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kTileSites, 0);
  const long long tps = (a.S + kTileSites - 1) / kTileSites;
  const long long tiles = a.B * tps;
  unsigned int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(per_sm, tiles, grid);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kTileSites, 0, a.stream>>>(
      a.x, a.out, a.ybar, a.loggbar, a.xbar, a.outbar, a.S, tps, tiles,
      a.xlo, a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The channels-last tiled kernel.  out and outbar are (B, S, 3m-2) and x,
// ybar, loggbar, xbar (B, S), all contiguous, so the B S sites are one run
// in each tensor and tile k is sites [k ts, k ts + ts) of that run.
//
// What bounds it: the NCHW tiled kernel's bytes (192 B per site at m = 8,
// 0.0150 ms at B = 512) and instructions.  The channels-last kernel it
// replaces on the route reached 0.47 of that bound cold: a block of 128
// sites loaded its run with plain loads, synchronised, computed and stored,
// one block per 128 sites with nothing in flight while it computed, and
// took each site's VJP as the per-site kernel does (the softmax's e_j
// computed twice).  The design:
// - the NCHW tiled kernel's persistent ring: a stage holds out's run of the
//   tile (K3 ts floats), then the tile's x, ybar and loggbar runs (ts
//   floats each), the same R ts floats, filled by four bulk copies that
//   thread 0 issues kStages tiles ahead;
// - site_vjp_smem in place: a thread reads its site's run at stage + t K3
//   (channel stride 1) and its cells at x's row + t, and writes outbar over
//   the run and xbar over x's cell, the NCHW tiled kernel's operations in
//   its order (the same bits);
// - outbar's run and xbar's leave by two bulk stores (outbar keeps out's
//   layout, so its tile is one run), and the stage is refilled once they
//   have read it.
// The column reads and writes meet gcd(K3, 32)-way bank conflicts (2 at
// m = 8), as in the forward.  Registers are capped as in the NCHW tiled
// kernel (min_blocks).  The bulk copies' rule: B S % 4 == 0 and every
// tensor 16-byte aligned.
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(kTileSites, min_blocks(M))
rqs_coupling_bwd_cl_tiled_kernel(const float* __restrict__ x,
                                 const float* __restrict__ out,
                                 const float* __restrict__ ybar,
                                 const float* __restrict__ loggbar,
                                 float* __restrict__ xbar,
                                 float* __restrict__ outbar,
                                 long long n_sites, long long n_tiles,
                                 float xlo, float xw, float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int R = K3 + 3;
  constexpr int ts = kTileSites;
  static_assert(kStages * R * ts * sizeof(float) <= 48 * 1024,
                "the ring must fit in a block's static shared memory");
  __shared__ __align__(128) float smem[kStages * R * ts];
  __shared__ uint64_t full[kStages];
  const int t = threadIdx.x;

  if (t == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  // first site and number of sites of a tile
  auto locate = [&](long long tile, long long& first, uint32_t& n) {
    first = tile * ts;
    n = (uint32_t)(n_sites - first < ts ? n_sites - first : ts);
  };
  // thread 0 fills a stage: out's run of the tile, then x's, ybar's and
  // loggbar's
  auto load = [&](long long tile, int st) {
    long long first;
    uint32_t n;
    locate(tile, first, n);
    float* stage = smem + st * R * ts;
    const uint32_t bytes = n * (uint32_t)sizeof(float);
    mbar_arrive_expect_tx(&full[st], bytes * R);
    bulk_load(stage, out + first * K3, bytes * K3, &full[st]);
    bulk_load(stage + K3 * ts, x + first, bytes, &full[st]);
    bulk_load(stage + (K3 + 1) * ts, ybar + first, bytes, &full[st]);
    bulk_load(stage + (K3 + 2) * ts, loggbar + first, bytes, &full[st]);
  };

  if (t == 0) {
    for (int st = 0; st < kStages; ++st) {
      const long long tile = blockIdx.x + (long long)st * gridDim.x;
      if (tile < n_tiles) load(tile, st);
    }
  }
  int st = 0;
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long first;
    uint32_t n;
    locate(tile, first, n);
    float* stage = smem + st * R * ts;
    mbar_wait(&full[st], parity);
    if (t < (int)n)
      site_vjp_smem<M, LEFT, RIGHT, INVERSE>(stage + t * K3, 1,
                                             stage + K3 * ts + t, ts, xlo, xw,
                                             ylo, yw);
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      const uint32_t bytes = n * (uint32_t)sizeof(float);
      bulk_store(outbar + first * K3, stage, bytes * K3);
      bulk_store(xbar + first, stage + K3 * ts, bytes);
      bulk_commit();
      const long long next = tile + (long long)kStages * gridDim.x;
      if (next < n_tiles) {
        bulk_wait_read();
        load(next, st);
      }
    }
    if (++st == kStages) {
      st = 0;
      parity ^= 1u;
    }
  }
  if (t == 0) bulk_wait_all();
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_cl_tiled(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  auto kern = rqs_coupling_bwd_cl_tiled_kernel<M, LEFT, RIGHT, INVERSE>;
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kTileSites, 0);
  const long long n = a.B * a.S;
  const long long tiles = (n + kTileSites - 1) / kTileSites;
  unsigned int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(per_sm, tiles, grid);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kTileSites, 0, a.stream>>>(a.x, a.out, a.ybar, a.loggbar,
                                          a.xbar, a.outbar, n, tiles, a.xlo,
                                          a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

Args args_of(const void* x, const void* out, const void* ybar,
             const void* loggbar, void* xbar, void* outbar, long long B,
             long long S, float xlo, float xw, float ylo, float yw,
             void* stream) {
  return {static_cast<const float*>(x), static_cast<const float*>(out),
          static_cast<const float*>(ybar), static_cast<const float*>(loggbar),
          static_cast<float*>(xbar), static_cast<float*>(outbar), B, S, xlo,
          xw, ylo, yw, static_cast<cudaStream_t>(stream)};
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
  const Args a = args_of(x, out, ybar, loggbar, xbar, outbar, B, S, xlo, xw,
                         ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_sites(inst, a); });
}

// The tiled kernel on the same arguments, for S % 4 == 0 and every pointer
// 16-byte aligned (the bulk copies' rule; the wrapper sends other shapes to
// rqs_coupling_bwd_f32).  Returns cudaErrorInvalidValue for arguments it
// does not take, else cudaGetLastError() after the launch.
extern "C" int rqs_coupling_bwd_tiled_f32(
    const void* x, const void* out, const void* ybar, const void* loggbar,
    void* xbar, void* outbar, long long B, long long S, int m, float xlo,
    float xw, float ylo, float yw, int left_linear, int right_linear,
    int inverse, void* stream) {
  const void* ptrs[6] = {x, out, ybar, loggbar, xbar, outbar};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (S % 4 || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Args a = args_of(x, out, ybar, loggbar, xbar, outbar, B, S, xlo, xw,
                         ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_tiled(inst, a); });
}

// The channels-last per-site kernel: x, ybar, loggbar, xbar (B, S); out,
// outbar (B, S, 3m-2); all float32, contiguous.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a knot count without a template
// instance.
extern "C" int rqs_coupling_bwd_cl_f32(const void* x, const void* out,
                                       const void* ybar, const void* loggbar,
                                       void* xbar, void* outbar, long long B,
                                       long long S, int m, float xlo,
                                       float xw, float ylo, float yw,
                                       int left_linear, int right_linear,
                                       int inverse, void* stream) {
  const Args a = args_of(x, out, ybar, loggbar, xbar, outbar, B, S, xlo, xw,
                         ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_cl(inst, a); });
}

// The channels-last tiled kernel on the same arguments, for B S % 4 == 0
// and every pointer 16-byte aligned (the bulk copies' rule; the wrapper
// sends other shapes to rqs_coupling_bwd_cl_f32).  Returns
// cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError() after the launch.
extern "C" int rqs_coupling_bwd_cl_tiled_f32(
    const void* x, const void* out, const void* ybar, const void* loggbar,
    void* xbar, void* outbar, long long B, long long S, int m, float xlo,
    float xw, float ylo, float yw, int left_linear, int right_linear,
    int inverse, void* stream) {
  const void* ptrs[6] = {x, out, ybar, loggbar, xbar, outbar};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if ((B * S) % 4 || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Args a = args_of(x, out, ybar, loggbar, xbar, outbar, B, S, xlo, xw,
                         ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_cl_tiled(inst, a); });
}
