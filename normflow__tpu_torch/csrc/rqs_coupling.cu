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
// What bounds it on an H100: bytes, with instructions close behind.  A
// site reads 4 B of x and 4(3m-2) B of conditioner output and writes 8 B;
// at m = 8 that is 100 B per site, 52 MB per launch at B = 1024 and 512
// packed sites, 0.0157 ms at 3.35 TB/s.  Its arithmetic is IEEE float32
// with no contraction (--fmad=false: the same bits as the plain version's
// order of operations): 14 expf for the two softmaxes, a softplus_log2 per
// derivative (an expf, a log1pf and a division), half a dozen divisions
// and a logf.  Computing all m derivatives, as the per-site kernel does,
// that is about a thousand SASS instructions per site, whose issue alone
// takes as long as the bytes (0.0153 ms).  Two variants for the NCHW
// layout, (B, 3m-2, S), chosen by the wrapper by shape and alignment:
// - the tiled kernel (rqs_coupling_tiled_f32, the path's): persistent
//   blocks stage tiles of kTileSites sites through a ring of shared-memory
//   stages with bulk copies (bulk_copy.cuh), the next tiles arriving while
//   this one computes, so every warp's arithmetic overlaps the bytes; and
//   it evaluates softplus_log2 only on the derivatives the site uses (2 in
//   the forward, up to 4 in the inverse, of m), which cuts a site's
//   instructions by two fifths forward and a quarter inverse (598 and 743
//   of 977 and 1001 at m = 8) and changes no bit (notes at the kernel);
// - the per-site kernel (rqs_coupling_f32) for S % 4 != 0 or an address
//   off 16 bytes, which the bulk copies cannot take: one thread per
//   (sample, site), per-channel loads coalesced across neighbouring
//   threads, no shared memory.
// and two for the channels-last layout, (B, S, 3m-2), a conv's NHWC output
// as the Pallas kernel's `channels_last=True` reads it (the `pallas_reg`
// route), which the wrapper takes for a channels-last `out`, where the
// B S sites are one contiguous run of out and of x:
// - the channels-last tiled kernel (rqs_coupling_cl_tiled_f32, the
//   route's): the NCHW tiled kernel's ring and arithmetic on flat tiles of
//   the run, a tile staged by two bulk copies (notes at the kernel);
// - the channels-last per-site kernel (rqs_coupling_cl_f32) for B S % 4
//   != 0 or an address off 16 bytes: the per-site kernel with a site's
//   channels one contiguous run.
// In all four, m is a template parameter and the knot loops are unrolled,
// so the knot arrays live in registers and the segment "gather" is a chain
// of selects with static indices (as the Pallas kernel unrolled the knot
// axis).  The four return the same bits.

#include "bulk_copy.cuh"
#include "rqs_common.cuh"

namespace {

// The rational-quadratic map of xv on the segment sg, or its inverse: y,
// and lg = log dy/dx (-log of the forward's for the inverse).
template <bool INVERSE>
__device__ __forceinline__ void rq_map(float xv, const Segment& sg, float& y,
                                       float& lg) {
  const float dx = sg.x1 - sg.x0;
  const float dy = sg.y1 - sg.y0;
  const float mm = dy / dx;
  const float spread = sg.d1 + sg.d0 - 2.0f * mm;

  float theta;
  if (!INVERSE) {
    theta = (xv - sg.x0) / dx;
    const float denom = mm + spread * theta * (1.0f - theta);
    y = sg.y0 + dy * theta * (mm * theta + sg.d0 * (1.0f - theta)) / denom;
  } else {
    theta = inverse_theta(xv, sg.y0, dy, mm, spread, sg.d0);
    y = sg.x0 + dx * theta;
  }
  const float denom = mm + spread * theta * (1.0f - theta);
  const float num = sg.d0 + 2.0f * (mm - sg.d0) * theta +
                    spread * theta * theta;
  const float l = logf(mm * mm * num / (denom * denom));
  lg = INVERSE ? -l : l;
}

// Site i of a per-site kernel: its 3m-2 conditioner values start at `o`,
// `cs` floats apart (S in NCHW, 1 channels-last).
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__device__ __forceinline__ void site_map(const float* __restrict__ x,
                                         const float* __restrict__ o,
                                         long long cs, long long i,
                                         float* __restrict__ y,
                                         float* __restrict__ logg, float xlo,
                                         float xw, float ylo, float yw) {
  constexpr int K = M + (LEFT ? 1 : 0) + (RIGHT ? 1 : 0);
  float kx[K], ky[K], kd[K];
  knots<M, LEFT, RIGHT>(o, cs, xlo, xw, ylo, yw, kx, ky, kd);
  const float xv = __ldg(x + i);
  rq_map<INVERSE>(xv, segment<K, INVERSE>(xv, kx, ky, kd), y[i], logg[i]);
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(256)
rqs_coupling_kernel(const float* __restrict__ x, const float* __restrict__ out,
                    float* __restrict__ y, float* __restrict__ logg,
                    long long n_sites, long long S, float xlo, float xw,
                    float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites) return;
  const long long b = i / S;
  const long long s = i - b * S;
  site_map<M, LEFT, RIGHT, INVERSE>(x, out + b * (long long)K3 * S + s, S, i,
                                    y, logg, xlo, xw, ylo, yw);
}

// The channels-last per-site kernel, for the shapes the channels-last
// tiled kernel below cannot take: `out` is (B, S, 3m-2), a site's values
// one contiguous run.  The per-site kernel's arithmetic on the same values,
// so the same bits.  A warp's loads are 4 bytes at a stride of 4(3m-2)
// bytes: each line comes from memory once, then from L1.
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(256)
rqs_coupling_cl_kernel(const float* __restrict__ x,
                       const float* __restrict__ out, float* __restrict__ y,
                       float* __restrict__ logg, long long n_sites,
                       float xlo, float xw, float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites) return;
  site_map<M, LEFT, RIGHT, INVERSE>(x, out + i * K3, 1, i, y, logg, xlo, xw,
                                    ylo, yw);
}

// The arguments of every C entry point.
struct Args {
  const float *x, *out;
  float *y, *logg;
  long long B, S;
  float xlo, xw, ylo, yw;
  cudaStream_t stream;
};

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_sites(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  const int threads = 256;
  const long long n = a.B * a.S;
  const long long blocks = (n + threads - 1) / threads;
  rqs_coupling_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, threads, 0, a.stream>>>(
          a.x, a.out, a.y, a.logg, n, a.S, a.xlo, a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_cl(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  const int threads = 256;
  const long long n = a.B * a.S;
  const long long blocks = (n + threads - 1) / threads;
  rqs_coupling_cl_kernel<M, LEFT, RIGHT, INVERSE>
      <<<(unsigned int)blocks, threads, 0, a.stream>>>(
          a.x, a.out, a.y, a.logg, n, a.xlo, a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tiled kernel.  A tile is kTileSites consecutive sites of one sample;
// each of its R = 3m-1 rows (the 3m-2 channels of `out`, then x) is
// kTileSites contiguous floats of global memory.  A ring of stages(m)
// shared-memory stages holds R x kTileSites floats each.  Warp 0 fills a
// stage with one bulk copy per row (a row per lane), completing on the
// stage's mbarrier, a whole ring ahead of the tile being computed; each
// thread takes one site, reads its column of the stage, and stores y and
// log g straight to global memory (coalesced across the warp); once every
// thread has read the stage, warp 0 refills it.  The arithmetic is that of
// the per-site kernel, operation for operation, except that softplus_log2
// runs only on the raw derivative weights the site uses (segment_smem).

// Tile width, ring depth and register cap, from a sweep on an H100 (m = 8,
// B = 1024; normflow__tpu_torch/tools/const_sweep.py, PERF.md): tiles of
// 128 sites in rings of 2, 3 or 4 stages and of 64 sites all ran slower
// (1-7% cold, up to 15% warm), and y and log g sent from the stage by bulk
// stores no faster than the coalesced stores below.  At m = 8 the ring of
// two 256-site stages (47 KB) lets 4 blocks share an SM's 228 KB, and
// __launch_bounds__ asks ptxas for those 4 (at most 64 registers: 50
// forward, 54 inverse).
constexpr int kTileSites = 256;  // sites per tile, one thread each
constexpr int kStages = 2;       // tiles in flight per block
constexpr int kMinBlocks = 4;    // blocks per SM asked of ptxas

// Stages of the ring at m knots: kStages, or as many as the 48 KB of
// static shared memory hold (the mbarriers beside them): one at m = 12,
// whose tile is then loaded while no other tile of the block computes.
__host__ __device__ constexpr int stages(int m) {
  const int fit = (48 * 1024 - 256) / ((3 * m - 1) * kTileSites * 4);
  return fit < kStages ? fit : kStages;
}

// knots() + segment() of rqs_common.cuh for a site whose conditioner values
// sit in a stage column `o` (rows `ts` floats apart), with softplus_log2
// evaluated only on the raw derivative weights the site uses: the
// segment's two and, for the inverse's search over the y knots, the first
// and last where a linear boundary knot needs them.  The forward's
// boundary y knot is read only on the boundary segment, whose own
// derivative is the one it needs.  softplus_log2 is a pure function of one
// float, so the segment has the bits of knots() + segment().
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__device__ __forceinline__ Segment segment_smem(float xv, const float* o,
                                                int ts, float xlo, float xw,
                                                float ylo, float yw) {
  constexpr int L = LEFT ? 1 : 0;
  constexpr int K = M + L + (RIGHT ? 1 : 0);
  const float* wd = o + 2 * (M - 1) * ts;  // the raw derivative weights

  float kx[K], ky[K];
  coords<M, FromShared>(o, ts, xlo, xw, kx + L);
  coords<M, FromShared>(o + (M - 1) * ts, ts, ylo, yw, ky + L);
  if (LEFT) kx[0] = kx[1] - 1.0f;
  if (RIGHT) kx[K - 1] = kx[K - 2] + 1.0f;
  if (INVERSE) {
    if (LEFT) ky[0] = ky[1] - softplus_log2(wd[0]);
    if (RIGHT) ky[K - 1] = ky[K - 2] + softplus_log2(wd[(M - 1) * ts]);
  }

  int idx = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) idx += (xv > (INVERSE ? ky[j] : kx[j])) ? 1 : 0;
  idx = min(max(idx, 1), K - 1) - 1;

  // knot j's derivative is softplus_log2 of raw weight clamp(j - L, 0, M-1)
  float w0 = 0.0f, w1 = 0.0f;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (idx == j) {
      w0 = wd[min(max(j - L, 0), M - 1) * ts];
      w1 = wd[min(max(j + 1 - L, 0), M - 1) * ts];
    }
  }
  Segment sg = {idx, 0.0f, 0.0f, 0.0f, 0.0f, softplus_log2(w0),
                softplus_log2(w1)};
  if (!INVERSE) {  // on the boundary segments kd[1] is d1, kd[K-2] is d0
    if (LEFT) ky[0] = ky[1] - sg.d1;
    if (RIGHT) ky[K - 1] = ky[K - 2] + sg.d0;
  }
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (idx == j) {
      sg.x0 = kx[j]; sg.x1 = kx[j + 1];
      sg.y0 = ky[j]; sg.y1 = ky[j + 1];
    }
  }
  return sg;
}

// Persistent: block k takes tiles k, k + gridDim.x, ...; tile -> (sample
// tile / tiles_per_sample, first site (tile % tiles_per_sample) * ts).
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(kTileSites, kMinBlocks)
rqs_coupling_tiled_kernel(const float* __restrict__ x,
                          const float* __restrict__ out,
                          float* __restrict__ y, float* __restrict__ logg,
                          long long S, long long tiles_per_sample,
                          long long n_tiles, float xlo, float xw, float ylo,
                          float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int R = K3 + 1;
  constexpr int ts = kTileSites;
  constexpr int NS = stages(M);
  static_assert(NS >= 1, "a stage must fit in static shared memory");
  __shared__ __align__(128) float smem[NS * R * ts];
  __shared__ uint64_t full[NS];
  const int t = threadIdx.x;

  if (t == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(&full[st], 1);
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
    float* stage = smem + st * R * ts;
    const uint32_t bytes = (uint32_t)n * sizeof(float);
    if (lane == 0) mbar_arrive_expect_tx(&full[st], bytes * R);
    __syncwarp();
    for (int c = lane; c < R; c += 32) {
      const float* src = c < K3 ? out + (b * K3 + c) * S : x + b * S;
      bulk_load(stage + c * ts, src + s0, bytes, &full[st]);
    }
  };

  if (t < 32) {
    for (int st = 0; st < NS; ++st) {
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
    const float* o = smem + st * R * ts + t;
    mbar_wait(&full[st], parity);
    if (t < n) {
      const float xv = o[K3 * ts];
      float yv, lg;
      rq_map<INVERSE>(xv,
                      segment_smem<M, LEFT, RIGHT, INVERSE>(xv, o, ts, xlo,
                                                            xw, ylo, yw),
                      yv, lg);
      y[b * S + s0 + t] = yv;
      logg[b * S + s0 + t] = lg;
    }
    __syncthreads();  // every thread has read the stage
    if (t < 32) {
      const long long next = tile + (long long)NS * gridDim.x;
      if (next < n_tiles) load(next, st);
    }
    if (++st == NS) {
      st = 0;
      parity ^= 1u;
    }
  }
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_tiled(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  auto kern = rqs_coupling_tiled_kernel<M, LEFT, RIGHT, INVERSE>;
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
  kern<<<grid, kTileSites, 0, a.stream>>>(a.x, a.out, a.y, a.logg, a.S, tps,
                                          tiles, a.xlo, a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The channels-last tiled kernel.  `out` is (B, S, 3m-2) and x, y, log g
// are (B, S), all contiguous, so the B S sites are one run in each tensor
// and tile k is sites [k ts, k ts + ts) of that run: no sample to locate,
// and a tile of out is one contiguous block of ts (3m-2) floats.
//
// What bounds it: the same bytes as the NCHW tiled kernel (100 B per site
// at m = 8, 0.0157 ms at B = 1024), and the same instructions once
// softplus_log2 runs only where the site needs it.  The per-site
// channels-last kernel reached 0.45 of that bound cold: one thread per
// site with no shared memory, a warp's loads 4 bytes at a stride of
// 4 (3m-2) bytes, nothing in flight while a warp computes, and all m
// derivatives evaluated.  The design:
// - the NCHW tiled kernel's ring: a stage holds out's run of the tile
//   (K3 ts floats) and then x's (ts floats), the same R ts floats, so
//   stages(m) and the 4 blocks per SM at m = 8 carry over; thread 0 arms
//   the stage's mbarrier and issues two bulk copies (not 3m-1 row copies),
//   a whole ring ahead of the tile being computed;
// - a thread takes one site and reads its column at stage + t K3 with a
//   channel stride of 1 (segment_smem with ts = 1, so softplus_log2 on
//   the site's derivatives only, the same operations in the same order as
//   the NCHW tiled kernel: the same bits);
// - y and log g go straight to global memory, coalesced across the warp.
// The column reads meet bank conflicts: a warp's 32 columns start K3 words
// apart, so gcd(K3, 32) threads share a bank, 2 at m = 4, 8 and 12 and 16
// at m = 6 (K3 = 16).  Shared memory is far from this kernel's bound at
// m = 8, the path's.  The bulk copies need every run a multiple of 16
// bytes at 16-byte aligned addresses: with tiles of a multiple of 4 sites
// that is B S % 4 == 0 and every tensor 16-byte aligned, the wrapper's
// rule for this variant.
template <int M, bool LEFT, bool RIGHT, bool INVERSE>
__global__ void __launch_bounds__(kTileSites, kMinBlocks)
rqs_coupling_cl_tiled_kernel(const float* __restrict__ x,
                             const float* __restrict__ out,
                             float* __restrict__ y, float* __restrict__ logg,
                             long long n_sites, long long n_tiles, float xlo,
                             float xw, float ylo, float yw) {
  constexpr int K3 = 3 * M - 2;
  constexpr int R = K3 + 1;
  constexpr int ts = kTileSites;
  constexpr int NS = stages(M);
  static_assert(NS >= 1, "a stage must fit in static shared memory");
  __shared__ __align__(128) float smem[NS * R * ts];
  __shared__ uint64_t full[NS];
  const int t = threadIdx.x;

  if (t == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(&full[st], 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  // thread 0 fills a stage: out's run of the tile, then x's
  auto load = [&](long long tile, int st) {
    const long long first = tile * ts;
    const long long left = n_sites - first;
    const uint32_t n = (uint32_t)(left < ts ? left : ts);
    float* stage = smem + st * R * ts;
    mbar_arrive_expect_tx(&full[st], n * R * (uint32_t)sizeof(float));
    bulk_load(stage, out + first * K3, n * K3 * (uint32_t)sizeof(float),
              &full[st]);
    bulk_load(stage + K3 * ts, x + first, n * (uint32_t)sizeof(float),
              &full[st]);
  };

  if (t == 0) {
    for (int st = 0; st < NS; ++st) {
      const long long tile = blockIdx.x + (long long)st * gridDim.x;
      if (tile < n_tiles) load(tile, st);
    }
  }
  int st = 0;
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i = tile * ts + t;
    const float* stage = smem + st * R * ts;
    mbar_wait(&full[st], parity);
    if (i < n_sites) {
      const float xv = stage[K3 * ts + t];
      float yv, lg;
      rq_map<INVERSE>(xv,
                      segment_smem<M, LEFT, RIGHT, INVERSE>(
                          xv, stage + t * K3, 1, xlo, xw, ylo, yw),
                      yv, lg);
      y[i] = yv;
      logg[i] = lg;
    }
    __syncthreads();  // every thread has read the stage
    if (t == 0) {
      const long long next = tile + (long long)NS * gridDim.x;
      if (next < n_tiles) load(next, st);
    }
    if (++st == NS) {
      st = 0;
      parity ^= 1u;
    }
  }
}

template <int M, bool LEFT, bool RIGHT, bool INVERSE>
int launch_cl_tiled(Inst<M, LEFT, RIGHT, INVERSE>, const Args& a) {
  auto kern = rqs_coupling_cl_tiled_kernel<M, LEFT, RIGHT, INVERSE>;
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
  kern<<<grid, kTileSites, 0, a.stream>>>(a.x, a.out, a.y, a.logg, n, tiles,
                                          a.xlo, a.xw, a.ylo, a.yw);
  return (int)cudaGetLastError();
}

Args args_of(const void* x, const void* out, void* y, void* logg,
             long long B, long long S, float xlo, float xw, float ylo,
             float yw, void* stream) {
  return {static_cast<const float*>(x), static_cast<const float*>(out),
          static_cast<float*>(y), static_cast<float*>(logg), B, S, xlo, xw,
          ylo, yw, static_cast<cudaStream_t>(stream)};
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
  const Args a = args_of(x, out, y, logg, B, S, xlo, xw, ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_sites(inst, a); });
}

// The tiled kernel on the same arguments, for S % 4 == 0 and every pointer
// 16-byte aligned (the bulk copies' rule; the wrapper sends other shapes to
// rqs_coupling_f32).  Returns cudaErrorInvalidValue for arguments it does
// not take, else cudaGetLastError() after the launch.
extern "C" int rqs_coupling_tiled_f32(const void* x, const void* out, void* y,
                                      void* logg, long long B, long long S,
                                      int m, float xlo, float xw, float ylo,
                                      float yw, int left_linear,
                                      int right_linear, int inverse,
                                      void* stream) {
  const void* ptrs[4] = {x, out, y, logg};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (S % 4 || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Args a = args_of(x, out, y, logg, B, S, xlo, xw, ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_tiled(inst, a); });
}

// The channels-last per-site kernel: x, y and logg (B, S), out (B, S,
// 3m-2), the layout of a conv's channels-last output; all float32,
// contiguous.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a knot count without a template instance.
extern "C" int rqs_coupling_cl_f32(const void* x, const void* out, void* y,
                                   void* logg, long long B, long long S,
                                   int m, float xlo, float xw, float ylo,
                                   float yw, int left_linear,
                                   int right_linear, int inverse,
                                   void* stream) {
  const Args a = args_of(x, out, y, logg, B, S, xlo, xw, ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_cl(inst, a); });
}

// The channels-last tiled kernel on the same arguments, for B S % 4 == 0
// and every pointer 16-byte aligned (the bulk copies' rule; the wrapper
// sends other shapes to rqs_coupling_cl_f32).  Returns
// cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError() after the launch.
extern "C" int rqs_coupling_cl_tiled_f32(const void* x, const void* out,
                                         void* y, void* logg, long long B,
                                         long long S, int m, float xlo,
                                         float xw, float ylo, float yw,
                                         int left_linear, int right_linear,
                                         int inverse, void* stream) {
  const void* ptrs[4] = {x, out, y, logg};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if ((B * S) % 4 || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const Args a = args_of(x, out, y, logg, B, S, xlo, xw, ylo, yw, stream);
  return visit(m, left_linear, right_linear, inverse,
               [&](auto inst) { return launch_cl_tiled(inst, a); });
}
