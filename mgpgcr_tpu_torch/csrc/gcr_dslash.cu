// K2: the one-pass GCR step of the unpreconditioned restart solve, and B9:
// its preconditioned twin (the z-step).
//
// K2 (gcr_stream_step):
//   r'  = r - alpha aps[lim-1]            (written out)
//   az  = (I - k D) r'                    (written out)
//   r2  = ||r'||^2
//   raw_j = <aps_j, az>, apr_j = <aps_j, r'>   for j < lim (zeros above)
//   apr_S = <az, r'>
// B9 (gcr_z_step), with z = M(r) the preconditioner's output:
//   az  = (I - k D) z                     (written out)
//   raw_j = <aps_j, az>, apr_j = <aps_j, r>    for j < lim (zeros above)
//   apr_S = <az, r>
//
// K2 replaces mgpgcr_tpu/ops/pallas/gcr_dslash.py::_gcr_step_kernel (via
// gcr_stream_step), B9 replaces ::_gcr_z_kernel (via gcr_z_step). The TPU
// kernels carry the stencil input's planes of t-1 and t in VMEM while they
// stream t. Blocks on a GPU share nothing, and the stencil needs its input
// at the 8 neighbours. K2 therefore RECOMPUTES r' = r - alpha ap at every
// neighbour from r and aps[lim-1] (RPrimeLoad) instead of running a
// separate residual pass: one launch, no r' round trip through DRAM, at
// the price of twice the neighbour gathers, which L2 serves. B9's stencil
// input z depends on nothing else, so it gathers z plainly (FieldLoad) and
// reads r only at the thread's own site, for the dots. Both are one
// template: the ZSTEP flag picks the stencil input and drops r' and r2.
//
// Bound on an H100: bytes. DRAM must see the links, the stencil input's
// sources and aps[0:lim] once each and the outputs written once: for K2
// 192 + (1 + lim) * 96 + 2 * 96 B per site with two-row f32 links, for
// B9 192 + (2 + lim) * 96 + 96. The dots are epilogue arithmetic on values
// already in registers plus one read of each aps_j at the thread's own
// site.
//
// B15 (gcr_stream_step_dist): K2 on one shard of a lattice split over
// (t, z) (HALO). Replaces mgpgcr_tpu/ops/pallas/gcr_dslash_dist.py::
// _gcr_step_dist_kernel (via gcr_stream_step_local). The stencil's
// neighbours across the shard's edges are the ghost planes of common.cuh
// Halo, which the neighbouring ranks formed as r' = r - alpha ap on their
// faces and the host signed; the RPrimeLoad axpy applies to interior
// neighbours only, never to a ghost. The dots are this shard's partials:
// the solver sums them over ranks. Bound: bytes, K2's plus the ghosts read
// once.
//
// What bounds the three on an H100: bytes (above), against a stencil whose
// 8 neighbour gathers and, for K2, their r' recomputation go through L1/L2.
// What held the first design back: one thread per site at 146-152
// registers, so one 256-thread block of 8 warps per SM: too few loads in
// flight for HBM, and on B15's shard 1024 blocks ran as 7.8 waves. After
// the stencil, each of the 4 lim + 3 dot values went through its own f64
// warp-shuffle chain (block_put) inside the loop over the directions, so
// the next direction's loads waited behind shuffles; and the block
// partials were laid out block-major, so the cross-block pass read them at
// a stride of 4 S + 3 doubles.
//
// This design keeps one thread per site for the stencil and remaps the
// rest of the work:
// - __launch_bounds__(256, 2): at most 128 registers, two resident blocks
//   (16 warps) per SM, so twice the bytes in flight and half the waves.
//   The launcher hands K2 the aps[lim-1] slot as a kernel argument, so no
//   pointer is formed and held in registers for it. At this cap ptxas may
//   still spill a few bytes of addresses in some instances (its -Xptxas -v
//   report; chip_smoke.py prints it).
// - The dots are staged, not shuffled: each lane writes its per-site
//   values into its warp's tile in shared memory (16 values x 32 lanes,
//   padded against bank conflicts) as soon as they are formed, and when 16
//   are staged the warp reduces them in one batched pass in which lane v
//   adds value v's entries (two lanes a value, 16 entries each); the loop
//   over directions (unrolled by two for K2 and B15) starts its loads back
//   to back. The warps' sums are added per block and written value-major
//   (partials[i * blocks + b]), and the cross-block pass reads each value's
//   partials contiguously.
// - The r' recomputation at the neighbours (RPrimeLoad) stays: it costs L2
//   reads, not DRAM bytes. A separate r' pass would add a DRAM round trip
//   of r' (96 B a site) and a launch; staging r' of the block's own sites
//   in shared memory (x and most y neighbours) and two threads a site (one
//   half-spinor component each, 18 accumulators instead of 24) both
//   measured slower on the card.
//
// Dot products, fixed order, no atomics: f32 over a site's 12 components
// in (s, c) order within a thread; f64 from the warp on: in a warp, lanes
// 0-15 and lanes 16-31 each in lane order, then the two halves added; the
// block's 8 warp sums in warp order; reduce_partials adds the blocks'
// partials in its fixed order (a strided sum per thread, then a tree).
// alpha and k are read from device memory, so no iteration waits on the
// host.
#include "common.cuh"

namespace mg {

// output layout of res (floats): raw (S complex), apr (S + 1 complex), r2
__host__ __device__ __forceinline__ int n_values(int S) { return 2 * S + 2 * (S + 1) + 1; }

// The staged values of a step come in the order raw_j, apr_j (re, im each)
// for j < lim, then apr_S = <az, r'>, then r2: 4 lim + 3 values. The index
// among them of output value i (n_values layout), or -1 for the rows from
// lim on, which are zero.
__device__ __forceinline__ int staged_index(int i, int S, int lim) {
  if (i < 4 * S) {
    const int apr = i >= 2 * S;
    const int j = (i - apr * 2 * S) >> 1;
    return j < lim ? 4 * j + 2 * apr + (i & 1) : -1;
  }
  return 4 * lim + (i - 4 * S);
}

constexpr int kChunk = 16;  // values staged per lane before a warp reduces them

// One warp's staging tile and the warp's sums of the values reduced so far.
// ``put`` is called by every lane of the warp with the same count.
struct WarpStage {
  float (*tile)[33];  // [kChunk][32 lanes + 1 pad]
  double* sums;       // this warp's row of the block's sums
  int fill, base;

  __device__ __forceinline__ void put(float v) {
    tile[fill][threadIdx.x & 31] = v;
    if (++fill == kChunk) flush();
  }

  // value v's 32 lane entries in f64: lanes 0-15 and 16-31 in lane order,
  // then the halves added
  __device__ __forceinline__ void flush() {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const int v = lane & (kChunk - 1), half = lane >> 4;
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < 16; ++c) s += static_cast<double>(tile[v][half * 16 + c]);
    s += __shfl_down_sync(0xffffffffu, s, 16);
    if (lane < fill) sums[base + lane] = s;
    __syncwarp();
    base += fill;
    fill = 0;
  }
};

// the stencil input: r' = r - alpha aps[lim-1] (K2) or z (B9)
template <bool ZSTEP> struct StepLoad { using type = RPrimeLoad; };
template <> struct StepLoad<true> { using type = FieldLoad; };

template <int R, typename LT, bool ZSTEP, bool HALO>
__global__ void __launch_bounds__(kThreads, 2)
gcr_step_kernel(const float* __restrict__ rre, const float* __restrict__ rim,
                const float* __restrict__ aps_re, const float* __restrict__ aps_im,
                const float* __restrict__ zre, const float* __restrict__ zim,
                const LT* __restrict__ ure, const LT* __restrict__ uim,
                const float* __restrict__ alpha, const float* __restrict__ k,
                float* __restrict__ rp_re, float* __restrict__ rp_im, float* __restrict__ az_re,
                float* __restrict__ az_im, double* __restrict__ partials, int S, int lim, int T,
                int Z, int Y, int X, int anti_t, const __grid_constant__ Halo<LT> h) {
  __shared__ float tiles[kWarps][kChunk][33];
  extern __shared__ double sums[];  // [kWarps][4 lim + 3]
  const Geom g(T, Z, Y, X);
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < g.N;

  // rp: the dots' second vector, r' (K2) or r (B9)
  cf rp[4][3], az[4][3];
  float r2 = 0.f;
  if (live) {
    // the stencil input; for K2 the launcher points (zre, zim) at
    // aps[lim-1], so that no pointer is formed here and kept live
    typename StepLoad<ZSTEP>::type L;
    if constexpr (ZSTEP)
      L = FieldLoad{zre, zim, g.N};
    else
      L = RPrimeLoad{rre, rim, zre, zim, {alpha[0], alpha[1]}, g.N};
    dslash_site<R, LT, false, HALO>(L, ure, uim, g, n, anti_t != 0, az, &h);
    const cf kk = {k[0], k[1]};
    const FieldLoad Rd{rre, rim, g.N};
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const cf psi = L(s, c, n);
        az[s][c] = csub(psi, cmul(kk, az[s][c]));
        const int o = (s * 3 + c) * g.N + n;
        az_re[o] = az[s][c].re;
        az_im[o] = az[s][c].im;
        if constexpr (ZSTEP) {
          rp[s][c] = Rd(s, c, n);
        } else {
          rp[s][c] = psi;
          rp_re[o] = psi.re;
          rp_im[o] = psi.im;
          r2 += psi.re * psi.re + psi.im * psi.im;
        }
      }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) rp[s][c] = az[s][c] = {0.f, 0.f};
  }

  // this site's dots against each stored direction, staged as they come;
  // dead threads stage zeros
  const int nvl = 4 * lim + 3;
  WarpStage st{tiles[threadIdx.x >> 5], sums + (threadIdx.x >> 5) * nvl, 0, 0};
  const int M = 12 * g.N;  // one stack row
#pragma unroll(ZSTEP ? 1 : 2)  // the faster of the two on the card, for each form
  for (int j = 0; j < lim; ++j) {
    cf raw = {0.f, 0.f}, apr = {0.f, 0.f};
    if (live) {
      const FieldLoad A{aps_re + static_cast<long long>(j) * M,
                        aps_im + static_cast<long long>(j) * M, g.N};
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const cf a = A(s, c, n);
          raw = cadd(raw, cmulc(a, az[s][c]));
          apr = cadd(apr, cmulc(a, rp[s][c]));
        }
    }
    st.put(raw.re);
    st.put(raw.im);
    st.put(apr.re);
    st.put(apr.im);
  }
  cf zr = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) zr = cadd(zr, cmulc(az[s][c], rp[s][c]));
  st.put(zr.re);
  st.put(zr.im);
  st.put(r2);
  if (st.fill) st.flush();

  // the block's partials, value-major; zeros for the rows from lim on
  __syncthreads();
  const int nv = n_values(S);
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const int v = staged_index(i, S, lim);
    double s = 0.0;
    if (v >= 0)
      for (int w = 0; w < kWarps; ++w) s += sums[w * nvl + v];
    partials[static_cast<long long>(i) * gridDim.x + blockIdx.x] = s;
  }
}

// value i's total over the blocks: element (b, i) of the partials lies at
// b * bstride + i * vstride; one block per value, each thread a strided sum
// over the blocks in order, then a tree over the threads
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const double* __restrict__ partials, int nblocks, long long bstride,
                       long long vstride, float* __restrict__ res) {
  __shared__ double sm[kThreads];
  const int i = blockIdx.x;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) s += partials[b * bstride + i * vstride];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) res[i] = static_cast<float>(sm[0]);
}

// block-major partials (partials[b * nv + i]), as block_flush writes them
cudaError_t reduce_partials(const double* partials, int nblocks, int nv, float* res,
                            cudaStream_t stream) {
  reduce_partials_kernel<<<nv, kThreads, 0, stream>>>(partials, nblocks, nv, 1, res);
  return cudaGetLastError();
}

template <int R, typename LT, bool ZSTEP, bool HALO>
static cudaError_t launch_step(const float* rre, const float* rim, const float* aps_re,
                               const float* aps_im, const float* zre, const float* zim,
                               const void* ure, const void* uim,
                               const float* alpha, const float* k, float* rp_re, float* rp_im,
                               float* az_re, float* az_im, double* partials, float* res, int S,
                               int lim, int T, int Z, int Y, int X, int anti_t,
                               const Halo<LT>& h, cudaStream_t stream) {
  const int n = T * Z * Y * X;
  const int nblocks = (n + kThreads - 1) / kThreads;
  const int nv = n_values(S);
  const size_t smem = sizeof(double) * kWarps * (4 * lim + 3);
  if (!ZSTEP) {  // K2's stencil reads aps[lim-1] through z
    zre = aps_re + static_cast<size_t>(lim - 1) * 12 * n;
    zim = aps_im + static_cast<size_t>(lim - 1) * 12 * n;
  }
  gcr_step_kernel<R, LT, ZSTEP, HALO><<<nblocks, kThreads, smem, stream>>>(
      rre, rim, aps_re, aps_im, zre, zim, static_cast<const LT*>(ure),
      static_cast<const LT*>(uim), alpha, k, rp_re, rp_im, az_re, az_im, partials, S, lim, T, Z,
      Y, X, anti_t, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // value-major partials
  reduce_partials_kernel<<<nv, kThreads, 0, stream>>>(partials, nblocks, 1, nblocks, res);
  return cudaGetLastError();
}

// the four link variants of one step form: rows 3/2, f32/bf16 storage;
// HALO reads the ghost table ``halo`` (common.cuh halo_from)
template <bool ZSTEP, bool HALO = false>
static cudaError_t dispatch_step(const float* rre, const float* rim, const float* aps_re,
                                 const float* aps_im, const float* zre, const float* zim,
                                 const void* ure, const void* uim, const float* alpha,
                                 const float* k, float* rp_re, float* rp_im, float* az_re,
                                 float* az_im, double* partials, float* res, int S, int lim,
                                 int T, int Zd, int Y, int X, int rows, int bf16, int anti_t,
                                 cudaStream_t s, const void* const* halo = nullptr) {
  if (lim < 1 || lim > S) return cudaErrorInvalidValue;
#define MG_STEP(RR, LT)                                                                   \
  launch_step<RR, LT, ZSTEP, HALO>(                                                        \
      rre, rim, aps_re, aps_im, zre, zim, ure, uim, alpha, k, rp_re, rp_im, az_re, az_im,  \
      partials, res, S, lim, T, Zd, Y, X, anti_t, HALO ? halo_from<LT>(halo) : Halo<LT>{}, s)
  if (rows == 3 && !bf16) return MG_STEP(3, float);
  if (rows == 2 && !bf16) return MG_STEP(2, float);
  if (rows == 3 && bf16) return MG_STEP(3, __nv_bfloat16);
  if (rows == 2 && bf16) return MG_STEP(2, __nv_bfloat16);
#undef MG_STEP
  return cudaErrorInvalidValue;
}

}  // namespace mg

// partials: n_values(S) * ceil(N / 256) doubles; res: n_values(S) floats
extern "C" int mg_gcr_stream_step(const float* rre, const float* rim, const float* aps_re,
                                  const float* aps_im, const void* ure, const void* uim,
                                  const float* alpha, const float* k, float* rp_re,
                                  float* rp_im, float* az_re, float* az_im, double* partials,
                                  float* res, int S, int lim, int T, int Z, int Y, int X,
                                  int rows, int bf16, int anti_t, void* stream) {
  return static_cast<int>(mg::dispatch_step<false>(
      rre, rim, aps_re, aps_im, nullptr, nullptr, ure, uim, alpha, k, rp_re, rp_im, az_re, az_im,
      partials, res, S, lim, T, Z, Y, X, rows, bf16, anti_t, static_cast<cudaStream_t>(stream)));
}

// as mg_gcr_stream_step, with z the stencil input and r read for the dots
// only; res keeps K2's layout, its r2 entry is 0
extern "C" int mg_gcr_z_step(const float* rre, const float* rim, const float* aps_re,
                             const float* aps_im, const float* zre, const float* zim,
                             const void* ure, const void* uim, const float* k, float* az_re,
                             float* az_im, double* partials, float* res, int S, int lim, int T,
                             int Z, int Y, int X, int rows, int bf16, int anti_t, void* stream) {
  return static_cast<int>(mg::dispatch_step<true>(
      rre, rim, aps_re, aps_im, zre, zim, ure, uim, nullptr, k, nullptr, nullptr, az_re, az_im,
      partials, res, S, lim, T, Z, Y, X, rows, bf16, anti_t, static_cast<cudaStream_t>(stream)));
}

// B15: K2 with the ghost table ``halo`` and no in-kernel boundary sign; res
// holds this shard's partial dots
extern "C" int mg_gcr_stream_step_dist(const float* rre, const float* rim, const float* aps_re,
                                       const float* aps_im, const void* ure, const void* uim,
                                       const float* alpha, const float* k, float* rp_re,
                                       float* rp_im, float* az_re, float* az_im,
                                       double* partials, float* res, int S, int lim, int T, int Z,
                                       int Y, int X, int rows, int bf16, const void* const* halo,
                                       void* stream) {
  return static_cast<int>(mg::dispatch_step<false, true>(
      rre, rim, aps_re, aps_im, nullptr, nullptr, ure, uim, alpha, k, rp_re, rp_im, az_re, az_im,
      partials, res, S, lim, T, Z, Y, X, rows, bf16, 0, static_cast<cudaStream_t>(stream), halo));
}
