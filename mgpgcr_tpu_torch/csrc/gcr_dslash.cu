// K2: the one-pass GCR step of the unpreconditioned restart solve.
//
//   r'  = r - alpha aps[lim-1]            (written out)
//   az  = (I - k D) r'                    (written out)
//   r2  = ||r'||^2
//   raw_j = <aps_j, az>, apr_j = <aps_j, r'>   for j < lim (zeros above)
//   apr_S = <az, r'>
//
// Replaces mgpgcr_tpu/ops/pallas/gcr_dslash.py::_gcr_step_kernel (via
// gcr_stream_step). The TPU kernel carries the r' planes of t-1 and t in
// VMEM while it streams t. Blocks on a GPU share nothing, and the stencil
// needs r' at the 8 neighbours, so this kernel RECOMPUTES r' = r - alpha ap
// at every neighbour from r and aps[lim-1] (RPrimeLoad) instead of running
// a separate residual pass: one launch, no r' round trip through DRAM, at
// the price of twice the neighbour gathers, which L2 serves.
//
// Bound on an H100: bytes. DRAM must see the links, r and aps[0:lim] once
// each and r', az written once: 288 + (1 + lim) * 96 + 2 * 96 B per site
// for f32 3-row links. The dots are epilogue arithmetic on values already
// in registers plus one read of each aps_j at the thread's own site.
//
// Dot products: f32 within a thread, f64 from the warp shuffle on, one
// partial per block; reduce_partials adds the partials in block order, so
// results are deterministic. alpha and k are read from device memory, so
// no iteration waits on the host.
#include "common.cuh"

namespace mg {

// output layout of res (floats): raw (S complex), apr (S + 1 complex), r2
__host__ __device__ __forceinline__ int n_values(int S) { return 2 * S + 2 * (S + 1) + 1; }

template <int R, typename LT>
__global__ void __launch_bounds__(kThreads)
gcr_step_kernel(const float* __restrict__ rre, const float* __restrict__ rim,
                const float* __restrict__ aps_re, const float* __restrict__ aps_im,
                const LT* __restrict__ ure, const LT* __restrict__ uim,
                const float* __restrict__ alpha, const float* __restrict__ k,
                float* __restrict__ rp_re, float* __restrict__ rp_im, float* __restrict__ az_re,
                float* __restrict__ az_im, double* __restrict__ partials, int S, int lim, int T,
                int Z, int Y, int X, int anti_t) {
  extern __shared__ double sm[];
  const Geom g(T, Z, Y, X);
  const int nv = n_values(S);
  for (int i = threadIdx.x; i < kWarps * nv; i += blockDim.x) sm[i] = 0.0;
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < g.N;
  const int M = 12 * g.N;  // one stack row
  const float* slot_re = aps_re + static_cast<long long>(lim - 1) * M;
  const float* slot_im = aps_im + static_cast<long long>(lim - 1) * M;
  const RPrimeLoad L{rre, rim, slot_re, slot_im, {alpha[0], alpha[1]}, g.N};

  cf rp[4][3], az[4][3];
  float r2 = 0.f;
  if (live) {
    dslash_site<R, LT>(L, ure, uim, g, n, anti_t != 0, az);
    const cf kk = {k[0], k[1]};
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        rp[s][c] = L(s, c, n);
        az[s][c] = csub(rp[s][c], cmul(kk, az[s][c]));
        const int o = (s * 3 + c) * g.N + n;
        rp_re[o] = rp[s][c].re;
        rp_im[o] = rp[s][c].im;
        az_re[o] = az[s][c].re;
        az_im[o] = az[s][c].im;
        r2 += rp[s][c].re * rp[s][c].re + rp[s][c].im * rp[s][c].im;
      }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) rp[s][c] = az[s][c] = {0.f, 0.f};
  }

  // dots of this site against each stored direction; every thread takes
  // part in every shuffle, dead threads with zeros
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
    block_put(sm, nv, 2 * j, raw.re);
    block_put(sm, nv, 2 * j + 1, raw.im);
    block_put(sm, nv, 2 * S + 2 * j, apr.re);
    block_put(sm, nv, 2 * S + 2 * j + 1, apr.im);
  }
  cf zr = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) zr = cadd(zr, cmulc(az[s][c], rp[s][c]));
  block_put(sm, nv, 4 * S, zr.re);
  block_put(sm, nv, 4 * S + 1, zr.im);
  block_put(sm, nv, 4 * S + 2, r2);
  block_flush(sm, nv, partials);
}

__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const double* __restrict__ partials, int nblocks, int nv,
                       float* __restrict__ res) {
  __shared__ double sm[kThreads];
  const int i = blockIdx.x;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    s += partials[static_cast<long long>(b) * nv + i];
  sm[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) res[i] = static_cast<float>(sm[0]);
}

cudaError_t reduce_partials(const double* partials, int nblocks, int nv, float* res,
                            cudaStream_t stream) {
  reduce_partials_kernel<<<nv, kThreads, 0, stream>>>(partials, nblocks, nv, res);
  return cudaGetLastError();
}

template <int R, typename LT>
static cudaError_t launch_step(const float* rre, const float* rim, const float* aps_re,
                               const float* aps_im, const void* ure, const void* uim,
                               const float* alpha, const float* k, float* rp_re, float* rp_im,
                               float* az_re, float* az_im, double* partials, float* res, int S,
                               int lim, int T, int Z, int Y, int X, int anti_t,
                               cudaStream_t stream) {
  const int n = T * Z * Y * X;
  const int nblocks = (n + kThreads - 1) / kThreads;
  const int nv = n_values(S);
  const size_t smem = sizeof(double) * kWarps * nv;
  gcr_step_kernel<R, LT><<<nblocks, kThreads, smem, stream>>>(
      rre, rim, aps_re, aps_im, static_cast<const LT*>(ure), static_cast<const LT*>(uim), alpha,
      k, rp_re, rp_im, az_re, az_im, partials, S, lim, T, Z, Y, X, anti_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, nblocks, nv, res, stream);
}

}  // namespace mg

// partials: (ceil(N / 256), n_values(S)) doubles; res: n_values(S) floats
extern "C" int mg_gcr_stream_step(const float* rre, const float* rim, const float* aps_re,
                                  const float* aps_im, const void* ure, const void* uim,
                                  const float* alpha, const float* k, float* rp_re,
                                  float* rp_im, float* az_re, float* az_im, double* partials,
                                  float* res, int S, int lim, int T, int Z, int Y, int X,
                                  int rows, int bf16, int anti_t, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lim < 1 || lim > S) return static_cast<int>(cudaErrorInvalidValue);
#define MG_STEP(RR, LT)                                                                      \
  launch_step<RR, LT>(rre, rim, aps_re, aps_im, ure, uim, alpha, k, rp_re, rp_im, az_re, az_im, \
                      partials, res, S, lim, T, Z, Y, X, anti_t, s)
  cudaError_t err;
  if (rows == 3 && !bf16)
    err = MG_STEP(3, float);
  else if (rows == 2 && !bf16)
    err = MG_STEP(2, float);
  else if (rows == 3 && bf16)
    err = MG_STEP(3, __nv_bfloat16);
  else if (rows == 2 && bf16)
    err = MG_STEP(2, __nv_bfloat16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef MG_STEP
  return static_cast<int>(err);
}
