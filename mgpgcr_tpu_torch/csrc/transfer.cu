// B10 and B11: the MG grid transfers over the field-shaped basis.
//
// B10 restrict replaces mgpgcr_tpu/ops/pallas/transfer.py::_restrict_kernel
// (via restrict_pallas):
//   out[B * ne + e] = sum_{sites in B} sum_{s,c} conj(q_e(s,c,site)) x(s,c,site)
// B11 prolong replaces ::_prolong_kernel (via prolong_pallas):
//   out(s,c,site) = base(s,c,site) + damping * sum_e q_e(s,c,site) c[B(site) * ne + e]
// with q_field (ne, 4, 3, T, Z, Y*X), re and im apart, stored f32 or bf16,
// x, base and out f32 fields (4, 3, T, Z, Y*X), the coarse vector flat
// (nb * ne), b-major and e-minor; blocks are (bt, bz, by, bx) and numbered
// row-major over the block coordinates (Bt, Bz, By, Bx).
//
// Bound on an H100: bytes; a transfer does 8 flops per basis element. The
// basis dominates the traffic: ne field copies against one field in (and,
// for prolong, base in and one field out).
//
// Restrict's trap is coalescing: in the (T, Z, Y*X) layout a block's sites
// are contiguous only in runs of bx along x, 32 B for bx = 8 in f32. So
// one CTA does not own one block. It owns one basis vector e, one t-plane
// and one z-block: its threads sweep the bz rows of Y*X sites in order,
// neighbouring threads on neighbouring sites, and each thread adds its
// site's spin-colour contraction over the bz rows into a per-site sum in
// shared memory. The warps then reduce the (By, Bx) blocks of that row
// buffer, one block per warp at a time, in a fixed order, and write one
// partial per (e, t, Bz, By, Bx); a second tiny kernel adds the bt
// partials of each coarse entry in t order. No atomics: the result is
// deterministic. The ne CTAs that share x rows are adjacent in the grid
// (e fastest), so x's repeated reads are served by L2.
//
// Prolong is a pure per-site pass: one thread per site keeps its 12 output
// components in registers and loops over e, reading the block's ne
// coefficients (a few distinct addresses per warp, cached) and q_e.
// The TPU kernels' VMEM chunking over e and their 0/1 membership matmuls
// have no counterpart here.
#include "common.cuh"

namespace mg {

struct Blocking {
  int ne, T, Z, Y, X, bt, bz, by, bx;
  __host__ __device__ int V() const { return Y * X; }
  __host__ __device__ int N() const { return T * Z * Y * X; }
  __host__ __device__ int nBz() const { return Z / bz; }
  __host__ __device__ int nBx() const { return X / bx; }
  __host__ __device__ int Bs() const { return (Y / by) * (X / bx); }  // blocks of one (t, z) row
  __host__ __device__ int nb() const { return (T / bt) * (Z / bz) * Bs(); }
};

template <typename QT>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const QT* __restrict__ q_re, const QT* __restrict__ q_im,
                const float* __restrict__ x_re, const float* __restrict__ x_im,
                double* __restrict__ partials, Blocking b) {
  extern __shared__ float row[];  // 2 V floats: per-site sums over the bz rows
  const int V = b.V(), N = b.N();
  const int e = blockIdx.x % b.ne;
  const int tz = blockIdx.x / b.ne;  // t * nBz + Bz
  const int t = tz / b.nBz();
  const int z0 = (tz - t * b.nBz()) * b.bz;
  const QT* qr_e = q_re + static_cast<long long>(e) * 12 * N;
  const QT* qi_e = q_im + static_cast<long long>(e) * 12 * N;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float pr = 0.f, pi = 0.f;
    for (int zl = 0; zl < b.bz; ++zl) {
      const int n = (t * b.Z + z0 + zl) * V + v;
#pragma unroll
      for (int sc = 0; sc < 12; ++sc) {
        const int o = sc * N + n;
        const float qr = ld<QT>(qr_e, o), qi = ld<QT>(qi_e, o);
        const float xr = __ldg(x_re + o), xi = __ldg(x_im + o);
        pr += qr * xr + qi * xi;
        pi += qr * xi - qi * xr;
      }
    }
    row[v] = pr;
    row[V + v] = pi;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bsites = b.by * b.bx;
  for (int bs = warp; bs < b.Bs(); bs += kWarps) {
    const int y0 = (bs / b.nBx()) * b.by, x0 = (bs % b.nBx()) * b.bx;
    double sr = 0.0, si = 0.0;
    for (int l = lane; l < bsites; l += 32) {
      const int v = (y0 + l / b.bx) * b.X + x0 + l % b.bx;
      sr += row[v];
      si += row[V + v];
    }
    sr = warp_sum(sr);
    si = warp_sum(si);
    if (lane == 0) {
      const long long p = (static_cast<long long>(tz) * b.Bs() + bs) * b.ne + e;
      partials[2 * p] = sr;
      partials[2 * p + 1] = si;
    }
  }
}

// out[i], i = B * ne + e: the bt partials of block B's t-planes, in t order
__global__ void __launch_bounds__(kThreads)
restrict_finish_kernel(const double* __restrict__ partials, float* __restrict__ o_re,
                       float* __restrict__ o_im, Blocking b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.nb() * b.ne) return;
  const int e = i % b.ne, blk = i / b.ne;
  const int bs = blk % b.Bs(), btz = blk / b.Bs();  // btz = Bt * nBz + Bz
  const int bzi = btz % b.nBz(), bti = btz / b.nBz();
  double sr = 0.0, si = 0.0;
  for (int tl = 0; tl < b.bt; ++tl) {
    const long long tz = static_cast<long long>(bti * b.bt + tl) * b.nBz() + bzi;
    const long long p = (tz * b.Bs() + bs) * b.ne + e;
    sr += partials[2 * p];
    si += partials[2 * p + 1];
  }
  o_re[i] = static_cast<float>(sr);
  o_im[i] = static_cast<float>(si);
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(const QT* __restrict__ q_re, const QT* __restrict__ q_im,
               const float* __restrict__ c_re, const float* __restrict__ c_im,
               const float* __restrict__ base_re, const float* __restrict__ base_im,
               float* __restrict__ o_re, float* __restrict__ o_im, float damping, Blocking b) {
  const int N = b.N();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int V = b.V();
  const int tz = n / V, v = n - tz * V;
  const int t = tz / b.Z, z = tz - t * b.Z;
  const int y = v / b.X, x = v - y * b.X;
  const int blk =
      (((t / b.bt) * b.nBz() + z / b.bz) * (b.Y / b.by) + y / b.by) * b.nBx() + x / b.bx;
  cf acc[12];
#pragma unroll
  for (int sc = 0; sc < 12; ++sc) acc[sc] = {0.f, 0.f};
  for (int e = 0; e < b.ne; ++e) {
    const cf c = {__ldg(c_re + blk * b.ne + e), __ldg(c_im + blk * b.ne + e)};
    const QT* qr_e = q_re + static_cast<long long>(e) * 12 * N;
    const QT* qi_e = q_im + static_cast<long long>(e) * 12 * N;
#pragma unroll
    for (int sc = 0; sc < 12; ++sc) {
      const cf q = {ld<QT>(qr_e, sc * N + n), ld<QT>(qi_e, sc * N + n)};
      acc[sc] = cadd(acc[sc], cmul(q, c));
    }
  }
#pragma unroll
  for (int sc = 0; sc < 12; ++sc) {
    const int o = sc * N + n;
    cf out = cscale(acc[sc], damping);
    if (base_re != nullptr) out = cadd(out, {__ldg(base_re + o), __ldg(base_im + o)});
    o_re[o] = out.re;
    o_im[o] = out.im;
  }
}

static cudaError_t check_blocking(const Blocking& b) {
  if (b.ne < 1 || b.bt < 1 || b.bz < 1 || b.by < 1 || b.bx < 1 || b.T % b.bt || b.Z % b.bz ||
      b.Y % b.by || b.X % b.bx)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename QT>
static cudaError_t launch_restrict(const void* q_re, const void* q_im, const float* x_re,
                                   const float* x_im, double* partials, float* o_re,
                                   float* o_im, const Blocking& b, cudaStream_t s) {
  const size_t smem = 2 * sizeof(float) * b.V();
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // Y * X <= 6144
  restrict_kernel<QT><<<b.ne * b.T * b.nBz(), kThreads, smem, s>>>(
      static_cast<const QT*>(q_re), static_cast<const QT*>(q_im), x_re, x_im, partials, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = b.nb() * b.ne;
  restrict_finish_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, s>>>(partials, o_re,
                                                                                o_im, b);
  return cudaGetLastError();
}

template <typename QT>
static cudaError_t launch_prolong(const void* q_re, const void* q_im, const float* c_re,
                                  const float* c_im, const float* base_re, const float* base_im,
                                  float* o_re, float* o_im, float damping, const Blocking& b,
                                  cudaStream_t s) {
  prolong_kernel<QT><<<(b.N() + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const QT*>(q_re), static_cast<const QT*>(q_im), c_re, c_im, base_re, base_im,
      o_re, o_im, damping, b);
  return cudaGetLastError();
}

}  // namespace mg

// partials: 2 * ne * T * (Z / bz) * (Y / by) * (X / bx) doubles; out: nb * ne
// complex values as re and im arrays
extern "C" int mg_restrict(const void* q_re, const void* q_im, const float* x_re,
                           const float* x_im, double* partials, float* o_re, float* o_im,
                           int ne, int T, int Z, int Y, int X, int bt, int bz, int by, int bx,
                           int bf16, void* stream) {
  using namespace mg;
  const Blocking b{ne, T, Z, Y, X, bt, bz, by, bx};
  cudaError_t err = check_blocking(b);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_restrict<__nv_bfloat16>(q_re, q_im, x_re, x_im, partials, o_re, o_im, b, s)
             : launch_restrict<float>(q_re, q_im, x_re, x_im, partials, o_re, o_im, b, s);
  return static_cast<int>(err);
}

// base_re / base_im: nullable (no additive base)
extern "C" int mg_prolong(const void* q_re, const void* q_im, const float* c_re,
                          const float* c_im, const float* base_re, const float* base_im,
                          float* o_re, float* o_im, float damping, int ne, int T, int Z, int Y,
                          int X, int bt, int bz, int by, int bx, int bf16, void* stream) {
  using namespace mg;
  const Blocking b{ne, T, Z, Y, X, bt, bz, by, bx};
  cudaError_t err = check_blocking(b);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_prolong<__nv_bfloat16>(q_re, q_im, c_re, c_im, base_re, base_im, o_re,
                                             o_im, damping, b, s)
             : launch_prolong<float>(q_re, q_im, c_re, c_im, base_re, base_im, o_re, o_im,
                                     damping, b, s);
  return static_cast<int>(err);
}
