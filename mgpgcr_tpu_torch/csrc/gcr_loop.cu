// B6, B3 and B7: the streaming GCR algebra of the loop-form and eager
// fused solves, which keep the search directions p_j in a stack beside
// A p_j.
//
// B6 update_xr replaces mgpgcr_tpu/ops/pallas/gcr_kernels.py::_k1_kernel
// (via update_xr):
//   x' = x + alpha ps[slot],   r' = r - alpha aps[slot],   ||r'||^2.
// B3 beta_dots replaces ::_k2_kernel (via beta_dots):
//   raw_j = <aps_j, az> for j < lim, raw_j = 0 for lim <= j < S.
// B7 dir_update replaces ::_k3_kernel (via dir_update):
//   p  = z  - sum_{j<lim} beta_j ps_j,   ap = az - sum_{j<lim} beta_j aps_j,
//   written IN PLACE into stack row `slot`, with ||ap||^2 and <ap, r>
//   (<ap, z> when r is null: unpreconditioned, z is r).
//
// Bound on an H100: bytes; each is a few flops per element. B6 reads four
// fields and writes two (6 field passes), B3 reads az and aps[0:lim]
// (lim + 1), B7 reads z, az, ps[0:lim], aps[0:lim] (and r) and writes two
// rows (2 lim + 4, or 2 lim + 5 with r). The TPU kernels cut the fields
// into VMEM row windows on a sequential grid and carry the sums in SMEM;
// here a grid-stride loop walks the flat re/im planes, neighbouring
// threads on neighbouring floats, so each field streams through DRAM once.
//
// lim is a runtime argument and may reach hundreds (storage_size is
// max_iter with neither restart nor truncation). B3 takes the rows in
// chunks of kDotRows per pass over az, so a thread holds 2 kDotRows
// accumulators whatever lim is; az is read once per chunk, once in all for
// lim <= kDotRows. B7 stages the betas in shared memory in tiles of
// kBetaTile; the grid-stride trip count is the same for every thread of a
// block, so the tiles can be reloaded behind __syncthreads.
//
// B7 writes into the stack it reads. Under truncation the slot lies inside
// the live prefix (slot < lim), so each output element is written by the
// thread that read all lim rows at that element, after it read them; the
// stacks carry no __restrict__.
//
// Reductions as in the other kernels: f32 within a thread, f64 from the
// warp shuffle on, block partials added in block order by reduce_partials
// (no atomics, the same bits every run).
#include "common.cuh"

namespace mg {

namespace {

constexpr int kMaxBlocks = 132 * 16;  // as csrc/gcr_kernels.cu
constexpr int kDotRows = 8;
constexpr int kBetaTile = 1024;

int loop_blocks(long long M) {
  long long b = (M + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
update_xr_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
                 const float* __restrict__ r_re, const float* __restrict__ r_im,
                 const float* __restrict__ p_re, const float* __restrict__ p_im,
                 const float* __restrict__ ap_re, const float* __restrict__ ap_im,
                 const float* __restrict__ alpha, float* __restrict__ ox_re,
                 float* __restrict__ ox_im, float* __restrict__ or_re, float* __restrict__ or_im,
                 double* __restrict__ partials, long long M) {
  __shared__ double sm[kWarps];
  const float ar = alpha[0], ai = alpha[1];
  float nrm = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < M;
       e += step) {
    const float pr = p_re[e], pi = p_im[e];
    ox_re[e] = x_re[e] + (ar * pr - ai * pi);
    ox_im[e] = x_im[e] + (ar * pi + ai * pr);
    const float qr = ap_re[e], qi = ap_im[e];
    const float nr = r_re[e] - (ar * qr - ai * qi);
    const float ni = r_im[e] - (ar * qi + ai * qr);
    or_re[e] = nr;
    or_im[e] = ni;
    nrm += nr * nr + ni * ni;
  }
  block_put(sm, 1, 0, nrm);
  block_flush(sm, 1, partials);
}

// One chunk of NJ rows [j0, j0 + NJ): the row count is a template
// argument, so the NJ row loads of an element issue together before the
// first multiply-add waits on them.
template <int NJ>
__device__ __forceinline__ void chunk_dots(const float* __restrict__ aps_re,
                                           const float* __restrict__ aps_im,
                                           const float* __restrict__ az_re,
                                           const float* __restrict__ az_im, long long M, int j0,
                                           float (&dre)[kDotRows], float (&dim)[kDotRows]) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < M;
       e += step) {
    float ar[NJ], ai[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const long long o = static_cast<long long>(j0 + i) * M + e;
      ar[i] = aps_re[o];
      ai[i] = aps_im[o];
    }
    const float zr = az_re[e], zi = az_im[e];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      dre[i] += ar[i] * zr + ai[i] * zi;
      dim[i] += ar[i] * zi - ai[i] * zr;
    }
  }
}

// partials: (gridDim.x, 2 lim) doubles; the chunk of rows [j0, j0 + nj)
// fills columns [2 j0, 2 j0 + 2 nj)
__global__ void __launch_bounds__(kThreads)
beta_dots_kernel(const float* __restrict__ aps_re, const float* __restrict__ aps_im,
                 const float* __restrict__ az_re, const float* __restrict__ az_im,
                 double* __restrict__ partials, long long M, int lim) {
  __shared__ double sm[kWarps * 2 * kDotRows];
  for (int j0 = 0; j0 < lim; j0 += kDotRows) {
    const int nj = lim - j0 < kDotRows ? lim - j0 : kDotRows;
    float dre[kDotRows], dim[kDotRows];
#pragma unroll
    for (int i = 0; i < kDotRows; ++i) dre[i] = dim[i] = 0.f;
    switch (nj) {
      case 1: chunk_dots<1>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 2: chunk_dots<2>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 3: chunk_dots<3>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 4: chunk_dots<4>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 5: chunk_dots<5>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 6: chunk_dots<6>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      case 7: chunk_dots<7>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
      default: chunk_dots<8>(aps_re, aps_im, az_re, az_im, M, j0, dre, dim); break;
    }
    if (j0 > 0) __syncthreads();  // the previous chunk's flush has read sm
#pragma unroll
    for (int i = 0; i < kDotRows; ++i) {
      if (i < nj) {
        block_put(sm, 2 * nj, 2 * i, dre[i]);
        block_put(sm, 2 * nj, 2 * i + 1, dim[i]);
      }
    }
    block_flush_strided(sm, 2 * nj, partials + 2 * j0, 2LL * lim);
  }
}

// r_re/r_im null: dot against z. Output partials per block:
// [<ap, r> re, <ap, r> im, ||ap||^2]
__global__ void __launch_bounds__(kThreads)
dir_update_kernel(const float* __restrict__ z_re, const float* __restrict__ z_im,
                  const float* __restrict__ az_re, const float* __restrict__ az_im,
                  const float* __restrict__ r_re, const float* __restrict__ r_im, float* ps_re,
                  float* ps_im, float* aps_re, float* aps_im, const float* __restrict__ betas,
                  double* __restrict__ partials, long long M, int lim, int slot) {
  __shared__ float2 sb[kBetaTile];
  __shared__ double sm[kWarps * 3];
  const int ntiles = (lim + kBetaTile - 1) / kBetaTile;
  if (ntiles == 1) {
    for (int j = threadIdx.x; j < lim; j += blockDim.x)
      sb[j] = make_float2(betas[2 * j], betas[2 * j + 1]);
    __syncthreads();
  }
  float nrm = 0.f, dre = 0.f, dim = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x); base < M;
       base += step) {
    const long long e = base + threadIdx.x;
    const bool live = e < M;
    float zr = 0.f, zi = 0.f, ar = 0.f, ai = 0.f;
    if (live) {
      zr = z_re[e];
      zi = z_im[e];
      ar = az_re[e];
      ai = az_im[e];
    }
    float pr = zr, pi = zi;
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * kBetaTile;
      const int nj = lim - j0 < kBetaTile ? lim - j0 : kBetaTile;
      if (ntiles > 1) {
        __syncthreads();  // every thread is done with the previous tile
        for (int j = threadIdx.x; j < nj; j += blockDim.x)
          sb[j] = make_float2(betas[2 * (j0 + j)], betas[2 * (j0 + j) + 1]);
        __syncthreads();
      }
      if (live) {
        for (int j = 0; j < nj; ++j) {
          const float2 b = sb[j];
          const long long o = static_cast<long long>(j0 + j) * M + e;
          const float qr = ps_re[o], qi = ps_im[o];
          const float sr = aps_re[o], si = aps_im[o];
          pr -= b.x * qr - b.y * qi;
          pi -= b.x * qi + b.y * qr;
          ar -= b.x * sr - b.y * si;
          ai -= b.x * si + b.y * sr;
        }
      }
    }
    if (live) {
      // every row of this element has been read above: the slot may be one
      const long long o = static_cast<long long>(slot) * M + e;
      ps_re[o] = pr;
      ps_im[o] = pi;
      aps_re[o] = ar;
      aps_im[o] = ai;
      const float rr = r_re ? r_re[e] : zr;
      const float ri = r_re ? r_im[e] : zi;
      nrm += ar * ar + ai * ai;
      dre += ar * rr + ai * ri;
      dim += ar * ri - ai * rr;
    }
  }
  block_put(sm, 3, 0, dre);
  block_put(sm, 3, 1, dim);
  block_put(sm, 3, 2, nrm);
  block_flush(sm, 3, partials);
}

}  // namespace mg

// x' = x + alpha ps[slot], r' = r - alpha aps[slot], out of place; alpha:
// one (re, im) pair; partials: kMaxBlocks doubles; r2: one float
extern "C" int mg_update_xr(const float* x_re, const float* x_im, const float* r_re,
                            const float* r_im, const float* ps_re, const float* ps_im,
                            const float* aps_re, const float* aps_im, const float* alpha,
                            double* partials, float* ox_re, float* ox_im, float* or_re,
                            float* or_im, float* r2, long long M, int slot, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = loop_blocks(M);
  const long long off = static_cast<long long>(slot) * M;
  update_xr_kernel<<<nblocks, kThreads, 0, s>>>(x_re, x_im, r_re, r_im, ps_re + off, ps_im + off,
                                                aps_re + off, aps_im + off, alpha, ox_re, ox_im,
                                                or_re, or_im, partials, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(partials, nblocks, 1, r2, s));
}

// out: S complex values as (re, im) pairs, rows [lim, S) zeroed;
// partials: kMaxBlocks * 2 * lim doubles
extern "C" int mg_beta_dots(const float* aps_re, const float* aps_im, const float* az_re,
                            const float* az_im, double* partials, float* out, long long M, int S,
                            int lim, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = loop_blocks(M);
  beta_dots_kernel<<<nblocks, kThreads, 0, s>>>(aps_re, aps_im, az_re, az_im, partials, M, lim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = reduce_partials(partials, nblocks, 2 * lim, out, s);
  if (err != cudaSuccess || lim == S) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemsetAsync(out + 2 * lim, 0, sizeof(float) * 2 * (S - lim), s));
}

// ps[slot], aps[slot] written in place; r_re/r_im null for the dot against
// z; betas: lim (re, im) pairs; partials: kMaxBlocks * 3 doubles; res:
// [<ap, r> re, <ap, r> im, ||ap||^2]
extern "C" int mg_dir_update(const float* z_re, const float* z_im, const float* az_re,
                             const float* az_im, const float* r_re, const float* r_im,
                             float* ps_re, float* ps_im, float* aps_re, float* aps_im,
                             const float* betas, double* partials, float* res, long long M,
                             int lim, int slot, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = loop_blocks(M);
  dir_update_kernel<<<nblocks, kThreads, 0, s>>>(z_re, z_im, az_re, az_im, r_re, r_im, ps_re,
                                                 ps_im, aps_re, aps_im, betas, partials, M, lim,
                                                 slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(partials, nblocks, 3, res, s));
}
