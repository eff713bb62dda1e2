// K3, K4 and B2: the streaming GCR algebra of the restart-cycle solve.
//
// K3 ap_update replaces mgpgcr_tpu/ops/pallas/gcr_kernels.py::_k3z_kernel
// (via ap_update):
//   aps[slot] = az - sum_{j<lim} beta_j aps_j   (in place), ||aps[slot]||^2,
//   and <aps[slot], r> in the r form (r given: the cycles form on
//   operators without a one-pass step).
// K4 basis_flush replaces ::_k4z_kernel (via basis_flush):
//   x' = x + sum_m wx_m b_m,   p0' = sum_m wp_m b_m   over nb basis fields.
// B2 update_r replaces ::_k1r_kernel (via update_r), the residual update
// of the preconditioned restart cycle:
//   r' = r - alpha aps[slot],   ||r'||^2.
//
// Bound on an H100: bytes; all three are a few flops per element. The TPU
// kernels cut the fields into VMEM row windows on a sequential grid and
// carry the norm in SMEM; here a grid-stride loop walks the flat fields,
// neighbouring threads on neighbouring floats, so every field streams
// through DRAM once: K3 reads (1 + lim) fields, and r in its r form, and
// writes one; K4 reads 1 + nb and writes two. K3 reads only the live
// prefix j < lim, and may write a slot inside it: each thread reads all of
// its element's inputs before it writes. The coefficients beta, wx and wp and the basis
// pointers are read from device memory. The norms are reduced as in K2:
// f32 per thread, f64 from the warp on, block partials added in order.
// B2 reads r and one stack row and writes r': three field passes.
#include "common.cuh"

namespace mg {

// grid-stride launches: enough blocks to fill 132 SMs many times over,
// few enough that the norm's partials stay a short second pass
constexpr int kMaxBlocks = 132 * 16;

static int stride_blocks(long long M) {
  long long b = (M + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
ap_update_kernel(const float* __restrict__ az_re, const float* __restrict__ az_im,
                 const float* __restrict__ r_re, const float* __restrict__ r_im, float* aps_re,
                 float* aps_im, const float* __restrict__ betas, double* __restrict__ partials,
                 long long M, int lim, int slot) {
  __shared__ double sm[kWarps * 3];
  float nrm = 0.f, dre = 0.f, dim = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < M;
       e += step) {
    float are = az_re[e], aim = az_im[e];
    for (int j = 0; j < lim; ++j) {
      const float br = betas[2 * j], bi = betas[2 * j + 1];
      const float pr = aps_re[j * M + e], pi = aps_im[j * M + e];
      are -= br * pr - bi * pi;
      aim -= br * pi + bi * pr;
    }
    aps_re[slot * M + e] = are;
    aps_im[slot * M + e] = aim;
    nrm += are * are + aim * aim;
    if (r_re) {
      const float rr = r_re[e], ri = r_im[e];
      dre += are * rr + aim * ri;
      dim += are * ri - aim * rr;
    }
  }
  if (r_re) {
    block_put(sm, 3, 0, dre);
    block_put(sm, 3, 1, dim);
    block_put(sm, 3, 2, nrm);
    block_flush(sm, 3, partials);
  } else {
    block_put(sm, 1, 0, nrm);
    block_flush(sm, 1, partials);
  }
}

__global__ void __launch_bounds__(kThreads)
basis_flush_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
                   const float* const* __restrict__ basis, const float* __restrict__ wx,
                   const float* __restrict__ wp, float* __restrict__ ox_re,
                   float* __restrict__ ox_im, float* __restrict__ op_re,
                   float* __restrict__ op_im, long long M, int nb) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < M;
       e += step) {
    float xr = x_re[e], xi = x_im[e], pr = 0.f, pi = 0.f;
    for (int m = 0; m < nb; ++m) {
      const float br = basis[m][e], bi = basis[nb + m][e];
      xr += wx[2 * m] * br - wx[2 * m + 1] * bi;
      xi += wx[2 * m] * bi + wx[2 * m + 1] * br;
      pr += wp[2 * m] * br - wp[2 * m + 1] * bi;
      pi += wp[2 * m] * bi + wp[2 * m + 1] * br;
    }
    ox_re[e] = xr;
    ox_im[e] = xi;
    op_re[e] = pr;
    op_im[e] = pi;
  }
}

__global__ void __launch_bounds__(kThreads)
update_r_kernel(const float* __restrict__ r_re, const float* __restrict__ r_im,
                const float* __restrict__ ap_re, const float* __restrict__ ap_im,
                const float* __restrict__ alpha, float* __restrict__ o_re,
                float* __restrict__ o_im, double* __restrict__ partials, long long M) {
  __shared__ double sm[kWarps];
  const float ar = alpha[0], ai = alpha[1];
  float nrm = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < M;
       e += step) {
    const float pr = ap_re[e], pi = ap_im[e];
    const float nr = r_re[e] - (ar * pr - ai * pi);
    const float ni = r_im[e] - (ar * pi + ai * pr);
    o_re[e] = nr;
    o_im[e] = ni;
    nrm += nr * nr + ni * ni;
  }
  block_put(sm, 1, 0, nrm);
  block_flush(sm, 1, partials);
}

}  // namespace mg

// r_re/r_im null: no dot. partials: kMaxBlocks * 3 doubles; res: ||ap||^2,
// or with r [<ap, r> re, <ap, r> im, ||ap||^2]
extern "C" int mg_ap_update(const float* az_re, const float* az_im, const float* r_re,
                            const float* r_im, float* aps_re, float* aps_im, const float* betas,
                            double* partials, float* res, long long M, int lim, int slot,
                            void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = stride_blocks(M);
  ap_update_kernel<<<nblocks, kThreads, 0, s>>>(az_re, az_im, r_re, r_im, aps_re, aps_im, betas,
                                                partials, M, lim, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(partials, nblocks, r_re ? 3 : 1, res, s));
}

// basis: device array of 2 * nb pointers, the nb real planes then the nb
// imaginary planes; wx, wp: nb complex weights each, as (re, im) pairs
extern "C" int mg_basis_flush(const float* x_re, const float* x_im, const float* const* basis,
                              const float* wx, const float* wp, float* ox_re, float* ox_im,
                              float* op_re, float* op_im, long long M, int nb, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  basis_flush_kernel<<<stride_blocks(M), kThreads, 0, s>>>(x_re, x_im, basis, wx, wp, ox_re,
                                                           ox_im, op_re, op_im, M, nb);
  return static_cast<int>(cudaGetLastError());
}

// r' = r - alpha aps[slot] out of place; alpha: one (re, im) pair;
// partials: kMaxBlocks doubles; r2: one float
extern "C" int mg_update_r(const float* r_re, const float* r_im, const float* aps_re,
                           const float* aps_im, const float* alpha, double* partials,
                           float* o_re, float* o_im, float* r2, long long M, int slot,
                           void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = stride_blocks(M);
  update_r_kernel<<<nblocks, kThreads, 0, s>>>(r_re, r_im, aps_re + slot * M, aps_im + slot * M,
                                               alpha, o_re, o_im, partials, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(partials, nblocks, 1, r2, s));
}
