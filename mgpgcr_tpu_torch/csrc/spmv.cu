// B12: the block-stencil SpMV, y = A x, for a periodic (2 nd + 1)-point
// stencil of ne x ne blocks over a grid of nd <= 4 dims (the Galerkin
// coarse operator of the MG hierarchy and the ingested lattice matrices).
//
// Replaces mgpgcr_tpu/ops/pallas/spmv.py::_stencil_spmv_kernel (via
// stencil_spmv):
//   y[r, i] = sum_{k < K} sum_j B[r, k, i, j] x[nbr(r, k), j]
// with blocks (nb, K, ne, ne), re and im apart, stored f32 or bf16, slot
// order [self, +d0, -d0, +d1, -d1, ...], block rows row-major over the grid
// (dim 0 outermost), x and y flat (nb * ne) f32, b-major and e-minor.
// Duplicate slots (a dim of extent 1 or 2, where +mu and -mu coincide)
// hold zero blocks and are added as they come.
//
// Bound on an H100: bytes. It is a block GEMV, 8 flops per block element
// read once, so no tensor cores. The TPU kernel keeps x lane-major and
// padded in VMEM and relays the blocks out so that every (slot, column)
// read is one tile; here the blocks stay in their (nb, K, ne, ne) layout,
// in which one block row is one contiguous run of K * ne * ne elements.
// One warp owns one block row. It first gathers the K * ne x values of the
// row's neighbours (computed from the row's grid coordinates, no table)
// into shared memory, through L2: every x entry is read by the 2 nd + 1
// rows that use it. It then walks the row's output entries i; for each,
// the lanes take the columns j, so the K loads of B[r, k, i, :] (ne
// contiguous values each) are coalesced and issued together, and the sum
// over j is a warp shuffle reduction in f32 in a fixed order. The block
// row is read once from DRAM; y is written once.
#include "common.cuh"

namespace mg {

constexpr int kSpmvWarps = 4;  // block rows per CTA, one warp each
constexpr int kMaxSlots = 9;   // K = 2 nd + 1 with nd <= 4

struct Stencil {
  int nb, K, ne, nd;
  int dims[4];
};

// block row of r's neighbour in slot k: [self, +d0, -d0, +d1, -d1, ...],
// periodic, dim 0 outermost
__device__ __forceinline__ int neighbour(const Stencil& s, int r, int k) {
  if (k == 0) return r;
  const int d = (k - 1) >> 1;
  int stride = 1;
  for (int i = s.nd - 1; i > d; --i) stride *= s.dims[i];
  const int ext = s.dims[d];
  const int c = (r / stride) % ext;
  int cn = ((k - 1) & 1) ? c - 1 : c + 1;
  cn = cn < 0 ? ext - 1 : (cn == ext ? 0 : cn);
  return r + (cn - c) * stride;
}

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename BT>
__global__ void __launch_bounds__(kSpmvWarps * 32)
stencil_spmv_kernel(const BT* __restrict__ b_re, const BT* __restrict__ b_im,
                    const float* __restrict__ x_re, const float* __restrict__ x_im,
                    float* __restrict__ y_re, float* __restrict__ y_im, Stencil s) {
  extern __shared__ float xs[];  // per warp: K * ne gathered re values, then im
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSpmvWarps + warp;
  if (r >= s.nb) return;  // whole warps leave; only __syncwarp below
  const int ne = s.ne, kn = s.K * ne;
  float* gr = xs + warp * 2 * kn;
  float* gi = gr + kn;
  for (int m = lane; m < kn; m += 32) {
    const int k = m / ne;
    const int o = neighbour(s, r, k) * ne + (m - k * ne);
    gr[m] = __ldg(x_re + o);
    gi[m] = __ldg(x_im + o);
  }
  __syncwarp();
  const long long row = static_cast<long long>(r) * kn * ne;
  const BT* br = b_re + row;
  const BT* bi = b_im + row;
  for (int i = 0; i < ne; ++i) {
    float ar = 0.f, ai = 0.f;
    for (int j = lane; j < ne; j += 32) {
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        if (k < s.K) {
          const int o = (k * ne + i) * ne + j;
          const float vr = ld<BT>(br, o), vi = ld<BT>(bi, o);
          const float xr = gr[k * ne + j], xi = gi[k * ne + j];
          ar += vr * xr - vi * xi;
          ai += vr * xi + vi * xr;
        }
      }
    }
    ar = warp_sum_f(ar);
    ai = warp_sum_f(ai);
    if (lane == 0) {
      y_re[r * ne + i] = ar;
      y_im[r * ne + i] = ai;
    }
  }
}

}  // namespace mg

// blocks (nb, K, ne, ne) re and im, f32 or bf16 (bf16 = 1); x, y (nb * ne)
// f32; dims d0..d3 of which the first nd are used, d0 outermost
extern "C" int mg_stencil_spmv(const void* b_re, const void* b_im, const float* x_re,
                               const float* x_im, float* y_re, float* y_im, int nb, int K, int ne,
                               int nd, int d0, int d1, int d2, int d3, int bf16, void* stream) {
  using namespace mg;
  const Stencil st{nb, K, ne, nd, {d0, d1, d2, d3}};
  long long cells = 1;
  for (int d = 0; d < nd; ++d) cells *= st.dims[d] > 0 ? st.dims[d] : 0;
  const size_t smem = sizeof(float) * 2 * kSpmvWarps * K * ne;
  if (nd < 1 || nd > 4 || K != 2 * nd + 1 || ne < 1 || cells != nb || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (nb + kSpmvWarps - 1) / kSpmvWarps;
  if (bf16)
    stencil_spmv_kernel<__nv_bfloat16><<<grid, kSpmvWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(b_re), static_cast<const __nv_bfloat16*>(b_im), x_re,
        x_im, y_re, y_im, st);
  else
    stencil_spmv_kernel<float><<<grid, kSpmvWarps * 32, smem, s>>>(
        static_cast<const float*>(b_re), static_cast<const float*>(b_im), x_re, x_im, y_re, y_im,
        st);
  return static_cast<int>(cudaGetLastError());
}
