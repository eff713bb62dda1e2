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
// read once, so no tensor cores: the blocks must stream from DRAM at the
// full rate, and x (9 reads of each entry, through L1/L2) and y are small.
//
// What held the first design back: one warp owned one block row, its lanes
// took the columns j of one output entry i at a time, so at ne = 20 (12)
// 12 (20) of 32 lanes idled; each (k, i) run of ne values was read as
// scalar loads, and every output closed with two 5-step shuffle chains
// before the next output's loads went out. At the three-level grids (256
// and 16 block rows) 64 or 4 CTAs ran that serial chain.
//
// This design maps the OUTPUT ENTRIES (r, i), flattened, onto lane groups:
// G = min(ne / VEC, 32) neighbouring lanes share one entry, each lane owns
// a VEC-wide chunk of every run B[r, k, i, :] and of x's matching columns,
// so a warp's W = 32 / G groups read W consecutive runs (contiguous memory)
// with 16-byte loads by neighbouring lanes (VEC = 4 f32 or 8 bf16; 8-, 4-
// or 2-byte loads where ne or the pointers' alignment forbid 16). Every
// lane starts the loads of all K slots before any reduction, and the only
// cross-lane step is one sum over the group at the end. At ne = 20 f32
// (G = 5, W = 6) 30 of 32 lanes work; a 16-block-row grid still spreads
// over 192 / 10 warps. Neighbour rows come from the row's grid coordinates
// (no table), x straight through L1 (the group's lanes read neighbouring
// x entries; the groups of one row read the same ones). No shared memory,
// so ne is not limited by it.
//
// Order of each sum (fixed, no atomics): a lane adds its chunks in order,
// over k in slot order within each, its VEC columns in order within each
// (f32); then the group's first lane adds the other lanes' sums in lane
// order.
#include <cstdint>

#include "common.cuh"

namespace mg {

constexpr int kSpmvThreads = 128;
constexpr int kMaxSlots = 9;  // K = 2 nd + 1 with nd <= 4

struct Stencil {
  int nb, K, ne, nd;
  int dims[4];
  int G, W;  // lanes per output entry, output entries per warp
};

// the block rows of r's K slots, [self, +d0, -d0, +d1, -d1, ...], periodic,
// dim 0 outermost; slots past K are left unset
__device__ __forceinline__ void neighbours(const Stencil& s, int r, int (&nbr)[kMaxSlots]) {
  nbr[0] = r;
  int rest = r, stride = 1;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    if (d < s.nd) {
      const int ext = s.dims[d];
      const int c = rest % ext;
      rest /= ext;
      nbr[1 + 2 * d] = c + 1 == ext ? r - c * stride : r + stride;
      nbr[2 + 2 * d] = c == 0 ? r + (ext - 1) * stride : r - stride;
      stride *= ext;
    }
  }
}

// VEC consecutive values from p as floats, p aligned to the load's width
template <int VEC>
__device__ __forceinline__ void ldv(const float* p, float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int m = 0; m < VEC; m += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + m));
      v[m] = t.x;
      v[m + 1] = t.y;
      v[m + 2] = t.z;
      v[m + 3] = t.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// bf16 pairs packed in a 32-bit word, lower address in the low half
__device__ __forceinline__ void unpack2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(t.x, v);
    unpack2(t.y, v + 2);
    unpack2(t.z, v + 4);
    unpack2(t.w, v + 6);
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(t.x, v);
    unpack2(t.y, v + 2);
  } else if constexpr (VEC == 2) {
    unpack2(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <typename BT, int VEC>
__global__ void __launch_bounds__(kSpmvThreads)
stencil_spmv_kernel(const BT* __restrict__ b_re, const BT* __restrict__ b_im,
                    const float* __restrict__ x_re, const float* __restrict__ x_im,
                    float* __restrict__ y_re, float* __restrict__ y_im, const Stencil s) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kSpmvThreads + threadIdx.x) >> 5;
  const int grp = lane / s.G;
  const int ne = s.ne;
  const long long o = warp * s.W + grp;  // output entry r * ne + i
  const bool live = grp < s.W && o < static_cast<long long>(s.nb) * ne;
  float ar = 0.f, ai = 0.f;
  if (live) {
    const int r = static_cast<int>(o / ne);
    const int i = static_cast<int>(o - static_cast<long long>(r) * ne);
    int nbr[kMaxSlots];
    neighbours(s, r, nbr);
    const long long run = (static_cast<long long>(r) * s.K * ne + i) * ne;  // B[r, 0, i, 0]
    const long long kstride = static_cast<long long>(ne) * ne;
    for (int q = (lane - grp * s.G) * VEC; q < ne; q += s.G * VEC) {
#pragma unroll
      for (int k = 0; k < kMaxSlots; ++k) {
        if (k < s.K) {
          float vr[VEC], vi[VEC], xr[VEC], xi[VEC];
          ldv<VEC>(b_re + run + k * kstride + q, vr);
          ldv<VEC>(b_im + run + k * kstride + q, vi);
          ldv<VEC>(x_re + nbr[k] * ne + q, xr);
          ldv<VEC>(x_im + nbr[k] * ne + q, xi);
#pragma unroll
          for (int m = 0; m < VEC; ++m) {
            ar += vr[m] * xr[m] - vi[m] * xi[m];
            ai += vr[m] * xi[m] + vi[m] * xr[m];
          }
        }
      }
    }
  }
  // the group's sum, in lane order; every lane takes part in every shuffle
  const int lead = grp * s.G;
  float sr = ar, si = ai;
  for (int m = 1; m < s.G; ++m) {
    const float tr = __shfl_sync(0xffffffffu, ar, lead + m);
    const float ti = __shfl_sync(0xffffffffu, ai, lead + m);
    sr += tr;
    si += ti;
  }
  if (live && lane == lead) {
    y_re[o] = sr;
    y_im[o] = si;
  }
}

template <typename BT, int VEC>
static cudaError_t launch_spmv(const void* b_re, const void* b_im, const float* x_re,
                               const float* x_im, float* y_re, float* y_im, Stencil st,
                               cudaStream_t stream) {
  st.G = st.ne / VEC < 32 ? st.ne / VEC : 32;
  st.W = 32 / st.G;
  const long long warps = (static_cast<long long>(st.nb) * st.ne + st.W - 1) / st.W;
  const long long grid = (warps * 32 + kSpmvThreads - 1) / kSpmvThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  stencil_spmv_kernel<BT, VEC><<<static_cast<unsigned>(grid), kSpmvThreads, 0, stream>>>(
      static_cast<const BT*>(b_re), static_cast<const BT*>(b_im), x_re, x_im, y_re, y_im, st);
  return cudaGetLastError();
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % static_cast<std::uintptr_t>(bytes) == 0;
}

// the widest chunk of VEC values that divides ne and whose loads are
// aligned: block chunks of VEC elements, x chunks of VEC floats (16 bytes
// at most per load)
static int pick_vec(const void* b_re, const void* b_im, const float* x_re, const float* x_im,
                    int ne, int bsize) {
  for (int vec = bsize == 2 ? 8 : 4; vec > 1; vec /= 2) {
    const int xb = 4 * (vec < 4 ? vec : 4);
    if (ne % vec == 0 && aligned(b_re, vec * bsize) && aligned(b_im, vec * bsize) &&
        aligned(x_re, xb) && aligned(x_im, xb))
      return vec;
  }
  return 1;
}

}  // namespace mg

// blocks (nb, K, ne, ne) re and im, f32 or bf16 (bf16 = 1); x, y (nb * ne)
// f32; dims d0..d3 of which the first nd are used, d0 outermost
extern "C" int mg_stencil_spmv(const void* b_re, const void* b_im, const float* x_re,
                               const float* x_im, float* y_re, float* y_im, int nb, int K, int ne,
                               int nd, int d0, int d1, int d2, int d3, int bf16, void* stream) {
  using namespace mg;
  Stencil st{nb, K, ne, nd, {d0, d1, d2, d3}, 1, 1};
  long long cells = 1;
  for (int d = 0; d < nd && d < 4; ++d) cells *= st.dims[d] > 0 ? st.dims[d] : 0;
  if (nd < 1 || nd > 4 || K != 2 * nd + 1 || ne < 1 || cells != nb)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = pick_vec(b_re, b_im, x_re, x_im, ne, bf16 ? 2 : 4);
  cudaError_t err = cudaErrorInvalidValue;
#define MG_SPMV(BT, V) \
  err = launch_spmv<BT, V>(b_re, b_im, x_re, x_im, y_re, y_im, st, s)
  if (bf16) {
    if (vec == 8) MG_SPMV(__nv_bfloat16, 8);
    else if (vec == 4) MG_SPMV(__nv_bfloat16, 4);
    else if (vec == 2) MG_SPMV(__nv_bfloat16, 2);
    else MG_SPMV(__nv_bfloat16, 1);
  } else {
    if (vec == 4) MG_SPMV(float, 4);
    else if (vec == 2) MG_SPMV(float, 2);
    else MG_SPMV(float, 1);
  }
#undef MG_SPMV
  return static_cast<int>(err);
}
