// K1: the Wilson-Dirac hopping operator, D psi or A psi = psi - k D psi.
//
// Replaces mgpgcr_tpu/ops/pallas/dslash.py::_dslash_stream_kernel (via
// _dslash_stream and dslash_apply, streaming branch). The TPU kernel walks
// t-planes in order and carries two psi planes and one U_t plane in VMEM;
// here one thread owns one site on a flat grid over T*Z*Y*X and every
// block runs independently.
//
// Bound on an H100: bytes. Per site the kernel must read 12 complex psi
// values and 4 links (9 or 6 complex entries, f32 or bf16) and write 12
// complex values: 480 B/site for f32 3-row links, 288 B/site for bf16
// 2-row, against ~1.3 kflop/site, far below the card's 20 flop/B balance.
// The design keeps traffic near that minimum by leaning on the 50 MB L2:
// the 8 neighbour reads of psi and the 4 backward links are re-reads of
// lines that neighbouring blocks (same t-plane, adjacent z rows) fetch at
// about the same time, so DRAM sees roughly one read of each. Two-row
// links cut link bytes by a third (row 2 rebuilt in registers); bf16
// storage halves them again.
//
// B13: the same operator on mu-major links (4, 3, 3, T, Z, V), 3 rows, f32
// (or bf16) storage, the anti-periodic t sign folded into U_t(T-1) when
// the links were stored. Replaces mgpgcr_tpu/ops/pallas/dslash.py::
// _dslash_kernel (via dslash_apply with tb > 1 or zb < Z). That kernel cuts
// the lattice into (t, z) blocks with one-plane halo windows in VMEM; here
// it is K1's thread-per-site kernel with the mu-major link strides (each
// (a, b) entry a whole field apart) and no in-kernel sign. Bound: bytes,
// 288 B of links, 96 B of psi and 96 B out per site, 0.150 ms at 32^4.
//
// B14: K1 on one shard of a lattice split over (t, z) (HALO). Replaces
// mgpgcr_tpu/ops/pallas/dslash_dist.py::_dslash_stream_dist_kernel (via
// dslash_apply_local). The TPU kernel streams the shard's t-planes with the
// neighbours' planes as extra windows; here it is K1's thread-per-site
// kernel whose neighbours across the shard's t edge, and its z edge when z
// is split, are read from ghost planes (common.cuh Halo) that the host
// received from the neighbouring ranks, the anti-periodic sign already
// folded into them. Bound: bytes, K1's 384 B/site on two-row f32 links
// plus the ghosts read once (two psi planes and a U_t plane, and with z
// split two psi columns and a U_z column): 108.5 MB, 0.032 ms, for a
// 16x16x32x32 shard.
#include "common.cuh"

namespace mg {

template <int R, typename LT, bool MU_MAJOR, bool HALO>
__global__ void __launch_bounds__(kThreads)
dslash_kernel(const float* __restrict__ pre, const float* __restrict__ pim,
              const LT* __restrict__ ure, const LT* __restrict__ uim, float* __restrict__ ore,
              float* __restrict__ oim, const float* __restrict__ k, int T, int Z, int Y, int X,
              int anti_t, const __grid_constant__ Halo<LT> h) {
  const Geom g(T, Z, Y, X);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.N) return;
  const FieldLoad L{pre, pim, g.N};
  cf out[4][3];
  dslash_site<R, LT, MU_MAJOR, HALO>(L, ure, uim, g, n, anti_t != 0, out, &h);
  if (k != nullptr) {
    const cf kk = {k[0], k[1]};
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[s][c] = csub(L(s, c, n), cmul(kk, out[s][c]));
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int o = (s * 3 + c) * g.N + n;
      ore[o] = out[s][c].re;
      oim[o] = out[s][c].im;
    }
}

template <int R, typename LT, bool MU_MAJOR = false, bool HALO = false>
static void launch_dslash(const float* pre, const float* pim, const void* ure, const void* uim,
                          float* ore, float* oim, const float* k, int T, int Z, int Y, int X,
                          int anti_t, cudaStream_t stream, const Halo<LT>& h = Halo<LT>{}) {
  const int n = T * Z * Y * X;
  dslash_kernel<R, LT, MU_MAJOR, HALO><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pre, pim, static_cast<const LT*>(ure), static_cast<const LT*>(uim), ore, oim, k, T, Z, Y,
      X, anti_t, h);
}

}  // namespace mg

extern "C" int mg_dslash(const float* pre, const float* pim, const void* ure, const void* uim,
                         float* ore, float* oim, const float* k, int T, int Z, int Y, int X,
                         int rows, int bf16, int anti_t, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 3 && !bf16)
    launch_dslash<3, float>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, anti_t, s);
  else if (rows == 2 && !bf16)
    launch_dslash<2, float>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, anti_t, s);
  else if (rows == 3 && bf16)
    launch_dslash<3, __nv_bfloat16>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, anti_t, s);
  else if (rows == 2 && bf16)
    launch_dslash<2, __nv_bfloat16>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, anti_t, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// B13: mu-major 3-row links, no in-kernel boundary sign
extern "C" int mg_dslash_mu(const float* pre, const float* pim, const void* ure, const void* uim,
                            float* ore, float* oim, const float* k, int T, int Z, int Y, int X,
                            int bf16, void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_dslash<3, __nv_bfloat16, true>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, 0, s);
  else
    launch_dslash<3, float, true>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, 0, s);
  return static_cast<int>(cudaGetLastError());
}

// B14: t-major links, ghost planes in ``halo`` (common.cuh halo_from), no
// in-kernel boundary sign
extern "C" int mg_dslash_dist(const float* pre, const float* pim, const void* ure,
                              const void* uim, float* ore, float* oim, const float* k, int T,
                              int Z, int Y, int X, int rows, int bf16, const void* const* halo,
                              void* stream) {
  using namespace mg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MG_DIST(RR, LT)                                                                \
  launch_dslash<RR, LT, false, true>(pre, pim, ure, uim, ore, oim, k, T, Z, Y, X, 0, s, \
                                     halo_from<LT>(halo))
  if (rows == 3 && !bf16)
    MG_DIST(3, float);
  else if (rows == 2 && !bf16)
    MG_DIST(2, float);
  else if (rows == 3 && bf16)
    MG_DIST(3, __nv_bfloat16);
  else if (rows == 2 && bf16)
    MG_DIST(2, __nv_bfloat16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef MG_DIST
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
