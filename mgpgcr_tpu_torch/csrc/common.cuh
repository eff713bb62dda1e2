// Shared device code of the Wilson-Dirac kernels: split re/im complex
// arithmetic, SU(3) link loads (3-row or 2-row, f32 or bf16 storage), the
// half-spinor hop algebra, the per-site stencil, and deterministic block
// reductions.
//
// Layouts (all C-contiguous, site index fastest):
//   field  (4, 3, T, Z, V), V = Y*X, re and im in separate arrays;
//   links  (T, 4, R, 3, Z, V), R = 3, or 2 with row 2 = conj(row0 x row1).
// One thread owns one lattice site; neighbour offsets come from index
// arithmetic on (t, z, y, x), with y and x merged in the last axis.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mg {

struct cf {
  float re, im;
};

__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// conj(a) * b
__device__ __forceinline__ cf cmulc(cf a, cf b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}
__device__ __forceinline__ cf cscale(cf a, float s) { return {a.re * s, a.im * s}; }

// unit coefficients: 0 = +1, 1 = -1, 2 = +i, 3 = -i; code ^ 1 negates
template <int C>
__device__ __forceinline__ cf unit_mul(cf z) {
  if (C == 0) return z;
  if (C == 1) return {-z.re, -z.im};
  if (C == 2) return {-z.im, z.re};
  return {z.im, -z.re};
}

// spatial half-spinor table, forward factor (1 - gamma_mu), mu = 1 (z),
// 2 (y), 3 (x):  h0 = psi0 + c0 psi_j0, h1 = psi1 + c1 psi_j1;
// out2 += r2 g_k2, out3 += r3 g_k3. The backward factor negates c and r.
// (ops/wilson_slab.py HALF_SPINOR, in the codes above.)
template <int MU> struct HS;
template <> struct HS<1> { enum { j0 = 2, c0 = 2, j1 = 3, c1 = 3, k2 = 0, r2 = 3, k3 = 1, r3 = 2 }; };
template <> struct HS<2> { enum { j0 = 3, c0 = 0, j1 = 2, c1 = 1, k2 = 1, r2 = 1, k3 = 0, r3 = 0 }; };
template <> struct HS<3> { enum { j0 = 3, c0 = 2, j1 = 2, c1 = 2, k2 = 1, r2 = 3, k3 = 0, r3 = 3 }; };

template <typename LT> __device__ __forceinline__ float ld(const LT* p, int i);
template <> __device__ __forceinline__ float ld<float>(const float* p, int i) { return __ldg(p + i); }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

struct su3 {
  cf m[3][3];
};

// U_mu at the site with plane offset zv = z*V + v in t-plane t.
template <int R, typename LT>
__device__ __forceinline__ void load_link(su3& u, const LT* ure, const LT* uim, int t, int mu,
                                          int zv, int ZV) {
  const int base = (t * 4 + mu) * R * 3 * ZV + zv;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int o = base + (a * 3 + b) * ZV;
      u.m[a][b] = {ld<LT>(ure, o), ld<LT>(uim, o)};
    }
  if (R == 2) {
    // row2 = conj(row0 x row1): an SU(3) matrix's third row
    const cf* r0 = u.m[0];
    const cf* r1 = u.m[1];
    cf c0 = csub(cmul(r0[1], r1[2]), cmul(r0[2], r1[1]));
    cf c1 = csub(cmul(r0[2], r1[0]), cmul(r0[0], r1[2]));
    cf c2 = csub(cmul(r0[0], r1[1]), cmul(r0[1], r1[0]));
    u.m[2][0] = {c0.re, -c0.im};
    u.m[2][1] = {c1.re, -c1.im};
    u.m[2][2] = {c2.re, -c2.im};
  }
}

// Reads psi(s, c) at site n from a field.
struct FieldLoad {
  const float* re;
  const float* im;
  int N;
  __device__ __forceinline__ cf operator()(int s, int c, int n) const {
    const int o = (s * 3 + c) * N + n;
    return {__ldg(re + o), __ldg(im + o)};
  }
};

// Reads the updated residual r' = r - alpha * ap at site n without
// materialising it: the one-pass GCR step's stencil input.
struct RPrimeLoad {
  const float* rre;
  const float* rim;
  const float* are;
  const float* aim;
  cf alpha;
  int N;
  __device__ __forceinline__ cf operator()(int s, int c, int n) const {
    const int o = (s * 3 + c) * N + n;
    cf r = {__ldg(rre + o), __ldg(rim + o)};
    cf a = {__ldg(are + o), __ldg(aim + o)};
    return csub(r, cmul(alpha, a));
  }
};

struct Geom {
  int T, Z, Y, X, V, ZV, N;
  __device__ __forceinline__ Geom(int T_, int Z_, int Y_, int X_)
      : T(T_), Z(Z_), Y(Y_), X(X_), V(Y_ * X_), ZV(Z_ * Y_ * X_), N(T_ * Z_ * Y_ * X_) {}
};

// g = U h (FWD) or U^dag h (backward) for both half-spinor components
template <bool FWD>
__device__ __forceinline__ void colour_mul(const su3& u, const cf (&h)[2][3], cf (&g)[2][3]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cf acc = {0.f, 0.f};
#pragma unroll
      for (int b = 0; b < 3; ++b)
        acc = cadd(acc, FWD ? cmul(u.m[a][b], h[i][b]) : cmulc(u.m[b][a], h[i][b]));
      g[i][a] = acc;
    }
}

// One spatial hop (MU = 1, 2, 3): project psi at neighbour nb, colour
// multiply, reconstruct into out.
template <int MU, bool FWD, class Load>
__device__ __forceinline__ void spatial_hop(const Load& L, int nb, const su3& u, cf (&out)[4][3]) {
  constexpr int cf0 = FWD ? HS<MU>::c0 : (HS<MU>::c0 ^ 1);
  constexpr int cf1 = FWD ? HS<MU>::c1 : (HS<MU>::c1 ^ 1);
  constexpr int rr2 = FWD ? HS<MU>::r2 : (HS<MU>::r2 ^ 1);
  constexpr int rr3 = FWD ? HS<MU>::r3 : (HS<MU>::r3 ^ 1);
  cf h[2][3], g[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    h[0][c] = cadd(L(0, c, nb), unit_mul<cf0>(L(HS<MU>::j0, c, nb)));
    h[1][c] = cadd(L(1, c, nb), unit_mul<cf1>(L(HS<MU>::j1, c, nb)));
  }
  colour_mul<FWD>(u, h, g);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[0][c] = cadd(out[0][c], g[0][c]);
    out[1][c] = cadd(out[1][c], g[1][c]);
    out[2][c] = cadd(out[2][c], unit_mul<rr2>(g[HS<MU>::k2][c]));
    out[3][c] = cadd(out[3][c], unit_mul<rr3>(g[HS<MU>::k3][c]));
  }
}

// The temporal hop: (1 - gamma_t) = diag(0,0,2,2) forward, (1 + gamma_t) =
// diag(2,2,0,0) backward; ``sign`` carries the anti-periodic boundary.
template <bool FWD, class Load>
__device__ __forceinline__ void temporal_hop(const Load& L, int nb, const su3& u, float sign,
                                             cf (&out)[4][3]) {
  constexpr int lo = FWD ? 2 : 0;
  cf h[2][3], g[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    h[0][c] = cscale(L(lo, c, nb), sign);
    h[1][c] = cscale(L(lo + 1, c, nb), sign);
  }
  colour_mul<FWD>(u, h, g);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[lo][c] = cadd(out[lo][c], cscale(g[0][c], 2.f));
    out[lo + 1][c] = cadd(out[lo + 1][c], cscale(g[1][c], 2.f));
  }
}

// out = (D psi)(site n), psi read through L; site n = (t, z, v).
template <int R, typename LT, class Load>
__device__ __forceinline__ void dslash_site(const Load& L, const LT* ure, const LT* uim,
                                            const Geom& g, int n, bool anti_t, cf (&out)[4][3]) {
  const int t = n / g.ZV;
  const int zv = n - t * g.ZV;
  const int z = zv / g.V;
  const int v = zv - z * g.V;
  const int y = v / g.X;
  const int x = v - y * g.X;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[s][c] = {0.f, 0.f};
  su3 u;
  // t: neighbours are whole planes away
  {
    const int tf = (t + 1 == g.T) ? 0 : t + 1;
    const int tb = (t == 0) ? g.T - 1 : t - 1;
    load_link<R, LT>(u, ure, uim, t, 0, zv, g.ZV);
    temporal_hop<true>(L, tf * g.ZV + zv, u, (anti_t && t + 1 == g.T) ? -1.f : 1.f, out);
    load_link<R, LT>(u, ure, uim, tb, 0, zv, g.ZV);
    temporal_hop<false>(L, tb * g.ZV + zv, u, (anti_t && t == 0) ? -1.f : 1.f, out);
  }
  const int tplane = t * g.ZV;
  // z
  {
    const int zf = (z + 1 == g.Z) ? 0 : z + 1;
    const int zb = (z == 0) ? g.Z - 1 : z - 1;
    load_link<R, LT>(u, ure, uim, t, 1, zv, g.ZV);
    spatial_hop<1, true>(L, tplane + zf * g.V + v, u, out);
    load_link<R, LT>(u, ure, uim, t, 1, zb * g.V + v, g.ZV);
    spatial_hop<1, false>(L, tplane + zb * g.V + v, u, out);
  }
  const int zrow = tplane + z * g.V;
  // y: a step of X on the merged axis
  {
    const int vf = (y + 1 == g.Y) ? x : v + g.X;
    const int vb = (y == 0) ? (g.Y - 1) * g.X + x : v - g.X;
    load_link<R, LT>(u, ure, uim, t, 2, zv, g.ZV);
    spatial_hop<2, true>(L, zrow + vf, u, out);
    load_link<R, LT>(u, ure, uim, t, 2, z * g.V + vb, g.ZV);
    spatial_hop<2, false>(L, zrow + vb, u, out);
  }
  // x
  {
    const int vf = (x + 1 == g.X) ? v - x : v + 1;
    const int vb = (x == 0) ? v + g.X - 1 : v - 1;
    load_link<R, LT>(u, ure, uim, t, 3, zv, g.ZV);
    spatial_hop<3, true>(L, zrow + vf, u, out);
    load_link<R, LT>(u, ure, uim, t, 3, z * g.V + vb, g.ZV);
    spatial_hop<3, false>(L, zrow + vb, u, out);
  }
}

// ---- deterministic reductions --------------------------------------------
// Per value: f32 within a thread, f64 from the warp shuffle on; lane 0 of
// each warp stores its sum in shared memory, then the warps' sums are added
// in warp order into one partial per block, and ``reduce_partials`` adds
// the blocks' partials in block order. No atomics: the same inputs give the
// same bits.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// every thread of the block must call this with the same idx
__device__ __forceinline__ void block_put(double* sm, int nv, int idx, float v) {
  const double s = warp_sum(static_cast<double>(v));
  if ((threadIdx.x & 31) == 0) sm[(threadIdx.x >> 5) * nv + idx] = s;
}

// block b's nv values go to partials[b * stride + i]
__device__ __forceinline__ void block_flush_strided(const double* sm, int nv, double* partials,
                                                    long long stride) {
  __syncthreads();
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += sm[w * nv + i];
    partials[static_cast<long long>(blockIdx.x) * stride + i] = s;
  }
}

__device__ __forceinline__ void block_flush(const double* sm, int nv, double* partials) {
  block_flush_strided(sm, nv, partials, nv);
}

// res[i] = sum over blocks b of partials[b * nv + i], for i < nv; launched
// with one block per value.
cudaError_t reduce_partials(const double* partials, int nblocks, int nv, float* res,
                            cudaStream_t stream);

}  // namespace mg
