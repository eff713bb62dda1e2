// The V-cycle's coarse GCR as hand-written kernels: one restart cycle of
// restarted GCR on flat CF vectors (M complex entries, re and im planes
// apart), with every scalar of the recurrence kept on the device.
//
// They replace no TPU kernel: the JAX package's coarse GCR is XLA vector
// algebra (the generic loop of mgpgcr_tpu/solvers/gcr.py). The recurrence
// is that loop's (the reference's GCR.h:222-288); one iteration after the
// operator's apply az = C r (B12 on the block-stencil coarse operator) is
//   dots    raw_j = <aps_j, az>, j < lim; the last block forms the betas
//           beta_j = raw_j / ap_norms_j, zero where ap_norms_j is 0;
//   dir     p = r - sum_{j<lim} beta_j ps_j, ap = az - sum_{j<lim} beta_j
//           aps_j into ring row `slot` of ps and aps, with ||ap||^2 and
//           <ap, r>; the last block clears ap_norms at a restart, stores
//           ap_norms[slot], and forms the active flag (not converged and
//           it < max_iter) and alpha = <ap, r> / ||ap||^2, zero when not
//           active;
//   update  x += alpha p, r -= alpha ap and ||r||^2; the last block counts
//           the iteration where active, keeps r2, records hist[it] and sets
//           the cycle's `going` flag.
// `start` opens a solve: x = 0, r = b, ||b||^2, it = 0, the history NaN but
// hist[0]; `dir` with lim 0 then stores the first direction. A masked
// iteration (past convergence or max_iter) runs with alpha 0 and leaves r2,
// it and the history as they were.
//
// Bound on an H100: latency, not bytes. At the config of record's coarse
// level (nb 4096, ne 20: M = 81,920, 655 KB a vector) the working set of a
// restart-10 solve (ps, aps, x, r, az: 15 MB) stays in the 50 MB L2, and
// the largest kernel, dir at lim 10, moves 15.7 MB: 4.7 us at HBM rate, less
// from L2. What the ATen form paid was ~95 launches an iteration, each a
// grid's ramp and drain, and reductions finished by further launches and
// one-element ops. Here each step is one pass, two elements a thread at
// this size (at most kCgMaxBlocks blocks, grid-stride), and the reduction's
// second stage and all of the scalar work run in the block that arrives
// last: every block stores its partials, fences, and takes a ticket; the
// block with the last ticket adds the partials and resets the ticket for
// the next launch. So an iteration is B12 and three kernels, with no
// second launch and no host read.
//
// Reductions: f32 within a thread, f64 from the warp shuffle on; the last
// block adds the blocks' partials per value in a fixed order (a group of
// lanes a value, each lane a fixed set of blocks, then one shuffle tree):
// no atomics on values, the same bits every run. Scalars are f32, as the
// generic loop's. A stack has at most kCgMaxRows rows, so the last block's
// sums fit its shared memory.
#include "common.cuh"

namespace mg {

namespace {

constexpr int kCgMaxBlocks = kThreads;  // so the last block folds a partial a thread
constexpr int kCgRows = 16;  // stack rows a thread loads together
constexpr float kCgTiny = 1e-30f;  // the generic loop's guard of a division (f32)

// As few elements a thread as keep the grid at kCgMaxBlocks blocks, and
// as many blocks as give every thread that many: at M = 81,920, 160 blocks
// of two elements a thread.
int cg_blocks(long long M) {
  const long long per_block = static_cast<long long>(kThreads) * kCgMaxBlocks;
  const long long each = (M + per_block - 1) / per_block;
  const long long b = (M + kThreads * each - 1) / (kThreads * each);
  return static_cast<int>(b > 0 ? b : 1);
}

// One shuffle tree a value, as warp_sum's, the N trees interleaved; the
// sums land on lane 0.
template <int N>
__device__ __forceinline__ void warp_sums(double (&d)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] += __shfl_down_sync(0xffffffffu, d[k], off);
}

__device__ __forceinline__ long long first_element() {
  return blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
}

__device__ __forceinline__ long long grid_step() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// Called by every thread once its block's partials are stored: true in
// the block that arrives last, which also resets the ticket. The fence
// before the ticket releases this block's partials; the fences after it in
// the last block acquire every block's, so no load there returns a copy of
// a partial that an earlier launch wrote to the same place.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) {
      __threadfence();
      *ticket = 0u;
    }
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: out[i] = the sum over the blocks of value i of
// partials (nblocks, nv), for i < nv <= 2 kCgMaxRows, in a fixed order: G
// neighbouring lanes a value (G the largest power of two <= 32 with G nv
// <= blockDim.x), lane g adding the blocks g, g + G, ... with its loads in
// flight together, then the G lanes by one shuffle tree.
__device__ __forceinline__ void fold(const double* partials, int nblocks, int nv, double* out) {
  int G = 32;
  while (G * nv > static_cast<int>(blockDim.x)) G >>= 1;
  const int i = threadIdx.x / G, g = threadIdx.x % G;
  double s = 0.0;
  if (i < nv) {
#pragma unroll 8
    for (int b = g; b < nblocks; b += G) s += __ldcg(partials + static_cast<long long>(b) * nv + i);
  }
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (g == 0 && i < nv) out[i] = s;
  __syncthreads();
}

// The block's sums of N per-thread values into partials + blockIdx.x *
// stride: each value f64 from the warp on, its shuffle tree as warp_sum's,
// the N trees interleaved; then the warps' sums in warp order.
template <int N>
__device__ __forceinline__ void block_sums(const float (&v)[N], double* sm, double* partials,
                                           long long stride) {
  double d[N];
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = v[k];
  warp_sums(d);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) sm[(threadIdx.x >> 5) * N + k] = d[k];
  block_flush_strided(sm, N, partials, stride);
}

}  // namespace

constexpr int kCgMaxRows = 64;  // S, the most stack rows (kernels/coarse_gcr.py MAX_ROWS)

// The scalar block of one solve (kernels/coarse_gcr.py CycleScalars.vals),
// S = the stack's rows: betas as (re, im) pairs, alpha, ap_norms, then r2,
// rhs_norm2 and the active flag (1 or 0).
struct CycleScalars {
  float* v;
  int S;
  __device__ __forceinline__ float* betas() const { return v; }
  __device__ __forceinline__ float* alpha() const { return v + 2 * S; }
  __device__ __forceinline__ float* ap_norms() const { return v + 2 * S + 2; }
  __device__ __forceinline__ float& r2() const { return v[3 * S + 2]; }
  __device__ __forceinline__ float& rhs_norm2() const { return v[3 * S + 3]; }
  __device__ __forceinline__ float& active() const { return v[3 * S + 4]; }
};

__global__ void __launch_bounds__(kThreads)
coarse_gcr_start_kernel(const float* __restrict__ b_re, const float* __restrict__ b_im,
                        float* __restrict__ x_re, float* __restrict__ x_im,
                        float* __restrict__ r_re, float* __restrict__ r_im, CycleScalars sc,
                        float* __restrict__ hist, long long* __restrict__ it,
                        double* __restrict__ partials, unsigned int* ticket, long long M,
                        int max_iter) {
  __shared__ double sm[kWarps];
  float nrm[1] = {0.f};
  for (long long e = first_element(); e < M; e += grid_step()) {
    const float br = b_re[e], bi = b_im[e];
    x_re[e] = 0.f;
    x_im[e] = 0.f;
    r_re[e] = br;
    r_im[e] = bi;
    nrm[0] += br * br + bi * bi;
  }
  for (long long i = first_element(); i <= max_iter; i += grid_step())
    hist[i] = __int_as_float(0x7fc00000);  // NaN: not reached
  block_sums<1>(nrm, sm, partials, 1);
  if (!last_block(ticket)) return;
  __shared__ double tot[1];
  fold(partials, gridDim.x, 1, tot);
  if (threadIdx.x == 0) {
    const float n2 = static_cast<float>(tot[0]);
    sc.r2() = n2;
    sc.rhs_norm2() = n2;
    *it = 0;
    hist[0] = sqrtf(n2 / fmaxf(n2, kCgTiny));
  }
}

// The dots of NJ rows [j0, j0 + NJ) of the stack with az into partials
// columns [2 j0, 2 j0 + 2 NJ) of (gridDim.x, 2 lim); the row count is a
// template argument, so the row loads issue together.
template <int NJ>
__device__ __forceinline__ void dot_rows(const float* __restrict__ aps_re,
                                         const float* __restrict__ aps_im,
                                         const float* __restrict__ az_re,
                                         const float* __restrict__ az_im, long long M, int j0,
                                         int lim, double* sm, double* partials) {
  float v[2 * NJ];  // (re, im) of each row's dot
#pragma unroll
  for (int k = 0; k < 2 * NJ; ++k) v[k] = 0.f;
  for (long long e = first_element(); e < M; e += grid_step()) {
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
      v[2 * i] += ar[i] * zr + ai[i] * zi;
      v[2 * i + 1] += ar[i] * zi - ai[i] * zr;
    }
  }
  block_sums<2 * NJ>(v, sm, partials + 2 * j0, 2LL * lim);
}

__global__ void __launch_bounds__(kThreads)
coarse_gcr_dots_kernel(const float* __restrict__ aps_re, const float* __restrict__ aps_im,
                       const float* __restrict__ az_re, const float* __restrict__ az_im,
                       CycleScalars sc, double* __restrict__ partials, unsigned int* ticket,
                       long long M, int lim) {
  __shared__ double sm[kWarps * 2 * kCgRows];
  for (int j0 = 0; j0 < lim; j0 += kCgRows) {
    if (j0 > 0) __syncthreads();  // the previous chunk's flush has read sm
#define MG_DOT(NJ) \
  case NJ: dot_rows<NJ>(aps_re, aps_im, az_re, az_im, M, j0, lim, sm, partials); break
    switch (lim - j0 < kCgRows ? lim - j0 : kCgRows) {
      MG_DOT(1); MG_DOT(2); MG_DOT(3); MG_DOT(4); MG_DOT(5); MG_DOT(6); MG_DOT(7); MG_DOT(8);
      MG_DOT(9); MG_DOT(10); MG_DOT(11); MG_DOT(12); MG_DOT(13); MG_DOT(14); MG_DOT(15);
      default: dot_rows<kCgRows>(aps_re, aps_im, az_re, az_im, M, j0, lim, sm, partials); break;
    }
#undef MG_DOT
  }
  if (!last_block(ticket)) return;
  __shared__ double raw[2 * kCgMaxRows];
  fold(partials, gridDim.x, 2 * lim, raw);
  // beta_j = raw_j / ap_norms_j, zero where the slot is empty and from lim on
  const float* norms = sc.ap_norms();
  float* betas = sc.betas();
  for (int j = threadIdx.x; j < sc.S; j += blockDim.x) {
    float br = 0.f, bi = 0.f;
    const float n = j < lim ? norms[j] : 0.f;
    if (n > 0.f) {
      const float inv = 1.f / fmaxf(n, kCgTiny);
      br = static_cast<float>(raw[2 * j]) * inv;
      bi = static_cast<float>(raw[2 * j + 1]) * inv;
    }
    betas[2 * j] = br;
    betas[2 * j + 1] = bi;
  }
}

// p -= sum beta_j ps_j and ap -= sum beta_j aps_j over NJ rows [j0, j0 +
// NJ) at element e, the rows' loads issued together
template <int NJ>
__device__ __forceinline__ void sub_rows(const float* ps_re, const float* ps_im,
                                         const float* aps_re, const float* aps_im,
                                         const float2* betas, long long e, long long M, int j0,
                                         float& pr, float& pi, float& ar, float& ai) {
  float qr[NJ], qi[NJ], sr[NJ], si[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const long long o = static_cast<long long>(j0 + i) * M + e;
    qr[i] = ps_re[o];
    qi[i] = ps_im[o];
    sr[i] = aps_re[o];
    si[i] = aps_im[o];
  }
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const float2 b = betas[j0 + i];
    pr -= b.x * qr[i] - b.y * qi[i];
    pi -= b.x * qi[i] + b.y * qr[i];
    ar -= b.x * sr[i] - b.y * si[i];
    ai -= b.x * si[i] + b.y * sr[i];
  }
}

// ps and aps are read and written (row `slot` may lie inside the live
// prefix: at a restart it is row 0 of lim = S); each element's rows are
// all read before its slot is written, by the same thread. Partials per
// block: [<ap, r> re, <ap, r> im, ||ap||^2].
__global__ void __launch_bounds__(kThreads)
coarse_gcr_dir_kernel(const float* __restrict__ r_re, const float* __restrict__ r_im,
                      const float* __restrict__ az_re, const float* __restrict__ az_im,
                      float* ps_re, float* ps_im, float* aps_re, float* aps_im, CycleScalars sc,
                      const long long* __restrict__ it, double* __restrict__ partials,
                      unsigned int* ticket, long long M, int lim, int slot, int clear,
                      float tol2, int max_iter) {
  __shared__ double sm[kWarps * 3];
  const float2* betas = reinterpret_cast<const float2*>(sc.betas());
  float v[3] = {0.f, 0.f, 0.f};  // <ap, r> re, im, ||ap||^2
  for (long long e = first_element(); e < M; e += grid_step()) {
    const float rr = r_re[e], ri = r_im[e];
    float pr = rr, pi = ri, ar = az_re[e], ai = az_im[e];
    for (int j0 = 0; j0 < lim; j0 += kCgRows) {
#define MG_SUB(NJ) \
  case NJ: sub_rows<NJ>(ps_re, ps_im, aps_re, aps_im, betas, e, M, j0, pr, pi, ar, ai); break
      switch (lim - j0 < kCgRows ? lim - j0 : kCgRows) {
        MG_SUB(1); MG_SUB(2); MG_SUB(3); MG_SUB(4); MG_SUB(5); MG_SUB(6); MG_SUB(7); MG_SUB(8);
        MG_SUB(9); MG_SUB(10); MG_SUB(11); MG_SUB(12); MG_SUB(13); MG_SUB(14); MG_SUB(15);
        default:
          sub_rows<kCgRows>(ps_re, ps_im, aps_re, aps_im, betas, e, M, j0, pr, pi, ar, ai);
          break;
      }
#undef MG_SUB
    }
    const long long o = static_cast<long long>(slot) * M + e;
    ps_re[o] = pr;
    ps_im[o] = pi;
    aps_re[o] = ar;
    aps_im[o] = ai;
    v[0] += ar * rr + ai * ri;
    v[1] += ar * ri - ai * rr;
    v[2] += ar * ar + ai * ai;
  }
  block_sums<3>(v, sm, partials, 3);
  if (!last_block(ticket)) return;
  __shared__ double tot[3];
  fold(partials, gridDim.x, 3, tot);
  float* norms = sc.ap_norms();
  if (clear)  // a restart retires the stored directions
    for (int j = threadIdx.x; j < sc.S; j += blockDim.x) norms[j] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float apr = static_cast<float>(tot[0]), api = static_cast<float>(tot[1]);
    const float ap2 = static_cast<float>(tot[2]);
    norms[slot] = ap2;
    const bool active = sc.r2() > tol2 * sc.rhs_norm2() && *it < max_iter;
    const float act = active ? 1.f : 0.f;
    const float inv = 1.f / fmaxf(ap2, kCgTiny);
    sc.alpha()[0] = apr * inv * act;
    sc.alpha()[1] = api * inv * act;
    sc.active() = act;
  }
}

// x and r in place; p and ap are the stacks' row `slot`
__global__ void __launch_bounds__(kThreads)
coarse_gcr_update_kernel(float* __restrict__ x_re, float* __restrict__ x_im,
                         float* __restrict__ r_re, float* __restrict__ r_im,
                         const float* __restrict__ p_re, const float* __restrict__ p_im,
                         const float* __restrict__ ap_re, const float* __restrict__ ap_im,
                         CycleScalars sc, float* __restrict__ hist, long long* __restrict__ it,
                         bool* __restrict__ going, double* __restrict__ partials,
                         unsigned int* ticket, long long M, float tol2, int max_iter) {
  __shared__ double sm[kWarps];
  const float alr = sc.alpha()[0], ali = sc.alpha()[1];
  float nrm[1] = {0.f};
  for (long long e = first_element(); e < M; e += grid_step()) {
    const float pr = p_re[e], pi = p_im[e];
    x_re[e] += pr * alr - pi * ali;
    x_im[e] += pr * ali + pi * alr;
    const float qr = ap_re[e], qi = ap_im[e];
    const float nr = r_re[e] - (qr * alr - qi * ali);
    const float ni = r_im[e] - (qr * ali + qi * alr);
    r_re[e] = nr;
    r_im[e] = ni;
    nrm[0] += nr * nr + ni * ni;
  }
  block_sums<1>(nrm, sm, partials, 1);
  if (!last_block(ticket)) return;
  __shared__ double tot[1];
  fold(partials, gridDim.x, 1, tot);
  if (threadIdx.x == 0) {
    const double n = tot[0];
    long long k = *it;
    const float rhs2 = sc.rhs_norm2();
    if (sc.active() > 0.f && k < max_iter) {  // active implies k < max_iter
      k += 1;
      *it = k;
      const float r2 = static_cast<float>(n);
      sc.r2() = r2;
      hist[k] = sqrtf(r2 / fmaxf(rhs2, kCgTiny));
    }
    *going = sc.r2() > tol2 * rhs2 && k < max_iter;
  }
}

}  // namespace mg

// One solve's device state for every launcher: sc, the scalar block of S
// stack rows; partials, kCgMaxBlocks * max(2 S, 3) doubles; ticket, one
// zeroed unsigned int that each kernel leaves at zero.

// x = 0, r = b, rhs_norm2 = r2 = ||b||^2, it = 0, hist = NaN but hist[0]
extern "C" int mg_coarse_gcr_start(const float* b_re, const float* b_im, float* x_re,
                                   float* x_im, float* r_re, float* r_im, float* sc, float* hist,
                                   long long* it, double* partials, unsigned int* ticket,
                                   long long M, int S, int max_iter, void* stream) {
  using namespace mg;
  coarse_gcr_start_kernel<<<cg_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b_re, b_im, x_re, x_im, r_re, r_im, CycleScalars{sc, S}, hist, it, partials, ticket, M,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}

// the betas of rows j < lim (1 <= lim <= S), zero from lim on
extern "C" int mg_coarse_gcr_dots(const float* aps_re, const float* aps_im, const float* az_re,
                                  const float* az_im, float* sc, double* partials,
                                  unsigned int* ticket, long long M, int S, int lim,
                                  void* stream) {
  using namespace mg;
  coarse_gcr_dots_kernel<<<cg_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aps_re, aps_im, az_re, az_im, CycleScalars{sc, S}, partials, ticket, M, lim);
  return static_cast<int>(cudaGetLastError());
}

// the new direction into row `slot` from the betas of rows j < lim
// (0 <= lim <= S); clear != 0 at a restart
extern "C" int mg_coarse_gcr_dir(const float* r_re, const float* r_im, const float* az_re,
                                 const float* az_im, float* ps_re, float* ps_im, float* aps_re,
                                 float* aps_im, float* sc, const long long* it, double* partials,
                                 unsigned int* ticket, long long M, int S, int lim, int slot,
                                 int clear, float tol2, int max_iter, void* stream) {
  using namespace mg;
  coarse_gcr_dir_kernel<<<cg_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r_re, r_im, az_re, az_im, ps_re, ps_im, aps_re, aps_im, CycleScalars{sc, S}, it, partials,
      ticket, M, lim, slot, clear, tol2, max_iter);
  return static_cast<int>(cudaGetLastError());
}

// x += alpha ps[slot], r -= alpha aps[slot], and the iteration's scalars
extern "C" int mg_coarse_gcr_update(float* x_re, float* x_im, float* r_re, float* r_im,
                                    const float* ps_re, const float* ps_im, const float* aps_re,
                                    const float* aps_im, float* sc, float* hist, long long* it,
                                    bool* going, double* partials, unsigned int* ticket,
                                    long long M, int S, int slot, float tol2, int max_iter,
                                    void* stream) {
  using namespace mg;
  const long long off = static_cast<long long>(slot) * M;
  coarse_gcr_update_kernel<<<cg_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x_re, x_im, r_re, r_im, ps_re + off, ps_im + off, aps_re + off, aps_im + off,
      CycleScalars{sc, S}, hist, it, going, partials, ticket, M, tol2, max_iter);
  return static_cast<int>(cudaGetLastError());
}
