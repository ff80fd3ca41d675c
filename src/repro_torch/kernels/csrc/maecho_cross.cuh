// The fixed-order pair contraction of flat residual rows, G[i, j] =
// <Ra_i, Rb_j>: B19's kernels (maecho_gram_cross.cu), shared with B1
// (maecho_gram.cu), which contracts its residual stack R (N, out*in)
// with itself (Ra = Rb, so G is exactly symmetric).
//
// Design.  The TPU kernel streamed D through VMEM in bd-wide slabs and
// carried one (ca, cb) accumulator across its sequential grid.  Hopper
// runs blocks in no order, so this is a split-K product: D is cut into
// slabs of whole k-steps, the client axes into output tiles, one CTA of
// 256 threads takes one (slab, tile) and writes its partial to a
// workspace, and a second launch sums the partials in a fixed order: no
// atomics, so G — and the QP's alpha — is bitwise reproducible.  That sum
// is spread over 32 warps an entry (gram_cross_reduce_kernel): the Gram
// kernels' gram_reduce_kernel (maecho_tile.cuh), one thread an entry
// walking every slab in series, took 12.6 of B19's 43.4 us at (1, 64,
// 313 600) with 396 slabs on the H100.
//
// The chunks the callers form range from one client (client_chunk = 1,
// the LLM embedding's (1, 1, 896 x 151 936) pairs) to 64 and more, so the
// tile is fitted to them: each client axis takes a tile of 64 rows if
// c > 32, 16 if c > 4, else c itself (1-4), and one kernel template
// <TM, TN> covers every pair (the wider tile on the first axis; the other
// order runs with the operands swapped and G written transposed).  A
// thread holds an RM x RN block (RM = min(TM, 4)), TY x TX threads cover
// the tile and the KS = 256 / (TY TX) threads that share a block split
// each k-step's columns between them; their partial sums are reduced with
// warp shuffles (and, for KS > 32, a shared-memory step) in a fixed order.
//   - A narrow side of 1-4 rows (TN <= 4): straight from registers, each
//     thread several 16-byte loads of its rows in flight.  For tiny pairs
//     (ca, cb <= 4, so ca cb <= 16) KS = 256: every thread accumulates all
//     ca cb dots over its own strided columns.  These few long dots are
//     summed in fp64 (exact products, fp64 partials and reduce, one
//     rounding to fp32): a dot of two unrelated rows cancels to
//     |G| << sum |a b|, where any fp32 summation errs by ~1e-4 at
//     D = 2^20 (eps sqrt(D log D) per unit term) and so misses 1e-5 |G|;
//     the path is bound by bytes, so the fp64 work costs no time.
//   - Both sides 16 or 64 rows: the k-step's TM + TN rows are staged in
//     shared memory (the next step's loads in registers while the current
//     one is contracted) and each thread contracts its 16-byte column
//     quads, in fp32 FMA (these tiles are bound by their FMAs).
// Loads are 16-byte float4 when D % 4 == 0 and both bases are 16-byte
// aligned, scalar otherwise (the ragged D = 60 001: odd rows start
// misaligned) — a template flag; each operand row is read once per slab
// and tile.  The ragged end of D and the ragged client edges are masked on
// load (zero adds zero) and on store; nothing is padded.  The slab count
// fills the card in one wave (as many CTAs as it holds at once, at most 4
// an SM) with at least two k-steps a slab, at most 512, and keeps the
// workspace under 2^26 floats; slabs differ by at most one k-step.
//
// Exact symmetry: with Ra == Rb and ca == cb both axes take the same tile,
// every G[i, j] sums the same k order as G[j, i], and fmaf(a, b, s) ==
// fmaf(b, a, s), so G == G^T bit for bit.

#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {
namespace cross {

constexpr int kCThreads = 256;
constexpr int kCtasPerSm = 4;
constexpr long long kMinSteps = 2;
constexpr long long kMaxSteps = 512;
constexpr long long kMaxWorkspace = 1LL << 26;   // floats

constexpr int tile_of(int c) { return c > 32 ? 64 : c > 4 ? 16 : c; }

template <int TM, int TN, bool kF64 = false>
struct Tile {
  static constexpr int RM = TM < 4 ? TM : 4, RN = TN < 4 ? TN : 4;   // a thread's block
  static constexpr int TY = TM / RM, TX = TN / RN;                    // threads over the tile
  static constexpr int KS = kCThreads / (TY * TX);                    // threads splitting k
  static constexpr bool kDirect = TN <= 4;                            // B rows straight to registers
  // direct: U quads of each of the thread's rows a step (about 8 loads);
  // staged: two quads a thread and step (KS > 1), or eight (KS = 1)
  static constexpr int U = kDirect ? (8 / (RM + TN) > 1 ? 8 / (RM + TN) : 1) : 1;
  static constexpr int KC = kDirect ? 4 * KS * U : (KS == 1 ? 32 : 8 * KS);   // columns a step
  static constexpr int LD = KC + 4;                                   // shared row pitch
  static constexpr int Q = KC / 4;                                    // quads a row and step
  static constexpr int QL = ((TM + TN) * Q + kCThreads - 1) / kCThreads;   // staged a thread
  // the direct path is bound by bytes, so it sums in fp64 at no cost in
  // time; the staged tiles are bound by their FMAs and sum in fp32 (fp64
  // with kF64: B1's Gram, whose tolerance leaves no room for fp32 sums)
  using Acc = typename std::conditional<kDirect || kF64, double, float>::type;
};

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ P, int row, int nrows,
                                        long long c, long long D) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= nrows || c >= D) return x;
  const float* p = P + (size_t)row * D + c;
  if constexpr (kVec) {
    x = *reinterpret_cast<const float4*>(p);
  } else {
    x.x = p[0];
    if (c + 1 < D) x.y = p[1];
    if (c + 2 < D) x.z = p[2];
    if (c + 3 < D) x.w = p[3];
  }
  return x;
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// the same in fp64: the products of fp32 operands are exact
__device__ __forceinline__ double fma4(float4 a, float4 b, double s) {
  s = fma((double)a.x, (double)b.x, s);
  s = fma((double)a.y, (double)b.y, s);
  s = fma((double)a.z, (double)b.z, s);
  return fma((double)a.w, (double)b.w, s);
}

// Partial H[i, j] = <A_i, B_j> of one (slab, TM x TN tile) over A (na, D)
// and B (nb, D): slab = blockIdx.x, tile columns (B rows) blockIdx.y, tile
// rows (A rows) blockIdx.z; written to ws[slab][i * ldi + j * ldj] as
// Acc (fp64 on the direct path, fp32 on the staged one).  Slab s takes
// k-steps [s nk / slabs, (s + 1) nk / slabs).
template <int TM, int TN, bool kVec, bool kF64>
__global__ void __launch_bounds__(kCThreads)
gram_cross_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          void* __restrict__ ws_raw, int na, int nb, long long D, long long nk,
                          int ldi, int ldj) {
  using T = Tile<TM, TN, kF64>;
  using Acc = typename T::Acc;
  constexpr int RM = T::RM, RN = T::RN, KS = T::KS;
  const int tid = threadIdx.x, kq = tid % KS, tx = (tid / KS) % T::TX, ty = tid / KS / T::TX;
  const int i0 = blockIdx.z * TM, j0 = blockIdx.y * TN;
  const long long step0 = blockIdx.x * nk / gridDim.x, step1 = (blockIdx.x + 1) * nk / gridDim.x;
  Acc acc[RM][RN];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[m][n] = 0;

  if constexpr (T::kDirect) {
    // quads kq + KS u of each step; the TN rows of B are read by every row
    // group ty (L1 hits: TN <= 4 of the TM + TN rows)
    for (long long step = step0; step < step1; ++step) {
      float4 a[T::U][RM], b[T::U][TN];
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        const long long c = step * T::KC + 4LL * (kq + KS * u);
#pragma unroll
        for (int m = 0; m < RM; ++m) a[u][m] = load4<kVec>(A, i0 + ty + T::TY * m, na, c, D);
#pragma unroll
        for (int n = 0; n < TN; ++n) b[u][n] = load4<kVec>(B, j0 + n, nb, c, D);
      }
#pragma unroll
      for (int u = 0; u < T::U; ++u)
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fma4(a[u][m], b[u][n], acc[m][n]);
    }
  } else {
    __shared__ __align__(16) float sa[TM * T::LD];
    __shared__ __align__(16) float sb[TN * T::LD];
    float4 staged[T::QL];
    auto load = [&](long long step) {
#pragma unroll
      for (int q = 0; q < T::QL; ++q) {
        const int e = tid + q * kCThreads, r = e / T::Q;
        const long long c = step * T::KC + 4 * (e % T::Q);
        staged[q] = r < TM        ? load4<kVec>(A, i0 + r, na, c, D)
                    : r < TM + TN ? load4<kVec>(B, j0 + r - TM, nb, c, D)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    if (step0 < step1) load(step0);
    for (long long step = step0; step < step1; ++step) {
#pragma unroll
      for (int q = 0; q < T::QL; ++q) {
        const int e = tid + q * kCThreads, r = e / T::Q, c = 4 * (e % T::Q);
        if (r < TM)
          *reinterpret_cast<float4*>(&sa[r * T::LD + c]) = staged[q];
        else if (r < TM + TN)
          *reinterpret_cast<float4*>(&sb[(r - TM) * T::LD + c]) = staged[q];
      }
      __syncthreads();
      if (step + 1 < step1) load(step + 1);
#pragma unroll
      for (int t = 0; t < T::Q / KS; ++t) {
        const int c = 4 * (kq + KS * t);
        float4 a[RM], b[RN];
#pragma unroll
        for (int m = 0; m < RM; ++m)
          a[m] = *reinterpret_cast<const float4*>(&sa[(ty + T::TY * m) * T::LD + c]);
#pragma unroll
        for (int n = 0; n < RN; ++n)
          b[n] = *reinterpret_cast<const float4*>(&sb[(tx + T::TX * n) * T::LD + c]);
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int n = 0; n < RN; ++n) acc[m][n] = fma4(a[m], b[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

  // sum each block over the KS threads (consecutive lanes) that share it:
  // a butterfly within the warp, then warps in index order
  constexpr int KW = KS < 32 ? KS : 32;
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n)
#pragma unroll
      for (int off = KW / 2; off > 0; off /= 2)
        acc[m][n] += __shfl_xor_sync(0xffffffffu, acc[m][n], off);
  if constexpr (KS > 32) {
    __shared__ Acc red[kCThreads / 32][RM * RN];
    const int warp = tid / 32;
    if (tid % 32 == 0)
#pragma unroll
      for (int m = 0; m < RM; ++m)
#pragma unroll
        for (int n = 0; n < RN; ++n) red[warp][m * RN + n] = acc[m][n];
    __syncthreads();
    if (kq != 0) return;
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        Acc s = red[warp][m * RN + n];
#pragma unroll
        for (int w = 1; w < KS / 32; ++w) s += red[warp + w][m * RN + n];
        acc[m][n] = s;
      }
  }
  if (kq != 0) return;
  Acc* out = static_cast<Acc*>(ws_raw) + (size_t)blockIdx.x * na * nb;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = i0 + ty + T::TY * m;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int j = j0 + tx + T::TX * n;
      if (i < na && j < nb) out[(size_t)i * ldi + (size_t)j * ldj] = acc[m][n];
    }
  }
}

// G[e] = the partials of entry e summed in a fixed order over slabs: warp
// w of a block sums slabs w, w + 32, ... in order for 32 consecutive
// entries (one a lane, coalesced), then one lane an entry adds the 32 warp
// sums in order.  No atomics (reproducible), and every entry sums in the
// same order (a symmetric set of partials stays symmetric).
constexpr int kRWarps = 32;
template <class Acc>
__global__ void __launch_bounds__(kRWarps * 32)
gram_cross_reduce_kernel(const Acc* __restrict__ ws, float* __restrict__ G, int slabs, int NN) {
  __shared__ Acc red[kRWarps][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, e = blockIdx.x * 32 + lane;
  Acc s = 0;
  if (e < NN)
    for (int t = w; t < slabs; t += kRWarps) s += ws[(size_t)t * NN + e];
  red[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= NN) return;
  s = red[0][lane];
#pragma unroll
  for (int v = 1; v < kRWarps; ++v) s += red[v][lane];
  G[e] = (float)s;
}

using PartialFn = void (*)(const float*, const float*, void*, int, int, long long, long long,
                           int, int);

// What one launch runs: the kernels of the (wider, narrower) tile pair,
// whether Ra and Rb swap, and the split of D into slabs
struct Plan {
  PartialFn vec = nullptr, scalar = nullptr;
  int tm = 0, tn = 0, kc = 0;   // tile, columns a k-step
  int acc_floats = 1;            // floats a partial entry takes: 2 for fp64
  bool swap = false;
  long long nk = 0;           // k-steps in D
  int slabs = 0;
};

template <int TM, int TN, bool kF64>
void pick(Plan& p) {
  p.vec = gram_cross_partial_kernel<TM, TN, true, kF64>;
  p.scalar = gram_cross_partial_kernel<TM, TN, false, kF64>;
  p.tm = TM;
  p.tn = TN;
  p.kc = Tile<TM, TN, kF64>::KC;
  p.acc_floats = sizeof(typename Tile<TM, TN, kF64>::Acc) / sizeof(float);
}

template <bool kF64>
Plan plan(int ca, int cb, long long D) {
  const int ta = tile_of(ca), tb = tile_of(cb);
  Plan p;
  p.swap = ta < tb;
  switch (std::max(ta, tb) * 100 + std::min(ta, tb)) {
#define B19_TILE(a, b)  \
  case a * 100 + b:     \
    pick<a, b, kF64>(p); \
    break;
    B19_TILE(1, 1) B19_TILE(2, 1) B19_TILE(2, 2) B19_TILE(3, 1) B19_TILE(3, 2)
    B19_TILE(3, 3) B19_TILE(4, 1) B19_TILE(4, 2) B19_TILE(4, 3) B19_TILE(4, 4)
    B19_TILE(16, 1) B19_TILE(16, 2) B19_TILE(16, 3) B19_TILE(16, 4) B19_TILE(16, 16)
    B19_TILE(64, 1) B19_TILE(64, 2) B19_TILE(64, 3) B19_TILE(64, 4) B19_TILE(64, 16)
    B19_TILE(64, 64)
#undef B19_TILE
    default:
      return p;
  }
  const long long na = p.swap ? cb : ca, nb = p.swap ? ca : cb;
  p.nk = (D + p.kc - 1) / p.kc;
  // one wave: as many CTAs as the card holds at once, at most 4 an SM
  int dev = 0, sms = 132, per_sm = kCtasPerSm;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.vec, kCThreads, 0);
  const long long wave = (long long)sms * std::max(1, std::min(per_sm, kCtasPerSm));
  const long long tiles = ((na + p.tm - 1) / p.tm) * ((nb + p.tn - 1) / p.tn);
  long long s = std::max(1LL, wave / tiles);
  s = std::min(s, std::max(1LL, p.nk / kMinSteps));
  s = std::max(s, (p.nk + kMaxSteps - 1) / kMaxSteps);
  s = std::min(s, std::max(1LL, kMaxWorkspace / ((long long)ca * cb * p.acc_floats)));
  p.slabs = (int)std::max(1LL, std::min(s, p.nk));
  return p;
}

// Floats of workspace cross_launch needs for (ca, cb, D); kF64 sums
// every tile in fp64 (B19 sums its 16 x 16 and 64 x 64 tiles in fp32).
template <bool kF64 = false>
inline long long cross_workspace_floats(int ca, int cb, long long D) {
  if (ca < 1 || cb < 1 || D < 1) return 0;
  const Plan p = plan<kF64>(ca, cb, D);
  return (long long)p.slabs * ca * cb * p.acc_floats;
}

// G (ca, cb) = Ra (ca, D) . Rb (cb, D)^T: the partial launch, then the
// fixed-order reduce; the workspace as cross_workspace_floats says.
template <bool kF64 = false>
inline int cross_launch(const void* Ra, const void* Rb, void* workspace, void* G, int ca,
                        int cb, long long D, cudaStream_t s) {
  if (ca < 1 || cb < 1 || D < 1 || (long long)ca * cb > 0x7fffffffLL ||
      (ca + 63) / 64 > 65535 || (cb + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan<kF64>(ca, cb, D);
  const float* A = static_cast<const float*>(p.swap ? Rb : Ra);
  const float* B = static_cast<const float*>(p.swap ? Ra : Rb);
  const int na = p.swap ? cb : ca, nb = p.swap ? ca : cb;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(Ra) |
                                  reinterpret_cast<uintptr_t>(Rb)) % 16 == 0;
  const dim3 grid(p.slabs, (nb + p.tn - 1) / p.tn, (na + p.tm - 1) / p.tm);
  (vec ? p.vec : p.scalar)<<<grid, kCThreads, 0, s>>>(A, B, workspace, na, nb, D, p.nk,
                                                      p.swap ? 1 : cb, p.swap ? cb : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = ca * cb;
  const dim3 rgrid((NN + 31) / 32);
  float* out = static_cast<float*>(G);
  if (p.acc_floats == 2)
    gram_cross_reduce_kernel<<<rgrid, kRWarps * 32, 0, s>>>(
        static_cast<const double*>(workspace), out, p.slabs, NN);
  else
    gram_cross_reduce_kernel<<<rgrid, kRWarps * 32, 0, s>>>(
        static_cast<const float*>(workspace), out, p.slabs, NN);
  return (int)cudaGetLastError();
}

}  // namespace cross
}  // namespace
