// The residual products of the unstacked dense MA-Echo kernels B1 (Eq. 6
// Gram, maecho_gram.cu) and B4 (Eq. 7, maecho_update.cu) and of the
// factored Gram B2 (maecho_gram_left.cu, on maecho_tf32.cuh's left form:
// A_i UT_i, depth k) on 3xTF32 wgmma, with the depth split across the
// card, for Hopper (sm_90a).
//
// Why split.  B10 and B13, their stacked twins, take one 128 x 128 output
// tile a CTA (maecho_tf32.cuh's staging, two consumer warpgroups).  An
// unstacked leaf has few such tiles: 28 at the paper MLP's W0 (400 x 784),
// 8 at W1 (200 x 400), 16 at the CNN's fc0 (256 x 1024), 2 at fc1, on a
// card of 132 SMs.  So the whole (tile, client, depth step) stage sequence
// of the leaf, T = tiles * N * nk stages of 32, is cut into C equal shares
// (stream-K, maecho_tf32.cuh's share_begin / cta_of): one CTA a share, C
// = min(SMs, T / kMinShare), one wave.  At W0 with N = 4, 2800 stages
// over 132 CTAs: 21 or 22 stages a CTA instead of 100 a tile.
//
// A unit is what one output needs whole: a tile (B4: Eq. 7 sums every
// client's product into one tile) or a (tile, client) pair (B1: the Gram
// needs each residual tile R_i whole before any pair is formed).  A share
// runs its stages as one run_stages pipeline, products small first, each
// stage's fresh accumulator added to a running sum: in fp32 (B1, as B10)
// or by an fp32 FMA times m_i = -2 alpha_i (B4, as B13; alpha read from
// device memory).  A running sum ends with its unit or its share (a
// segment).  A segment that is a whole unit goes straight out: B4 writes
// fmaf(eta, acc, W); B1 writes R_i's tile into its workspace (row-major
// into the residual stack R (N, out, in), masked to the leaf, or, up to 8
// clients, as its fragment for maecho_gram.cu's fused pass).  Any other
// segment is a share's first or last (a unit crossed by a share edge),
// and goes to the CTA's slot 0 (its first segment) or 1 (its last), 64
// floats a thread, thread-major.  Then splitk_fixup_kernel, eight CTAs a
// unit, sums a split unit's slots in CTA order, i.e. in depth order, in
// fp32, and writes it as the CTA would have (B1 up to 8 clients: the
// fused pass does).  No atomics, and the shares depend on (T, C) alone:
// the output is bitwise reproducible on a card.
//
// B2's units are short (3 stages at k = 78), so its plan may give each
// (tile, client) unit a CTA of its own when the units fit one wave
// (splitk_plan's whole_units): no unit is split, no slot is written.
//
// Bound.  The products, 2*N*out*in^2 flops, at the 3xTF32 rate (495/3
// TFLOP/s) against ~4*(N*in^2 + N*out*in) bytes: at W0 (N = 4) 1.97
// GFLOP, 0.0120 ms, bound by operations.  The 128 x 128 tiles compute
// 512 x 896 at W0, 68 % of it useful.

#pragma once

#include "maecho_tf32.cuh"

namespace {
namespace tf32 {

constexpr int kMinShare = 4;             // stages a share, at least
constexpr int kSlot = 64 * kThreads;     // floats of one partial tile

// Columns 8 n0 .. 8 (n0 + kN) - 1 of one unit's tile from this thread's
// accumulator registers 4 n0 .. 4 (n0 + kN) - 1 (all 64 for kN = 16): B1
// stores R_client (out, in) of the stack at out; B4 stores
// fmaf(eta, acc, W).  Masked to the leaf; kVec (in % 4 == 0, aligned
// bases) stores pairs.
template <bool kVec, bool kGram, int kN>
__device__ __forceinline__ void store_unit(const float (&acc)[4 * kN], const float* __restrict__ W,
                                           float* __restrict__ out, int client, int o0,
                                           int c0, int n0, int out_d, int in_d, float eta) {
  const int tid = threadIdx.x, t = tid % 4, ra = acc_row(tid);
  float* dst = kGram ? out + (size_t)client * out_d * in_d : out;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int c = c0 + 8 * (n0 + n) + 2 * t;
      if (o >= out_d || c >= in_d) continue;
      const size_t idx = (size_t)o * in_d + c;
      const float a0 = acc[4 * n + 2 * ii], a1 = acc[4 * n + 2 * ii + 1];
      if constexpr (kVec) {      // c even and in % 4 == 0: both columns in, 8-byte aligned
        if constexpr (kGram) {
          *reinterpret_cast<float2*>(dst + idx) = make_float2(a0, a1);
        } else {
          const float2 w = *reinterpret_cast<const float2*>(W + idx);
          *reinterpret_cast<float2*>(dst + idx) = make_float2(fmaf(eta, a0, w.x),
                                                              fmaf(eta, a1, w.y));
        }
      } else {
        dst[idx] = kGram ? a0 : fmaf(eta, a0, W[idx]);
        if (c + 1 < in_d) dst[idx + 1] = kGram ? a1 : fmaf(eta, a1, W[idx + 1]);
      }
    }
  }
}

// One share of the stage sequence (CTA blockIdx.x of C), stages of form F
// (W, V, P the dense form's operands; the left form's A, unused, UT).
// slots holds two partial tiles a CTA.  alpha is read by B4 only.  kVec:
// out (and B4's W) take paired stores.  kFrag (B1 and B2 up to
// kFusedClients clients): a whole unit u goes to out + u kSlot as the
// slots do, thread-major, for gram_tile_pairs_kernel
// (maecho_gram_pairs.cuh).
template <class F, bool kVec, bool kGram, bool kFrag>
__global__ void __launch_bounds__(kThreads, 1)
splitk_tf32_kernel(F form, const float* __restrict__ W, const float* __restrict__ V,
                   const float* __restrict__ P, const float* __restrict__ alpha,
                   float* __restrict__ out, float* __restrict__ slots, int N, int out_d,
                   int in_d, float eta, long long T, int C) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int ct = tiles128(in_d), nk = (form.depth(in_d) + kBK - 1) / kBK;
  const long long b0 = share_begin(blockIdx.x, T, C);
  const int G = (int)(share_begin(blockIdx.x + 1, T, C) - b0);

  StageCursor ld, fin;           // next stage to load; stage being finished
  ld.set(b0, N, nk, ct);
  fin = ld;
  bool from_start = fin.step == 0 && (kGram || fin.client == 0);   // segment starts its unit
  int seg = 0;
  float m = kGram ? 1.f : -2.0f * alpha[fin.client];
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  run_stages(
      form, smem, G, out_d, in_d,
      [&](int) {
        const StageRef r = form.ref(W, V, P, ld.client, ld.o0, ld.c0, ld.step * kBK, out_d,
                                    in_d);
        ld.next(N, nk, ct);
        return r;
      },
      [&](int, float(&part)[64]) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = kGram ? acc[e] + part[e] : fmaf(m, part[e], acc[e]);
      },
      [&](int g) {
        const bool unit_end = fin.step == nk - 1 && (kGram || fin.client == N - 1);
        if (unit_end || g == G - 1) {
          if (from_start && unit_end && kFrag) {
            float* d = out + ((size_t)fin.tile * N + fin.client) * kSlot + tid;
#pragma unroll
            for (int e = 0; e < 64; ++e) d[e * kThreads] = acc[e];
          } else if (from_start && unit_end) {
            store_unit<kVec, kGram, 16>(acc, W, out, fin.client, fin.o0, fin.c0, 0, out_d,
                                        in_d, eta);
          } else {
            float* s = slots + ((size_t)blockIdx.x * 2 + (seg > 0)) * kSlot + tid;
#pragma unroll
            for (int e = 0; e < 64; ++e) s[e * kThreads] = acc[e];
          }
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] = 0.f;
          ++seg;
          from_start = true;
        }
        fin.next(N, nk, ct);
        if (!kGram && fin.step == 0 && g + 1 < G) m = -2.0f * alpha[fin.client];
      });
}

// The fix-up of unit blockIdx.x (B4: tile u; B1: tile u / N, client
// u % N) of K stages, columns 16 q .. 16 q + 15 of its tile (q =
// blockIdx.y, accumulator registers 8 q .. 8 q + 7 of every thread): a
// unit that one share holds was stored whole; a split one is the sum, in
// CTA order, of the slot of each share that crosses it (slot 1 of the
// first share unless that share starts at the unit, slot 0 of the rest).
// Eight CTAs a unit keep more loads in flight than one (B4 at W1 sums 13
// slots a tile).
constexpr int kFixParts = 8;
template <bool kVec, bool kGram>
__global__ void __launch_bounds__(kThreads)
splitk_fixup_kernel(const float* __restrict__ slots, const float* __restrict__ W,
                    float* __restrict__ out, int N, int out_d, int in_d, float eta,
                    long long T, int C, int K) {
  __shared__ int cut[3];           // lo, hi, lo's slot: 64-bit divisions once a CTA
  if (threadIdx.x == 0) {
    const long long x0 = (long long)blockIdx.x * K;
    cut[0] = cta_of(x0, T, C);
    cut[1] = cta_of(x0 + K - 1, T, C);
    cut[2] = share_begin(cut[0], T, C) == x0 ? 0 : 1;
  }
  __syncthreads();
  const int lo = cut[0], hi = cut[1];
  if (lo == hi) return;
  constexpr int kE = 64 / kFixParts;
  const int q = blockIdx.y;
  const float* base = slots + (size_t)q * kE * kThreads + threadIdx.x;
  const float* s = base + ((size_t)lo * 2 + cut[2]) * kSlot;
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = s[e * kThreads];
#pragma unroll 4
  for (int c = lo + 1; c <= hi; ++c) {
    s = base + (size_t)c * 2 * kSlot;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] += s[e * kThreads];
  }
  const int ct = tiles128(in_d);
  const int tile = kGram ? blockIdx.x / N : blockIdx.x, client = kGram ? blockIdx.x % N : 0;
  const int by = tile / ct;
  store_unit<kVec, kGram, kE / 4>(acc, W, out, client, by * 128, (tile - by * ct) * 128,
                                  q * kE / 4, out_d, in_d, eta);
}

// The split of an (N, out, in) leaf of the given depth (in for the dense
// form, the rank for the left one): stages T, CTAs C (one an SM at most,
// kMinShare stages a share at least; with whole_units, one a unit when the
// units fit one wave), units and their stages K.  C is 0 when the device
// cannot be queried, -1 when the leaf is out of range.
struct Split {
  long long T;
  int C, units, K;
};

inline Split splitk_plan(int N, int out_d, int in_d, bool gram, int depth = -1,
                         bool whole_units = false) {
  if (depth < 0) depth = in_d;
  const int nk = (depth + kBK - 1) / kBK;
  const long long tiles = (long long)tiles128(out_d) * tiles128(in_d);
  Split s{tiles * N * nk, -1, 0, 0};
  if (N < 1 || out_d < 1 || in_d < 1 || depth < 1 || s.T > 0x7fffffffLL ||
      (gram ? tiles * N : tiles) > 0x7fffffffLL)
    return s;
  s.units = (int)(gram ? tiles * N : tiles);
  s.K = gram ? nk : N * nk;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1) {
    s.C = 0;
    return s;
  }
  const long long by_share = s.T / kMinShare > 1 ? s.T / kMinShare : 1;
  s.C = (int)(by_share < sms ? by_share : sms);
  if (whole_units && s.units <= sms) s.C = s.units;
  return s;
}

// Floats of the two slots of every CTA; none when every share is one
// whole unit (C == units: share c is unit c), as whole_units plans are.
inline long long splitk_slot_floats(const Split& s) {
  return s.C == s.units ? 0 : 2LL * s.C * kSlot;
}

// Launch the share kernel on stages of form F and, unless kFrag (whose
// fix-up is the caller's), the fix-up on a checked leaf; slots as
// splitk_slot_floats says.
template <class F, bool kVec, bool kGram, bool kFrag>
int splitk_run(const F& form, const Split& s, const float* W, const float* V, const float* P,
               const float* alpha, float* out, float* slots, int N, int out_d, int in_d,
               float eta, cudaStream_t stream) {
  auto kernel = splitk_tf32_kernel<F, kVec, kGram, kFrag>;
  constexpr int smem = smem_of<F>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<s.C, kThreads, smem, stream>>>(form, W, V, P, alpha, out, slots, N, out_d, in_d,
                                          eta, s.T, s.C);
  err = cudaGetLastError();
  if (err != cudaSuccess || kFrag) return (int)err;
  splitk_fixup_kernel<kVec, kGram><<<dim3(s.units, kFixParts), kThreads, 0, stream>>>(
      slots, W, out, N, out_d, in_d, eta, s.T, s.C, s.K);
  return (int)cudaGetLastError();
}

// The dense form (B1, B4): 16-byte copies and paired stores together.
template <bool kGram, bool kFrag = false>
int splitk_launch(const Split& s, const float* W, const float* V, const float* P,
                  const float* alpha, float* out, float* slots, int N, int out_d, int in_d,
                  float eta, cudaStream_t stream) {
  const bool vec = vec_ok(in_d, W, V, P) && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? splitk_run<DenseStage<true>, true, kGram, kFrag>(
                   DenseStage<true>{}, s, W, V, P, alpha, out, slots, N, out_d, in_d, eta,
                   stream)
             : splitk_run<DenseStage<false>, false, kGram, kFrag>(
                   DenseStage<false>{}, s, W, V, P, alpha, out, slots, N, out_d, in_d, eta,
                   stream);
}

// The left form's Gram stages (B2): A (N, out, rank), UT (N, rank, in);
// A's copy width by the rank, UT's and the paired stores by in.
template <bool kFrag>
int splitk_left_launch(const Split& s, const float* A, const float* UT, float* out,
                       float* slots, int N, int out_d, int in_d, int rank,
                       cudaStream_t stream) {
  const bool va = rows_vec_ok(rank, A);
  const bool vb = rows_vec_ok(in_d, UT) && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (va && vb)
    return splitk_run<LeftStage<true, true>, true, true, kFrag>(
        {rank}, s, A, nullptr, UT, nullptr, out, slots, N, out_d, in_d, 1.f, stream);
  if (va)
    return splitk_run<LeftStage<true, false>, false, true, kFrag>(
        {rank}, s, A, nullptr, UT, nullptr, out, slots, N, out_d, in_d, 1.f, stream);
  if (vb)
    return splitk_run<LeftStage<false, true>, true, true, kFrag>(
        {rank}, s, A, nullptr, UT, nullptr, out, slots, N, out_d, in_d, 1.f, stream);
  return splitk_run<LeftStage<false, false>, false, true, kFrag>(
      {rank}, s, A, nullptr, UT, nullptr, out, slots, N, out_d, in_d, 1.f, stream);
}

}  // namespace tf32
}  // namespace
