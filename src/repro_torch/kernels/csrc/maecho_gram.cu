// B1 — MA-Echo Eq. 6 Gram of projected residuals, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:118
// (`maecho_gram`, pl.pallas_call at :131):
//     G[i, j] = <R_i, R_j>,   R_i = (W - V_i) P_i
// with W (out, in), V (N, out, in), P (N, in, in), all fp32, held to the
// fp32 tolerances.
//
// Design, any number of clients N (no client cap, so no blocked route):
//   1. The residual tiles R_i = (W - V_i) P_i: 3xTF32 on the tensor cores
//      (wgmma, maecho_tf32.cuh's staging, small products first, a fresh
//      accumulator a 32-deep stage added in fp32, as B10), the (tile,
//      client, depth step) stages split across the card in equal shares,
//      one CTA a share (maecho_splitk.cuh: splitk_tf32_kernel).  A Gram is
//      quadratic in R_i, so each (tile, client) unit is whole, its share
//      edges' partials summed in depth order, before any pair is formed.
//   2. Up to 8 clients (kFusedClients), one pass a tile does that fix-up
//      and the pair sums (gram_tile_pairs_kernel, 8 CTAs a tile, each
//      thread's values of every client in registers), then
//      gram_pairs_reduce_kernel sums each pair's partials: fp64 from the
//      products on.  Above 8, splitk_fixup_kernel writes the residual stack
//      R (N, out, in) and B19's fixed-order split-K contraction
//      (maecho_cross.cuh: gram_cross_partial_kernel, then
//      gram_cross_reduce_kernel) forms G = R R^T over the flat rows,
//      summed in fp64 (B10's lesson: a sum over many partials in fp32
//      misses the tolerance).  Either way G is exactly symmetric.  At W0
//      with N = 4 the fix-up and B19's contraction had taken 5.4 + 5.4 +
//      1.9 us of 60.6 (an NVIDIA H100 80GB HBM3, PERF.md §6).
// No atomics: G is bitwise reproducible on a card.  The SIMT bodies this
// replaces (maecho_tile.cuh's gram_partial_kernel up to 54 clients, its
// gram_blocked_partial_kernel above) took 0.3099 ms at W0 and 0.233 s for
// the 10 launches of a 64-client aggregate on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md §5, §6).
//
// Bound.  2*N*out*in^2 flops for the residual products against
// ~4*(N*in^2 + N*out*in) bytes read: at the paper MLP's W0 (400x784, N=4)
// 1.97 GFLOP on ~15 MB, at the 3xTF32 rate (495/3 TFLOP/s) 0.0120 ms,
// bound by operations.

#include "maecho_cross.cuh"
#include "maecho_splitk.cuh"

namespace {
namespace tf32 {

constexpr int kFusedClients = 8;   // clients whose values a thread holds at once

// B1 up to kFusedClients clients: the fix-up and the pair contraction of
// one tile in one pass.  CTA (tile, q) takes accumulator registers 8 q ..
// 8 q + 7 of every thread of the tile, for every client: a (tile,
// client) unit that one share held whole from its fragment, a split one
// summed from its shares' slots in CTA order (as splitk_fixup_kernel).
// Positions outside the leaf hold exact zeros.  Then each thread's fp64
// dot of every pair i <= j over its 8 values, a fixed xor butterfly over
// the lanes and the warps in index order: the (tile, q) partial of each
// pair, pairs numbered row by row.
template <int N>
__global__ void __launch_bounds__(kThreads)
gram_tile_pairs_kernel(const float* __restrict__ frag, const float* __restrict__ slots,
                       double* __restrict__ partial, long long T, int C, int K) {
  constexpr int kE = 64 / kFixParts, NP = N * (N + 1) / 2;
  __shared__ double red[kThreads / 32][NP];
  __shared__ int lo_of[N], hi_of[N], slot_of[N];   // shares crossing each client's unit
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t off = (size_t)blockIdx.y * kE * kThreads + tid;
  if (tid < N) {                   // the 64-bit divisions once a client, not once a thread
    const long long x0 = ((long long)blockIdx.x * N + tid) * K;
    lo_of[tid] = cta_of(x0, T, C);
    hi_of[tid] = cta_of(x0 + K - 1, T, C);
    slot_of[tid] = share_begin(lo_of[tid], T, C) == x0 ? 0 : 1;
  }
  __syncthreads();
  float v[N][kE];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int lo = lo_of[i], hi = hi_of[i];
    const float* s = lo == hi ? frag + ((size_t)blockIdx.x * N + i) * kSlot + off
                              : slots + ((size_t)lo * 2 + slot_of[i]) * kSlot + off;
#pragma unroll
    for (int e = 0; e < kE; ++e) v[i][e] = s[e * kThreads];
    for (int c = lo + 1; c <= hi; ++c) {
      s = slots + (size_t)c * 2 * kSlot + off;
#pragma unroll
      for (int e = 0; e < kE; ++e) v[i][e] += s[e * kThreads];
    }
  }
  double d[NP];
#pragma unroll
  for (int i = 0, p = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j, ++p) {
      double a = 0.0;
#pragma unroll
      for (int e = 0; e < kE; ++e) a = fma((double)v[i][e], (double)v[j][e], a);
      d[p] = a;
    }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d[p] += __shfl_xor_sync(0xffffffffu, d[p], o);
    if (lane == 0) red[warp][p] = d[p];
  }
  __syncthreads();
  if (tid < NP) {
    double a = red[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) a += red[w][tid];
    partial[((size_t)blockIdx.x * kFixParts + blockIdx.y) * NP + tid] = a;
  }
}

// G[i, j] = G[j, i] = pair p's partials summed in a fixed order in fp64
// (lane l of warp p takes partials l, l + 32, ..., then a fixed
// butterfly), rounded once.
__global__ void __launch_bounds__(32)
gram_pairs_reduce_kernel(const double* __restrict__ partial, float* __restrict__ G, int N,
                         int parts) {
  const int p = blockIdx.x, NP = N * (N + 1) / 2, lane = threadIdx.x;
  double a = 0.0;
  for (int t = lane; t < parts; t += 32) a += partial[(size_t)t * NP + p];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane != 0) return;
  int i = 0, r = p;
  while (r >= N - i) {
    r -= N - i;
    ++i;
  }
  G[i * N + i + r] = G[(i + r) * N + i] = (float)a;
}

template <int N>
int launch_tile_pairs(const Split& s, int tiles, const float* frag, const float* slots,
                      double* partial, cudaStream_t st) {
  gram_tile_pairs_kernel<N><<<dim3(tiles, kFixParts), kThreads, 0, st>>>(frag, slots, partial,
                                                                          s.T, s.C, s.K);
  return (int)cudaGetLastError();
}

// Floats of each part of the workspace: the residual stack (fragments
// of every unit up to kFusedClients clients, else R (N, out, in)
// row-major), the slots, then the pair partials (fp64), each rounded up
// to 256 bytes.
struct GramWorkspace {
  long long stack, slots, pairs;
};

inline long long round64(long long f) { return (f + 63) / 64 * 64; }

inline GramWorkspace gram_workspace(const Split& s, int N, int out_d, int in_d) {
  const long long tiles = (long long)tiles128(out_d) * tiles128(in_d);
  if (N <= kFusedClients)
    return {round64(tiles * N * kSlot), splitk_slot_floats(s),
            round64(2 * tiles * kFixParts * N * (N + 1) / 2)};
  return {round64((long long)N * out_d * in_d), splitk_slot_floats(s),
          cross::cross_workspace_floats<true>(N, N, (long long)out_d * in_d)};
}

}  // namespace tf32
}  // namespace

extern "C" {

// Floats of workspace a launch needs; -1 when the device cannot be
// queried.
long long maecho_gram_workspace_floats(int N, int out_d, int in_d) {
  const tf32::Split s = tf32::splitk_plan(N, out_d, in_d, true);
  if (s.C < 1) return -1;
  const tf32::GramWorkspace w = tf32::gram_workspace(s, N, out_d, in_d);
  return w.stack + w.slots + w.pairs;
}

int maecho_gram_launch(const void* W, const void* V, const void* P, void* workspace,
                       void* G, int N, int out_d, int in_d, void* stream) {
  using namespace tf32;
  const Split s = splitk_plan(N, out_d, in_d, true);
  if (s.C < 0 || N > 46340) return (int)cudaErrorInvalidValue;
  if (s.C == 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GramWorkspace w = gram_workspace(s, N, out_d, in_d);
  float* R = static_cast<float*>(workspace);
  float* slots = R + w.stack;
  float* pairs = slots + w.slots;
  const float *Wf = static_cast<const float*>(W), *Vf = static_cast<const float*>(V),
              *Pf = static_cast<const float*>(P);
  if (N > kFusedClients) {
    const int err = splitk_launch<true>(s, Wf, Vf, Pf, nullptr, R, slots, N, out_d, in_d, 1.f,
                                        st);
    if (err != 0) return err;
    return cross::cross_launch<true>(R, R, pairs, G, N, N, (long long)out_d * in_d, st);
  }
  int err = splitk_launch<true, true>(s, Wf, Vf, Pf, nullptr, R, slots, N, out_d, in_d, 1.f,
                                      st);
  if (err != 0) return err;
  const int tiles = s.units / N;
  double* partial = reinterpret_cast<double*>(pairs);
  switch (N) {
    case 1: err = launch_tile_pairs<1>(s, tiles, R, slots, partial, st); break;
    case 2: err = launch_tile_pairs<2>(s, tiles, R, slots, partial, st); break;
    case 3: err = launch_tile_pairs<3>(s, tiles, R, slots, partial, st); break;
    case 4: err = launch_tile_pairs<4>(s, tiles, R, slots, partial, st); break;
    case 5: err = launch_tile_pairs<5>(s, tiles, R, slots, partial, st); break;
    case 6: err = launch_tile_pairs<6>(s, tiles, R, slots, partial, st); break;
    case 7: err = launch_tile_pairs<7>(s, tiles, R, slots, partial, st); break;
    default: err = launch_tile_pairs<8>(s, tiles, R, slots, partial, st); break;
  }
  if (err != 0) return err;
  gram_pairs_reduce_kernel<<<N * (N + 1) / 2, 32, 0, st>>>(partial, static_cast<float*>(G), N,
                                                            tiles * kFixParts);
  return (int)cudaGetLastError();
}

}  // extern "C"
