// The pair sums of the unstacked Grams on 3xTF32 wgmma, B1 (Eq. 6 Gram
// of (W - V_i) P_i, maecho_gram.cu) and B2 (of A_i UT_i,
// maecho_gram_left.cu), after their residual tiles are formed by
// maecho_splitk.cuh's share kernel, for Hopper (sm_90a).
//
// Up to 8 clients (kFusedClients), one pass a tile does the share edges'
// fix-up and the pair sums (gram_tile_pairs_kernel, 8 CTAs a tile, each
// thread's values of every client in registers), then
// gram_pairs_reduce_kernel sums each pair's partials: fp64 from the
// products on.  Above 8, splitk_fixup_kernel writes the residual stack R
// (N, out, in) and B19's fixed-order split-K contraction
// (maecho_cross.cuh: gram_cross_partial_kernel, then
// gram_cross_reduce_kernel) forms G = R R^T over the flat rows, summed in
// fp64.  Either way G is exactly symmetric and, with no atomics, bitwise
// reproducible on a card.

#pragma once

#include <type_traits>

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



// A Gram on a checked split: share(frag, R, slots) launches the caller's
// share kernel (frag = std::true_type: fragments of whole units for the
// fused pass; std::false_type: the fix-up into the residual stack R too),
// then the pairs as above.  The workspace as gram_workspace says.
template <class Share>
int gram_splitk_launch(const Split& s, Share share, void* workspace, void* G, int N,
                       int out_d, int in_d, cudaStream_t st) {
  const GramWorkspace w = gram_workspace(s, N, out_d, in_d);
  float* R = static_cast<float*>(workspace);
  float* slots = R + w.stack;
  float* pairs = slots + w.slots;
  if (N > kFusedClients) {
    const int err = share(std::false_type{}, R, slots);
    if (err != 0) return err;
    return cross::cross_launch<true>(R, R, pairs, G, N, N, (long long)out_d * in_d, st);
  }
  int err = share(std::true_type{}, R, slots);
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

}  // namespace tf32
}  // namespace
