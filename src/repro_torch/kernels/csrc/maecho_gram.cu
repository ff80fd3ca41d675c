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
//   2. (maecho_gram_pairs.cuh, shared with B2.)  Up to 8 clients
//      (kFusedClients), one pass a tile does that fix-up
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

#include "maecho_gram_pairs.cuh"

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
  const float *Wf = static_cast<const float*>(W), *Vf = static_cast<const float*>(V),
              *Pf = static_cast<const float*>(P);
  return gram_splitk_launch(
      s,
      [&](auto frag, float* R, float* slots) {
        return splitk_launch<true, decltype(frag)::value>(s, Wf, Vf, Pf, nullptr, R, slots, N,
                                                          out_d, in_d, 1.f, st);
      },
      workspace, G, N, out_d, in_d, st);
}

}  // extern "C"
