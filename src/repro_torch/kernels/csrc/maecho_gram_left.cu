// B2 — MA-Echo Eq. 6 Gram from left factors, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:180
// (`maecho_gram_left`, pl.pallas_call at :194):
//     G[i, j] = <R_i, R_j>,   R_i = A_i UT_i
// with A (N, out, k) the compressed residual ((W - V_i) U_i) diag(s_i)
// and UT (N, k, in) = U_i^T of a factored projector
// P_i = U_i diag(s_i) U_i^T; fp32 in and out, held to the fp32
// tolerances.
//
// Design, any number of clients N (no client cap, so no blocked route):
// B1's route (maecho_gram.cu) on maecho_tf32.cuh's left form.
//   1. The residual tiles R_i = A_i UT_i: 3xTF32 on the tensor cores
//      (wgmma; a left raw stage is the 128 x 32 A_i tile and the 32 x 128
//      UT_i tile, 32 KiB; A split whole, UT transposed in the split; small
//      products first, a fresh accumulator a 32-deep stage added in
//      fp32), the (tile, client, depth step) stages run by
//      maecho_splitk.cuh's share kernel.  The depth is the rank k: 3
//      stages at k = 78, the last one 14 deep, masked on load.  A's rows
//      of k floats are not 16-byte aligned at k = 78 or 89, so A takes
//      4-byte copies unless k % 4 == 0; UT and the stores take 16 and 8
//      bytes when in % 4 == 0.  With units this short, a (tile, client)
//      unit has a CTA of its own when the units fit one wave (112 at the
//      paper MLP's W0 with N = 4: no unit split, no slot written); past
//      one wave the stages are cut into equal shares as B1's are.
//   2. The pair sums as B1's (maecho_gram_pairs.cuh): up to 8 clients one
//      pass a tile sums each pair in fp64 from the products on; above 8,
//      the residual stack R (N, out, in) and B19's fp64 contraction
//      (maecho_cross.cuh).  G is exactly symmetric.
// No atomics: G is bitwise reproducible on a card.  The SIMT body this
// replaces (maecho_tile.cuh's gram_partial_kernel on LeftOp, one CTA a 32
// x 32 tile with every client parked, the client-blocked launch past 54
// clients) took 0.0433 ms at W0 (N = 4, k = 78) on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md §6).
//
// Bound.  The least work is the cheaper of forming R (2*N*out*in*k flops
// plus N*(N+1)*out*in for the pairs) and the k x k cross-Gram identity
// <R_i, R_j> = sum (A_i^T A_j) . (UT_i UT_j^T), 2*k^2*(out+in) flops a pair
// (i <= j), against 4*(N*out*k + N*k*in) bytes: at W0 (400x784, N=4,
// k=78) the identity's 0.144 GFLOP on ~1.5 MB, 0.0009 ms at the 3xTF32
// rate (495/3 TFLOP/s).  This kernel forms R (2*N*out*in*k = 0.20 GFLOP
// at W0, 0.0012 ms at that rate, on 128 x 128 tiles of which 68 % lie in
// the leaf): what it pays for is the latency of three short stages a unit
// and two more launches.

#include "maecho_gram_pairs.cuh"

extern "C" {

// Floats of workspace a launch needs (the residual fragments or stack,
// two partial tiles a CTA, the pair partials); -1 when the device cannot
// be queried.
long long maecho_gram_left_workspace_floats(int N, int out_d, int in_d, int rank) {
  const tf32::Split s = tf32::splitk_plan(N, out_d, in_d, true, rank, true);
  if (s.C < 1) return -1;
  const tf32::GramWorkspace w = tf32::gram_workspace(s, N, out_d, in_d);
  return w.stack + w.slots + w.pairs;
}

int maecho_gram_left_launch(const void* A, const void* UT, void* workspace, void* G, int N,
                            int out_d, int in_d, int rank, void* stream) {
  using namespace tf32;
  const Split s = splitk_plan(N, out_d, in_d, true, rank, true);
  if (s.C < 0 || N > 46340) return (int)cudaErrorInvalidValue;
  if (s.C == 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *Af = static_cast<const float*>(A), *UTf = static_cast<const float*>(UT);
  return gram_splitk_launch(
      s,
      [&](auto frag, float* R, float* slots) {
        return splitk_left_launch<decltype(frag)::value>(s, Af, UTf, R, slots, N, out_d, in_d,
                                                         rank, st);
      },
      workspace, G, N, out_d, in_d, st);
}

}  // extern "C"
