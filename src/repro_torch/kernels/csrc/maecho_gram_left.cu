// B2 — MA-Echo Eq. 6 Gram from left factors, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:180
// (`maecho_gram_left`, pl.pallas_call at :194):
//     G[i, j] = <R_i, R_j>,   R_i = A_i UT_i
// with A (N, out, k) the compressed residual ((W - V_i) U_i) diag(s_i)
// and UT (N, k, in) = U_i^T of a factored projector
// P_i = U_i diag(s_i) U_i^T; fp32 in, fp32 accumulation (no TF32).
// B1's design (maecho_tile.cuh) with the K-loop over the rank k: each
// CTA owns one 32x32 (out, in) tile, parks all N residual tiles in
// shared memory (above 54 clients: one pair of client blocks per CTA),
// writes a partial (N, N); a second launch sums the partials in tile
// order.  The rank is masked like out and in, so a rank of 78 or 196
// needs no padding.
//
// Bound.  The least work is the cheaper of forming R (2*N*out*in*k flops
// plus N*(N+1)*out*in for the pairs) and the k x k cross-Gram identity
// <R_i, R_j> = sum (A_i^T A_j) . (UT_i UT_j^T), 2*k^2*(out+in) flops a pair
// (i <= j), against 4*(N*out*k + N*k*in) bytes: at W0 (400x784, N=4,
// k=78) the identity's 0.144 GFLOP on ~1.5 MB, bound by fp32 operations.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_gram_left_workspace_floats(int N, int out_d, int in_d) {
  return gram_workspace_floats(N, out_d, in_d);
}

int maecho_gram_left_launch(const void* A, const void* UT, void* workspace,
                            void* G, int N, int out_d, int in_d, int rank,
                            void* stream) {
  return gram_launch(left_op(A, UT, out_d, in_d, rank), workspace, G, N,
                     out_d, in_d, stream);
}

}  // extern "C"
