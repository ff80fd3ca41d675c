// B11 — MA-Echo Eq. 6 Grams of a scan-stacked leaf from left factors, one
// launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:322
// (`maecho_gram_left_stacked`, pl.pallas_call at :337):
//     G[l, i, j] = <R_li, R_lj>,   R_li = A_li UT_li
// with A (N, L, out, k) the compressed residual ((W_l - V_il) U_il)
// diag(s_il) and UT (N, L, k, in) = U_il^T of factored projectors
// P_il = U_il diag(s_il) U_il^T; fp32 in, fp32 accumulation (no TF32)
// -> G (L, N, N).
//
// Design.  maecho_tile.cuh's SIMT Gram (gram_partial_kernel, the blocked
// launch past 54 clients) on StackedLeftOp, with the
// layer on blockIdx.z beside the client-block pair: each CTA parks the
// residual tiles of its (layer, 32x32 tile) in shared memory, the K-loop
// runs over the rank (masked, so k = 89 needs no padding), and the
// fixed-order reduce sums each layer's partials in tile order, so every
// layer's Gram (and the QP's alpha) is bitwise reproducible.  Any N
// (client blocks above 54), L * block pairs <= 65535.
//
// Bound.  The least work is the k x k cross-Gram identity
// <R_li, R_lj> = sum (A_li^T A_lj) . (UT_li UT_lj^T), which never forms R:
// 2*k^2*(out+in) flops a pair (i <= j) and layer, against
// 4*L*(N*out*k + N*k*in + N*N) bytes.  At Qwen2-0.5B's w_gate (L=24,
// 4864x896 in kernel layout, N=2, k=89) 6.57 GFLOP on 0.10 GB, bound by
// fp32 operations (67 TFLOP/s without tensor cores): 0.098 ms.  This
// kernel forms every residual tile instead (2*N*L*out*in*k = 37.9 GFLOP
// there): that recomputation is its main headroom.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_gram_left_stacked_workspace_floats(int N, int L, int out_d, int in_d) {
  return gram_workspace_floats(N, out_d, in_d, L);
}

int maecho_gram_left_stacked_launch(const void* A, const void* UT, void* workspace,
                                    void* G, int N, int L, int out_d, int in_d,
                                    int rank, void* stream) {
  return gram_launch(stacked_left_op(A, UT, out_d, in_d, rank, L), workspace, G, N,
                     out_d, in_d, stream, L);
}

}  // extern "C"
