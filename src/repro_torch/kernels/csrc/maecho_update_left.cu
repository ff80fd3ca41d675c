// B5 — MA-Echo Eq. 7 global update from left factors, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:128
// (`maecho_update_left`, pl.pallas_call at :141):
//     W' = W + eta * ( -sum_i 2 alpha_i A_i UT_i )
// with W (out, in), A (N, out, k) the compressed residual, UT (N, k, in),
// alpha (N,); fp32 in, fp32 accumulation (no TF32).  B4's design
// (maecho_tile.cuh) with the K-loop over the rank: one CTA per 32x32
// output tile loops over clients, alpha is read from device memory, and
// out, in and the rank are masked, so nothing is padded.
//
// Bound.  2*N*out*in*k flops against 4*(2*out*in + N*out*k + N*k*in)
// bytes: at W0 (400x784, N=4, k=78) ~0.20 GFLOP on ~4 MB, bound by fp32
// operations.

#include "maecho_tile.cuh"

extern "C" int maecho_update_left_launch(const void* W, const void* A,
                                         const void* UT, const void* alpha,
                                         void* out, int N, int out_d, int in_d,
                                         int rank, float eta, void* stream) {
  return update_launch(left_op(A, UT, out_d, in_d, rank), W, alpha, out, N,
                       out_d, in_d, eta, stream);
}
