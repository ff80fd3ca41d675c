// B14 — MA-Echo Eq. 7 global update of a scan-stacked leaf from left
// factors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:201
// (`maecho_update_left_stacked`, pl.pallas_call at :217):
//     W_l' = W_l + eta * ( -sum_i 2 alpha_li A_li UT_li )
// with W (L, out, in), A (N, L, out, k) the compressed residual,
// UT (N, L, k, in), alpha (L, N); fp32 in, fp32 accumulation (no TF32).
//
// Design.  B5's kernel (maecho_tile.cuh) on StackedLeftOp with the layer
// on blockIdx.z: one CTA per (layer, 32x32 output tile) loops over
// clients, the K-loop over the rank (masked); the layer's row of alpha
// is read from device memory (no host sync).
//
// Bound.  2*N*L*out*in*k flops (plus 2*N*L*out*in for the client sum)
// against 4*L*(2*out*in + N*out*k + N*k*in + N) bytes: at Qwen2-0.5B's
// w_gate (L=24, 4864x896, N=2, k=89) 37.9 GFLOP on 0.94 GB, bound by
// fp32 operations (67 TFLOP/s without tensor cores): 0.57 ms.

#include "maecho_tile.cuh"

extern "C" int maecho_update_left_stacked_launch(const void* W, const void* A,
                                                 const void* UT, const void* alpha,
                                                 void* out, int N, int L, int out_d,
                                                 int in_d, int rank, float eta,
                                                 void* stream) {
  return update_launch(stacked_left_op(A, UT, out_d, in_d, rank, L), W, alpha, out, N,
                       out_d, in_d, eta, stream, L);
}
