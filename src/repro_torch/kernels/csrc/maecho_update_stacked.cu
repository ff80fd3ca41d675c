// B13 — MA-Echo Eq. 7 global update of a scan-stacked leaf, one launch
// for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:163
// (`maecho_update_stacked`, pl.pallas_call at :177):
//     W_l' = W_l + eta * ( -sum_i 2 alpha_li (W_l - V_il) P_il )
// with W (L, out, in), V (N, L, out, in), P (N, L, in, in), alpha (L, N),
// fp32 in and fp32 accumulation (no TF32).
//
// Design.  B4's kernel (maecho_tile.cuh) with the layer on blockIdx.z:
// one CTA per (layer, 32x32 output tile) loops over clients; the
// layer's row of alpha is read from device memory (no host sync).
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(N+2) + N*in^2 + N)
// bytes: at Qwen2-0.5B's wq (L=24, 896x896, N=2) 69.1 GFLOP, bound by
// fp32 operations (67 TFLOP/s without tensor cores): 1.03 ms.

#include "maecho_tile.cuh"

extern "C" int maecho_update_stacked_launch(const void* W, const void* V,
                                            const void* P, const void* alpha,
                                            void* out, int N, int L, int out_d,
                                            int in_d, float eta, void* stream) {
  return update_launch(stacked_dense_op(W, V, P, out_d, in_d, L), W, alpha, out, N, out_d,
                       in_d, eta, stream, L);
}
