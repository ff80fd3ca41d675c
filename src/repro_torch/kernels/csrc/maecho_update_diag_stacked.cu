// B15 — MA-Echo Eq. 7 global update of a scan-stacked leaf with diagonal
// projectors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:239
// (`maecho_update_diag_stacked`, pl.pallas_call at :252):
//     W_l' = W_l + eta * sum_i (-2 alpha_li) (W_l - V_il) * p_il[None, :]
// with W (L, out, in), V (N, L, out, in), p (N, L, in), alpha (L, N),
// fp32 in and fp32 accumulation, the client sum in client order.
//
// Design.  B6's kernel (maecho_diag.cuh): one thread per element of a
// layer's flat (out, in) leaf (grid-stride, at most 4096 CTAs), layer
// after layer, the client loop inside the thread; alpha is read from
// device memory.
//
// Bound.  4*L*(2*out*in + N*out*in + N*in + N) bytes against
// ~4*N*L*out*in flops: at Qwen2-0.5B's w_down (L=24, 896x4864, N=2)
// 1.67 GB, bound by bytes (3.35 TB/s): 0.50 ms.

#include "maecho_diag.cuh"

extern "C" int maecho_update_diag_stacked_launch(const void* W, const void* V,
                                                 const void* p, const void* alpha,
                                                 void* out, int N, int L,
                                                 int out_d, int in_d, float eta,
                                                 void* stream) {
  return update_diag_launch(W, V, p, alpha, out, N, L, out_d, in_d, eta, stream);
}
