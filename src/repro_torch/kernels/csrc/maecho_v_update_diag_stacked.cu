// B18 — MA-Echo Eq. 11 anchor update of a scan-stacked leaf with diagonal
// projectors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:256
// (`maecho_v_update_diag_stacked`, pl.pallas_call at :271):
//     V_il' = V_il + Norm((W_l' - V_il) * (1 - frac * p_il[None, :]))
// with W' (L, out, in), V (N, L, out, in), p (N, L, in),
// frac = mu/(1+mu); Norm divides each row (over in) by max(||row||, eps)
// when norm is on.  fp32 in, fp32 accumulation.
//
// Design.  B9's kernel (maecho_diag.cuh): one warp per (client, layer,
// row), eight rows per CTA; with norm a fixed-butterfly sum of squares,
// then a second pass over the row (which hits L1).
//
// Bound.  4*L*(out*in + 2*N*out*in + N*in) bytes against ~5*N*L*out*in
// flops (8 with norm): at Qwen2-0.5B's w_down (L=24, 896x4864, N=2)
// 2.09 GB, bound by bytes (3.35 TB/s): 0.62 ms.

#include "maecho_diag.cuh"

extern "C" int maecho_v_update_diag_stacked_launch(const void* W, const void* V,
                                                   const void* p, void* out, int N,
                                                   int L, int out_d, int in_d,
                                                   float frac, int norm, float eps,
                                                   void* stream) {
  return v_update_diag_launch(W, V, p, out, N, L, out_d, in_d, frac, norm, eps,
                              stream);
}
