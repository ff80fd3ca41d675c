// B12 — MA-Echo Eq. 6 Grams of a scan-stacked leaf with diagonal
// projectors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:357
// (`maecho_gram_diag_stacked`, pl.pallas_call at :368):
//     G[l, i, j] = sum_{o, c} R_li[o, c] R_lj[o, c],
//     R_li = (W_l - V_il) * p_il[None, :]
// with W (L, out, in), V (N, L, out, in), p (N, L, in), fp32 in and fp32
// accumulation -> G (L, N, N).  Scalar projectors (the bias rule on
// Qwen2's wo and w_down) reach it broadcast to diagonals.
//
// Design.  B3's kernel (maecho_diag.cuh) on a (chunk CTA, layer) grid:
// up to 264 CTAs per layer walk the layer's flat leaf in 128-element
// chunks, one warp per (i <= j) pair accumulating into a per-CTA (N, N);
// the fixed-order reduce sums each layer's partials in CTA order, so G
// is bitwise reproducible.  Any N (client blocks above 54).
//
// Bound.  4*L*(out*in*(N+1) + N*in) bytes against ~(N+1)*N*L*out*in
// flops: at Qwen2-0.5B's w_down (L=24, 896x4864 in kernel layout, N=2)
// 1.25 GB, bound by bytes (3.35 TB/s): 0.37 ms.

#include "maecho_diag.cuh"

extern "C" {

long long maecho_gram_diag_stacked_workspace_floats(int N, int L, int out_d,
                                                    int in_d) {
  return gram_diag_workspace_floats(N, out_d, in_d, L);
}

int maecho_gram_diag_stacked_launch(const void* W, const void* V, const void* p,
                                    void* workspace, void* G, int N, int L,
                                    int out_d, int in_d, void* stream) {
  return gram_diag_launch(W, V, p, workspace, G, N, L, out_d, in_d, stream);
}

}  // extern "C"
