// B17 — MA-Echo Eq. 11 anchor update of a scan-stacked leaf with
// factored projectors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:212
// (`maecho_v_update_factored_stacked`, pl.pallas_call at :233):
//     V_il' = V_il + Norm((W_l' - V_il) - frac * B_li UT_li)
// with B (N, L, out, k) the compressed residual of W' (so B_li UT_li =
// (W_l' - V_il) P_il for P_il = U_il diag(s_il) U_il^T), UT (N, L, k, in),
// W' (L, out, in), V (N, L, out, in), frac = mu/(1+mu); Norm divides each
// row (over in) by max(||row||, eps) when norm is on.  fp32 in, fp32
// accumulation (no TF32).  B is formed before the launch, as the
// reference does outside its pallas_call.
//
// Design.  B8's kernel (maecho_tile.cuh) on StackedLeftOp: one CTA per
// (layer, client, 32x32 tile), blockIdx.z = l*N + i (N*L <= 65535), the
// K-loop over the rank.  The row norm keeps B8's two passes: per-tile
// row sums of squares, then one CTA per (client, layer, row) sums them
// in tile order and rescales.
//
// Bound.  2*N*L*out*in*k flops (plus 4*N*L*out*in elementwise) against
// 4*L*(N*out*k + N*k*in + out*in + 2*N*out*in) bytes: at Qwen2-0.5B's
// w_gate (L=24, 4864x896, N=2, k=89) 38.1 GFLOP on 2.19 GB, bound by
// bytes (3.35 TB/s): 0.65 ms, just above its 0.57 ms of fp32 operations.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_v_update_factored_stacked_workspace_floats(int N, int L, int out_d,
                                                            int in_d, int norm) {
  return v_update_workspace_floats(N, out_d, in_d, norm, L);
}

int maecho_v_update_factored_stacked_launch(const void* B, const void* UT,
                                            const void* W, const void* V, void* out,
                                            void* workspace, int N, int L, int out_d,
                                            int in_d, int rank, float frac, int norm,
                                            float eps, void* stream) {
  return v_update_launch(stacked_left_op(B, UT, out_d, in_d, rank, L), W, V, out,
                         workspace, N, out_d, in_d, frac, norm, eps, stream, L);
}

}  // extern "C"
