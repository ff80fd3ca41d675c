// B16 — MA-Echo Eq. 11 anchor update of a scan-stacked leaf, one launch
// for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:169
// (`maecho_v_update_stacked`, pl.pallas_call at :186):
//     V_il' = V_il + Norm(D_il - frac * D_il P_il),   D_il = W_l' - V_il
// with W' (L, out, in), V (N, L, out, in), P (N, L, in, in),
// frac = mu/(1+mu); Norm divides each row (over in) by max(||row||, eps)
// when norm is on.  fp32 in, fp32 accumulation (no TF32).
//
// Design.  B7's kernel (maecho_tile.cuh): one CTA per (layer, client,
// 32x32 tile), blockIdx.z = l*N + i (N*L <= 65535).  The row norm keeps
// B7's two passes: per-tile row sums of squares, then one CTA per
// (client, layer, row) sums them in tile order and rescales.
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(2N+1) + N*in^2)
// bytes: at Qwen2-0.5B's wq (L=24, 896x896, N=2) 69.1 GFLOP, bound by
// fp32 operations (67 TFLOP/s without tensor cores): 1.03 ms.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_v_update_stacked_workspace_floats(int N, int L, int out_d,
                                                   int in_d, int norm) {
  return v_update_workspace_floats(N, out_d, in_d, norm, L);
}

int maecho_v_update_stacked_launch(const void* W, const void* V, const void* P,
                                   void* out, void* workspace, int N, int L,
                                   int out_d, int in_d, float frac, int norm,
                                   float eps, void* stream) {
  return v_update_launch(stacked_dense_op(W, V, P, out_d, in_d, L), W, V, out, workspace,
                         N, out_d, in_d, frac, norm, eps, stream, L);
}

}  // extern "C"
