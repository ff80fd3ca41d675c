// B7 — MA-Echo Eq. 11 anchor update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:89
// (`maecho_v_update`, pl.pallas_call at :107):
//     V_i' = V_i + Norm(D_i - frac * D_i P_i),   D_i = W' - V_i
// with W' (out, in), V (N, out, in), P (N, in, in), frac = mu/(1+mu);
// Norm divides each row (over in) by max(||row||_2, eps) when norm is
// on.  fp32 in, fp32 accumulation (no TF32).  One CTA per (client, 32x32
// tile); the row norm is a two-pass, fixed-order reduction
// (maecho_tile.cuh).
//
// Bound.  2*N*out*in^2 flops against ~4*(N*in^2 + 2*N*out*in + out*in)
// bytes: at W0 (400x784, N=4) ~2 GFLOP on ~20 MB, bound by fp32
// operations (67 TFLOP/s without tensor cores).

#include "maecho_tile.cuh"

extern "C" {

long long maecho_v_update_workspace_floats(int N, int out_d, int in_d, int norm) {
  return v_update_workspace_floats(N, out_d, in_d, norm);
}

int maecho_v_update_launch(const void* W, const void* V, const void* P,
                           void* out, void* workspace, int N, int out_d,
                           int in_d, float frac, int norm, float eps,
                           void* stream) {
  return v_update_launch(dense_op(W, V, P, out_d, in_d), W, V, out, workspace,
                         N, out_d, in_d, frac, norm, eps, stream);
}

}  // extern "C"
