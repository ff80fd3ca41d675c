// B8 — MA-Echo Eq. 11 anchor update for factored projectors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:127
// (`maecho_v_update_factored`, pl.pallas_call at :146):
//     V_i' = V_i + Norm((W' - V_i) - frac * B_i UT_i)
// with B (N, out, k) the compressed residual of W' (so B_i UT_i =
// (W' - V_i) P_i for P_i = U_i diag(s_i) U_i^T), UT (N, k, in), W'
// (out, in), V (N, out, in), frac = mu/(1+mu); fp32 in, fp32 accumulation
// (no TF32).  B7's design (maecho_tile.cuh) with the K-loop over the
// rank: one CTA per (client, 32x32 tile), and with norm on a two-pass
// row norm (per-tile row sums of squares, then a fixed-order sum and
// rescale), where the TPU kernel needed whole rows resident.
//
// Bound.  2*N*out*in*k flops against 4*(N*out*k + N*k*in + out*in +
// 2*N*out*in) bytes: at W0 (400x784, N=4, k=78) ~0.20 GFLOP on ~12.8 MB,
// bound by memory (3.35 TB/s).

#include "maecho_tile.cuh"

extern "C" {

long long maecho_v_update_factored_workspace_floats(int N, int out_d, int in_d,
                                                    int norm) {
  return v_update_workspace_floats(N, out_d, in_d, norm);
}

int maecho_v_update_factored_launch(const void* B, const void* UT,
                                    const void* W, const void* V, void* out,
                                    void* workspace, int N, int out_d, int in_d,
                                    int rank, float frac, int norm, float eps,
                                    void* stream) {
  return v_update_launch(left_op(B, UT, out_d, in_d, rank), W, V, out,
                         workspace, N, out_d, in_d, frac, norm, eps, stream);
}

}  // extern "C"
