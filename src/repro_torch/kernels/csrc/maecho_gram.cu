// B1 — MA-Echo Eq. 6 Gram of projected residuals, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:118
// (`maecho_gram`, pl.pallas_call at :131):
//     G[i, j] = <R_i, R_j>,   R_i = (W - V_i) P_i
// with W (out, in), V (N, out, in), P (N, in, in), all fp32, fp32
// accumulation (no TF32).  Design (per-tile partial Grams parked in
// shared memory, client blocks above 54 clients, a fixed-order
// second-pass reduce) in maecho_tile.cuh.
//
// Bound.  2*N*out*in^2 FMA-flops for the residual GEMM chain against
// ~4*(N*in^2 + N*out*in) bytes read: at the paper MLP's W0 (400x784,
// N=4) that is ~2 GFLOP on ~15 MB, bound by fp32 operations (67 TFLOP/s
// without tensor cores), not by the 3.35 TB/s memory.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_gram_workspace_floats(int N, int out_d, int in_d) {
  return gram_workspace_floats(N, out_d, in_d);
}

int maecho_gram_launch(const void* W, const void* V, const void* P,
                       void* workspace, void* G, int N, int out_d, int in_d,
                       void* stream) {
  return gram_launch(dense_op(W, V, P, out_d, in_d), workspace, G, N, out_d,
                     in_d, stream);
}

}  // extern "C"
