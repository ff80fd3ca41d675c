// B10 — MA-Echo Eq. 6 Grams of a scan-stacked leaf, one launch for all
// layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:283
// (`maecho_gram_stacked`, pl.pallas_call at :299):
//     G[l, i, j] = <R_li, R_lj>,   R_li = (W_l - V_il) P_il
// with W (L, out, in), V (N, L, out, in), P (N, L, in, in), all fp32,
// fp32 accumulation (no TF32) -> G (L, N, N).
//
// Design.  B1's kernel (maecho_tile.cuh) with the layer on blockIdx.z:
// each CTA parks the N residual tiles of its (layer, 32x32 tile) in
// shared memory and writes its partial (N, N); the fixed-order reduce
// then sums each layer's partials in tile order, so every layer's Gram
// (and the QP's alpha) is bitwise reproducible.  Any N (client blocks
// above 54 share grid z with the layer), L * block pairs <= 65535.
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(N+1) + N*in^2) bytes:
// at Qwen2-0.5B's wq (L=24, 896x896, N=2) 69.1 GFLOP on 0.39 GB, bound
// by fp32 operations (67 TFLOP/s without tensor cores): 1.03 ms; at
// w_gate (4864x896 in kernel layout) 375 GFLOP, 5.6 ms.

#include "maecho_tile.cuh"

extern "C" {

long long maecho_gram_stacked_workspace_floats(int N, int L, int out_d, int in_d) {
  return gram_workspace_floats(N, out_d, in_d, L);
}

int maecho_gram_stacked_launch(const void* W, const void* V, const void* P,
                               void* workspace, void* G, int N, int L, int out_d,
                               int in_d, void* stream) {
  return gram_launch(stacked_dense_op(W, V, P, out_d, in_d, L), workspace, G, N, out_d,
                     in_d, stream, L);
}

}  // extern "C"
