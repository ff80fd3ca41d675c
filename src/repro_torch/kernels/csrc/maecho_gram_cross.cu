// B19 — cross-Gram block of two client chunks' flat residual rows, for
// Hopper (sm_90a): the pair contraction of the client-chunked MA-Echo
// Gram (kernels/ops.py, the chunked pipeline).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:227
// (`maecho_gram_cross`, pl.pallas_call at :242, body `_gram_cross_kernel`):
//     G[i, j] = sum_c Ra[i, c] * Rb[j, c],   Ra (ca, D), Rb (cb, D)
// fp32 in and out, no TF32.  Ra and Rb may be the same tensor (a chunk's
// diagonal block).
//
// Design: the split-K contraction of maecho_cross.cuh (shared with B1's
// pair contraction since it left the SIMT blocked route).
//
// Bound.  Each input read once and G written once: 4*(ca + cb)*D bytes,
// against 2*ca*cb*D fp32 operations.  At ca = cb = 64, D = 400*784:
// 160.6 MB (0.048 ms at 3.35 TB/s) and 2.57 GFLOP (0.038 ms at 67
// TFLOP/s): bound by bytes, and every skinny pair more so ((1, 1,
// 896*151 936): 1.09 GB, 0.33 ms).  The 64 x 64 tile is bound on the card
// by its FMAs: a thread's 4 x 4 block takes 64 FMAs per eight 16-byte
// shared loads.

#include "maecho_cross.cuh"

extern "C" {

long long maecho_gram_cross_workspace_floats(int ca, int cb, long long D) {
  return cross::cross_workspace_floats(ca, cb, D);
}

int maecho_gram_cross_launch(const void* Ra, const void* Rb, void* workspace, void* G,
                             int ca, int cb, long long D, void* stream) {
  return cross::cross_launch(Ra, Rb, workspace, G, ca, cb, D,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
