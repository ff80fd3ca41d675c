// B3 — MA-Echo Eq. 6 Gram of diagonally projected residuals, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:386
// (`maecho_gram_diag`, pl.pallas_call at :396, body `_gram_diag_kernel`):
//     G[i, j] = sum_{o, c} R_i[o, c] * R_j[o, c],   R_i = (W - V_i) * p_i[None, :]
// with W (out, in), V (N, out, in), p (N, in), all fp32, fp32
// accumulation.  Scalar projectors reach it broadcast to a diagonal.
//
// Design.  There is no K-loop: every element of the leaf is read once.
// The leaf is walked as one flat array of out*in elements in chunks of
// kChunk; CTA b takes chunks b, b + gridDim.x, ...  Per chunk the CTA
// stages the N residual rows (N x kChunk floats, 27 KiB at N = 54, so
// static shared memory under the 48 KiB default suffices; above 54
// clients a CTA stages the rows of one pair of client blocks of at most
// 27, maecho_tile.cuh's ClientBlocks, with the pair on grid z), then one
// warp per (i <= j) pair contracts them (lanes stride the chunk, fixed
// butterfly) and adds the sum into the CTA's (N, N) accumulator in
// shared memory.  A pair always belongs to the same warp, so there are
// no atomics.  Each CTA writes its partial (N, N) and the shared
// gram_reduce_kernel (maecho_tile.cuh) sums the partials in CTA order:
// G, and so the QP's alpha, is bitwise reproducible.  The grid size
// depends on the shape only.  Ragged edges need no masking beyond the
// end of the flat array.
//
// Bound.  4*(out*in*(N+1) + N*in) bytes against ~(N+1)*N*out*in flops:
// at the paper MLP's W0 (400x784, N=4) 6.28 MB and 9 MFLOP, bound by
// bytes (3.35 TB/s): 1.9 us, below one launch's latency.

#include "maecho_diag.cuh"

extern "C" {

long long maecho_gram_diag_workspace_floats(int N, int out_d, int in_d) {
  return gram_diag_workspace_floats(N, out_d, in_d, 1);
}

int maecho_gram_diag_launch(const void* W, const void* V, const void* p,
                            void* workspace, void* G, int N, int out_d, int in_d,
                            void* stream) {
  return gram_diag_launch(W, V, p, workspace, G, N, 1, out_d, in_d, stream);
}

}  // extern "C"
