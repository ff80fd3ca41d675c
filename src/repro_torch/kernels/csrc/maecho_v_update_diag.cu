// B9 — MA-Echo Eq. 11 anchor update with diagonal projectors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:301
// (`maecho_v_update_diag`, pl.pallas_call at :315, body `_v_diag_kernel`):
//     V_i' = V_i + Norm(D_i * (1 - frac * p_i[None, :])),   D_i = W' - V_i
// with W' (out, in), V (N, out, in), p (N, in), frac = mu/(1+mu); Norm
// divides each row (over in) by max(||row||_2, eps) when norm is on.
// fp32 in, fp32 accumulation.
//
// Design.  One warp per (client, row), eight rows per CTA.  No K-loop
// feeds the row, so with norm the warp sums the row's squares (lanes
// stride the row, a fixed butterfly: deterministic), then makes a second
// pass that recomputes the update and writes it scaled; the second read
// of the row hits L1.  The TPU kernel needed the whole row resident
// (bi = in_d); B7's two-pass cross-CTA reduction is not needed here.
//
// Bound.  4*(out*in + 2*N*out*in + N*in) bytes against ~5*N*out*in
// flops (8 with norm): at W0 (400x784, N=4) 11.30 MB, bound by bytes
// (3.35 TB/s): 3.4 us, below one launch's latency.

#include "maecho_diag.cuh"

extern "C" int maecho_v_update_diag_launch(const void* W, const void* V,
                                           const void* p, void* out, int N,
                                           int out_d, int in_d, float frac,
                                           int norm, float eps, void* stream) {
  return v_update_diag_launch(W, V, p, out, N, 1, out_d, in_d, frac, norm, eps,
                              stream);
}
