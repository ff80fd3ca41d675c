// B6 — MA-Echo Eq. 7 global update with diagonal projectors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:281
// (`maecho_update_diag`, pl.pallas_call at :293, body `_diag_kernel`):
//     W' = W + eta * sum_i (-2 alpha_i) (W - V_i) * p_i[None, :]
// with W (out, in), V (N, out, in), p (N, in), alpha (N,), fp32 in and
// fp32 accumulation; the client sum runs in client order, in the TPU
// kernel's arithmetic order.
//
// Design.  One pass over W and V: one thread per element of the flat
// (out, in) leaf (a grid-stride loop), the client loop inside the
// thread; neighbouring threads read neighbouring addresses of W and of
// each V_i.  alpha is read from device memory (no host sync).
//
// Bound.  4*(2*out*in + N*out*in + N*in + N) bytes against ~4*N*out*in
// flops: at W0 (400x784, N=4) 7.54 MB, bound by bytes (3.35 TB/s):
// 2.3 us, below one launch's latency.

#include "maecho_diag.cuh"

extern "C" int maecho_update_diag_launch(const void* W, const void* V,
                                         const void* p, const void* alpha,
                                         void* out, int N, int out_d, int in_d,
                                         float eta, void* stream) {
  return update_diag_launch(W, V, p, alpha, out, N, 1, out_d, in_d, eta, stream);
}
