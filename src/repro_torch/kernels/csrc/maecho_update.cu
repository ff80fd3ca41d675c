// B4 — MA-Echo Eq. 7 global update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:58
// (`maecho_update`, pl.pallas_call at :76):
//     W' = W + eta * ( -sum_i 2 alpha_i (W - V_i) P_i )
// with W (out, in), V (N, out, in), P (N, in, in), alpha (N,), fp32 in
// and fp32 accumulation (no TF32).  One CTA per 32x32 output tile loops
// over clients (maecho_tile.cuh); alpha is read from device memory (no
// host sync per leaf per iteration).
//
// Bound.  2*N*out*in^2 flops against ~4*(N*in^2 + N*out*in + 2*out*in)
// bytes: at W0 (400x784, N=4) ~2 GFLOP on ~15 MB, bound by fp32
// operations (67 TFLOP/s without tensor cores).

#include "maecho_tile.cuh"

extern "C" int maecho_update_launch(const void* W, const void* V,
                                    const void* P, const void* alpha,
                                    void* out, int N, int out_d, int in_d,
                                    float eta, void* stream) {
  return update_launch(dense_op(W, V, P, out_d, in_d), W, alpha, out, N,
                       out_d, in_d, eta, stream);
}
