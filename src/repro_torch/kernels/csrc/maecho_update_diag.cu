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

#include "maecho_tile.cuh"

namespace {

constexpr int kMaxCtasUpdate = 4096;

__global__ void __launch_bounds__(NT)
update_diag_kernel(const float* __restrict__ W, const float* __restrict__ V,
                   const float* __restrict__ p, const float* __restrict__ alpha,
                   float* __restrict__ out, int N, int in_d, long long total,
                   float eta) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < total; e += stride) {
    const float w = W[e];
    const int c = (int)(e % in_d);
    float acc = 0.f;
    for (int i = 0; i < N; ++i)
      acc += (-2.0f * alpha[i] * (w - V[(size_t)i * total + e])) * p[(size_t)i * in_d + c];
    out[e] = w + eta * acc;
  }
}

}  // namespace

extern "C" int maecho_update_diag_launch(const void* W, const void* V,
                                         const void* p, const void* alpha,
                                         void* out, int N, int out_d, int in_d,
                                         float eta, void* stream) {
  if (N < 1 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)out_d * in_d;
  const long long need = (total + NT - 1) / NT;
  const int ctas = (int)(need < kMaxCtasUpdate ? need : kMaxCtasUpdate);
  update_diag_kernel<<<ctas, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(p), static_cast<const float*>(alpha),
      static_cast<float*>(out), N, in_d, total, eta);
  return (int)cudaGetLastError();
}
