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

#include "maecho_tile.cuh"

namespace {

constexpr int kRowsPerCta = NT / 32;

template <bool NORM>
__global__ void __launch_bounds__(NT)
v_update_diag_kernel(const float* __restrict__ W, const float* __restrict__ V,
                     const float* __restrict__ p, float* __restrict__ out,
                     int out_d, int in_d, long long rows, float frac, float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                        // warp-uniform
  const int i = (int)(row / out_d), o = (int)(row % out_d);
  const float* Wr = W + (size_t)o * in_d;
  const float* Vr = V + (size_t)row * in_d;
  const float* pr = p + (size_t)i * in_d;
  float* Or = out + (size_t)row * in_d;
  float den = 1.f;
  if (NORM) {
    float ss = 0.f;
    for (int c = lane; c < in_d; c += 32) {
      const float u = (Wr[c] - Vr[c]) * (1.0f - frac * pr[c]);
      ss = fmaf(u, u, ss);
    }
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    den = fmaxf(sqrtf(ss), eps);
  }
  for (int c = lane; c < in_d; c += 32) {
    const float v = Vr[c];
    const float u = (Wr[c] - v) * (1.0f - frac * pr[c]);
    Or[c] = v + (NORM ? u / den : u);
  }
}

}  // namespace

extern "C" int maecho_v_update_diag_launch(const void* W, const void* V,
                                           const void* p, void* out, int N,
                                           int out_d, int in_d, float frac,
                                           int norm, float eps, void* stream) {
  if (N < 1 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)N * out_d;
  const long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* pp = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  if (norm)
    v_update_diag_kernel<true><<<(unsigned)ctas, NT, 0, s>>>(w, v, pp, o, out_d, in_d,
                                                             rows, frac, eps);
  else
    v_update_diag_kernel<false><<<(unsigned)ctas, NT, 0, s>>>(w, v, pp, o, out_d, in_d,
                                                              rows, frac, eps);
  return (int)cudaGetLastError();
}
