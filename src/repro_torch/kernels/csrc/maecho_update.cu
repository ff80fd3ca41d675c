// B4 — MA-Echo Eq. 7 global update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:58
// (`maecho_update`, pl.pallas_call at :76):
//     W' = W + eta * ( -sum_i 2 alpha_i (W - V_i) P_i )
// with W (out, in), V (N, out, in), P (N, in, in), alpha (N,), fp32 in
// and fp32 accumulation (no TF32).
//
// Design.  The TPU grid accumulated into one output tile across its
// (client, k) grid axes with alpha in SMEM.  Here one CTA owns one
// 32x32 output tile and loops over clients and k itself: each client's
// residual tile (W - V_i) P_i is a K-loop over shared-memory staged
// tiles (plain fp32 FMA), then folded into the register accumulator as
// (-2 alpha_i) * r_i, in the reference's order.  alpha is read from
// device memory (no host sync per leaf per iteration).  W feeds both
// the residual and the epilogue through one pointer.  Ragged edges are
// masked on load and store, so no operand is padded.
//
// Bound.  2*N*out*in^2 flops against ~4*(N*in^2 + N*out*in + 2*out*in)
// bytes: at W0 (400x784, N=4) ~2 GFLOP on ~15 MB, bound by fp32
// operations (67 TFLOP/s without tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
update_kernel(const float* __restrict__ W, const float* __restrict__ V,
              const float* __restrict__ P, const float* __restrict__ alpha,
              float* __restrict__ out, int N, int out_d, int in_d, float eta) {
  __shared__ float As[T][T + 1];
  __shared__ float Bs[T][T];
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;

  float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
  for (int i = 0; i < N; ++i) {
    const float* Vi = V + i * OI;
    const float* Pi = P + i * II;
    float r00 = 0.f, r01 = 0.f, r10 = 0.f, r11 = 0.f;
    for (int k0 = 0; k0 < in_d; k0 += T) {
      for (int e = tid; e < T * T; e += NT) {
        const int r = e / T, c = e % T;
        const int o = o0 + r, k = k0 + c;
        As[r][c] = (o < out_d && k < in_d)
                       ? W[(size_t)o * in_d + k] - Vi[(size_t)o * in_d + k] : 0.f;
        const int kr = k0 + r, cc = c0 + c;
        Bs[r][c] = (kr < in_d && cc < in_d) ? Pi[(size_t)kr * in_d + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T; ++kk) {
        const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
        const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
        r00 = fmaf(a0, b0, r00);
        r01 = fmaf(a0, b1, r01);
        r10 = fmaf(a1, b0, r10);
        r11 = fmaf(a1, b1, r11);
      }
      __syncthreads();
    }
    const float m = -2.0f * alpha[i];
    acc00 += m * r00;
    acc01 += m * r01;
    acc10 += m * r10;
    acc11 += m * r11;
  }

  const float acc[2][2] = {{acc00, acc01}, {acc10, acc11}};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int o = o0 + ty + 16 * a, c = c0 + tx + 16 * b;
      if (o < out_d && c < in_d) {
        const size_t idx = (size_t)o * in_d + c;
        out[idx] = W[idx] + eta * acc[a][b];
      }
    }
  }
}

}  // namespace

extern "C" int maecho_update_launch(const void* W, const void* V,
                                    const void* P, const void* alpha,
                                    void* out, int N, int out_d, int in_d,
                                    float eta, void* stream) {
  if (N < 1 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((in_d + T - 1) / T, (out_d + T - 1) / T);
  update_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(P), static_cast<const float*>(alpha),
      static_cast<float*>(out), N, out_d, in_d, eta);
  return (int)cudaGetLastError();
}
