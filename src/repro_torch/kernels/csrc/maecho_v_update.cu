// B7 — MA-Echo Eq. 11 anchor update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:89
// (`maecho_v_update`, pl.pallas_call at :107):
//     V_i' = V_i + Norm(D_i - frac * D_i P_i),   D_i = W' - V_i
// with W' (out, in), V (N, out, in), P (N, in, in), frac = mu/(1+mu);
// Norm divides each row (over in) by max(||row||_2, eps) when norm is
// on.  fp32 in, fp32 accumulation (no TF32).
//
// Design.  One CTA per (client, 32x32 output tile): the D_i P_i tile is
// a K-loop over shared-memory staged tiles (plain fp32 FMA), and the
// epilogue forms u = D_i - frac * D_i P_i.  Without norm it stores
// V_i + u directly.  The TPU kernel normalised with whole rows resident
// in VMEM (bi = in); a Hopper tile is never sized to a full row.
// Instead, with norm on, the first launch stores u and each tile's
// per-row sum of squares (summed in column order) to a
// (N, out, n_col_tiles) workspace, and a second launch sums each row's
// partials in tile order and rescales: V_i + u / max(sqrt(ss), eps).
// Both sums run in a fixed order, so the result is reproducible.
// Ragged edges are masked on load and store; nothing is padded.
//
// Bound.  2*N*out*in^2 flops against ~4*(N*in^2 + 2*N*out*in + out*in)
// bytes: at W0 (400x784, N=4) ~2 GFLOP on ~20 MB, bound by fp32
// operations (67 TFLOP/s without tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;
constexpr int NT = 256;

int tiles(int d) { return (d + T - 1) / T; }

template <bool NORM>
__global__ void __launch_bounds__(NT)
v_update_kernel(const float* __restrict__ W, const float* __restrict__ V,
                const float* __restrict__ P, float* __restrict__ out,
                float* __restrict__ rowss, int out_d, int in_d, float frac) {
  __shared__ float As[T][T + 1];
  __shared__ float Bs[T][T];
  __shared__ float Sq[T][T + 1];
  const int i = blockIdx.z;
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;
  const float* Vi = V + i * OI;
  const float* Pi = P + i * II;
  float* Oi = out + i * OI;

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

  const float acc[2][2] = {{r00, r01}, {r10, r11}};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int lr = ty + 16 * a, lc = tx + 16 * b;
      const int o = o0 + lr, c = c0 + lc;
      float u = 0.f;
      if (o < out_d && c < in_d) {
        const size_t idx = (size_t)o * in_d + c;
        const float v = Vi[idx];
        u = (W[idx] - v) - frac * acc[a][b];
        Oi[idx] = NORM ? u : v + u;
      }
      if (NORM) Sq[lr][lc] = u * u;
    }
  }
  if (NORM) {
    __syncthreads();
    if (tid < T && o0 + tid < out_d) {
      float s = 0.f;
      for (int c = 0; c < T; ++c) s += Sq[tid][c];
      rowss[((size_t)i * out_d + o0 + tid) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// One CTA per (client, row): sum the row's tile partials in tile order,
// then V_i' = V_i + u / max(||u||, eps) over the row.
__global__ void v_norm_kernel(const float* __restrict__ V, float* __restrict__ out,
                              const float* __restrict__ rowss, int in_d,
                              int n_ct, float eps) {
  const size_t row = blockIdx.x;
  float ss = 0.f;
  for (int t = 0; t < n_ct; ++t) ss += rowss[row * n_ct + t];
  const float den = fmaxf(sqrtf(ss), eps);
  for (int c = threadIdx.x; c < in_d; c += blockDim.x) {
    const size_t idx = row * in_d + c;
    out[idx] = V[idx] + out[idx] / den;
  }
}

}  // namespace

extern "C" {

// Floats of workspace the launch needs: per-row, per-column-tile sums of
// squares when norm is on, none otherwise.
long long maecho_v_update_workspace_floats(int N, int out_d, int in_d, int norm) {
  return norm ? (long long)N * out_d * tiles(in_d) : 0;
}

int maecho_v_update_launch(const void* W, const void* V, const void* P,
                           void* out, void* workspace, int N, int out_d,
                           int in_d, float frac, int norm, float eps,
                           void* stream) {
  if (N < 1 || N > 65535 || out_d < 1 || in_d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles(in_d), tiles(out_d), N);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* p = static_cast<const float*>(P);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (!norm) {
    v_update_kernel<false><<<grid, NT, 0, s>>>(w, v, p, o, ws, out_d, in_d, frac);
    return (int)cudaGetLastError();
  }
  v_update_kernel<true><<<grid, NT, 0, s>>>(w, v, p, o, ws, out_d, in_d, frac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  v_norm_kernel<<<N * out_d, 256, 0, s>>>(v, o, ws, in_d, (int)grid.x, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
