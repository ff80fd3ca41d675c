// B13 — MA-Echo Eq. 7 global update of a scan-stacked leaf, one launch
// for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:163
// (`maecho_update_stacked`, pl.pallas_call at :177):
//     W_l' = W_l + eta * ( -sum_i 2 alpha_li (W_l - V_il) P_il )
// with W (L, out, in), V (N, L, out, in), P (N, L, in, in), alpha (L, N),
// fp32 in and out, held to the fp32 tolerances.
//
// Design: 3xTF32 on the tensor cores (wgmma), B16's stage machinery
// (maecho_tf32.cuh).  One CTA of two consumer warpgroups per (layer,
// 128 (out) x 128 (in) output tile), blockIdx.z = l.  The CTA runs the
// clients in order, each client's depth in 32-deep stages, as one
// pipeline (run_stages, walked by cursors): copies run two stages ahead
// across client boundaries.  Each stage's 12 products (small ones first)
// sum into a fresh accumulator, which is added to the running sum with an
// fp32 FMA times m_i = -2 alpha_li (alpha read from device memory: no
// host sync).  So the CTA holds 64 fresh + 64 running floats a thread, as
// B16 does.  Epilogue: out = fmaf(eta, acc, W) (one rounding, whatever
// the compiler's contraction setting), masked on ragged out and in.  A
// persistent grid, as B10 has, measured 5% slower here (an NVIDIA H100,
// w_gate).  No atomics and one launch a call: the result is bitwise
// reproducible.
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(N+2) + N*in^2 + N)
// bytes.  At Qwen2-0.5B's w_gate (L=24, 4864x896, N=2) 374.9 GFLOP; at
// the 3xTF32 rate (495/3 TFLOP/s) 2.27 ms, by operations.  The SIMT body
// this replaces (maecho_tile.cuh's update_kernel) took 34.3 ms there on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

#include "maecho_tf32.cuh"

namespace {
namespace tf32 {

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
update_tf32_kernel(const float* __restrict__ W, const float* __restrict__ V,
                   const float* __restrict__ P, const float* __restrict__ alpha,
                   float* __restrict__ out, int N, int L, int out_d, int in_d, float eta) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int l = blockIdx.z;
  const int c0 = blockIdx.x * 128, o0 = blockIdx.y * 128;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;
  const float* Wl = W + (size_t)l * OI;
  const float* al = alpha + (size_t)l * N;
  const int tid = threadIdx.x, t = tid % 4, ra = acc_row(tid);
  const int nk = (in_d + kBK - 1) / kBK;

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  int li = 0, ls = 0;            // next stage to load: client, depth step
  int ci = 0, cs = 0;            // next stage to finish
  float m = -2.0f * al[0];
  run_stages(
      DenseStage<kVec>{}, smem, N * nk, out_d, in_d,
      [&](int) {
        const size_t il = (size_t)li * L + l;
        const StageRef r{Wl, V + il * OI, P + il * II, o0, c0, ls * kBK};
        if (++ls == nk) {
          ls = 0;
          ++li;
        }
        return r;
      },
      [&](int, float(&part)[64]) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = fmaf(m, part[e], acc[e]);
        if (++cs == nk) {
          cs = 0;
          if (++ci < N) m = -2.0f * al[ci];
        }
      },
      [](int) {});

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (o >= out_d || c >= in_d) continue;
      const size_t idx = (size_t)l * OI + (size_t)o * in_d + c;
      if constexpr (kVec) {      // c even and in % 4 == 0: both columns in, 8-byte aligned
        const float2 w = *reinterpret_cast<const float2*>(W + idx);
        *reinterpret_cast<float2*>(out + idx) = make_float2(
            fmaf(eta, acc[4 * n + 2 * ii], w.x), fmaf(eta, acc[4 * n + 2 * ii + 1], w.y));
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (c + j < in_d) out[idx + j] = fmaf(eta, acc[4 * n + 2 * ii + j], W[idx + j]);
      }
    }
  }
}

}  // namespace tf32
}  // namespace

extern "C" int maecho_update_stacked_launch(const void* W, const void* V, const void* P,
                                            const void* alpha, void* out, int N, int L,
                                            int out_d, int in_d, float eta, void* stream) {
  using namespace tf32;
  if (N < 1 || L < 1 || L > 65535 || out_d < 1 || in_d < 1 || tiles128(out_d) > 65535 ||
      (long long)N * ((in_d + kBK - 1) / kBK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles128(in_d), tiles128(out_d), L);
  auto kernel = vec_ok(in_d, W, V, P) ? update_tf32_kernel<true> : update_tf32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(P), static_cast<const float*>(alpha),
      static_cast<float*>(out), N, L, out_d, in_d, eta);
  return (int)cudaGetLastError();
}
