// B16 — MA-Echo Eq. 11 anchor update of a scan-stacked leaf, one launch
// for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:169
// (`maecho_v_update_stacked`, pl.pallas_call at :186):
//     V_il' = V_il + Norm(D_il - frac * D_il P_il),   D_il = W_l' - V_il
// with W' (L, out, in), V (N, L, out, in), P (N, L, in, in),
// frac = mu/(1+mu); Norm divides each row (over in) by max(||row||, eps)
// when norm is on.  fp32 in and out, held to the fp32 tolerances.
//
// Design: 3xTF32 on the tensor cores (wgmma), the stage machinery of
// maecho_tf32.cuh (A = W' - V_i and B = P_i^T split into tf32 hi and lo,
// hi.hi + hi.lo + lo.hi each k8 step, a fresh accumulator each 32-deep
// stage added to the running one in fp32).  One CTA of two consumer
// warpgroups per (layer, client, 128 (out) x 128 (in) output tile),
// blockIdx.z = l*N + i (N*L <= 65535), running its own copy of the stage
// loop over the client's depth.  No atomics: the result is bitwise
// reproducible.
// Epilogue: u = (W' - V_i) - frac * acc, then V_i + u; with the norm on,
// u and the tile's per-row sums of squares, and the second pass
// v_norm_kernel (maecho_tile.cuh) sums each row's tile partials in tile
// order and rescales.  Ragged out, in and depth are masked on load (zero,
// exact) and on store; offsets are 64-bit.
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(2N+1) + N*in^2)
// bytes.  At Qwen2-0.5B's w_gate (L=24, 4864x896, N=2) 374.9 GFLOP; the
// fastest rate that meets the fp32 tolerances is three TF32 products at
// 495 TFLOP/s: 2.27 ms, by operations (0.67 ms by bytes).  On an NVIDIA
// H100 80GB HBM3 at 700 W this body takes 5.97 ms there (tools/
// time_kernels.py); with its products removed 3.77 ms, with its split
// removed 4.23 ms: each stage's split of both operands (redone by every
// tile that reads them) and its barriers and drained products are
// serialised by the two warpgroups' lockstep, which is what holds it at
// 2.6x the bound (PERF.md §6 lists the variants measured).

#include "maecho_tile.cuh"
#include "maecho_tf32.cuh"

namespace {
namespace tf32 {

// u = (W' - V_i) - frac * (W' - V_i) P_i for one (layer, client, tile),
// z = l*N + i; without norm the launch stores V_i + u, with norm it stores
// u and the tile's per-row sums of squares to rowss (N, L, out, n_col_tiles).
template <bool NORM, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
v_update_tf32_kernel(const float* __restrict__ W, const float* __restrict__ V,
                     const float* __restrict__ P, float* __restrict__ out,
                     float* __restrict__ rowss, int N, int L, int out_d, int in_d,
                     float frac) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* planes = smem + 2 * kRawBytes;   // two sets, kPlaneBytes apart
  const int l = blockIdx.z / N, i = blockIdx.z % N;
  const int c0 = blockIdx.x * 128, o0 = blockIdx.y * 128;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;
  const size_t il = (size_t)i * L + l;   // (client, layer) of V, P and out
  const float* Wl = W + (size_t)l * OI;
  const float* Vi = V + il * OI;
  const float* Pi = P + il * II;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, t = lane % 4;
  // accumulator rows ra, ra + 8 of the tile (warpgroup wg, warp (tid / 32) % 4)
  const int ra = wg * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const int nk = (in_d + kBK - 1) / kBK;
  const uint32_t planes0 = smem_u32(planes);

  // Pipeline: raw stage s + 1 is split into plane set (s + 1) % 2 while
  // the products of stage s run on set s % 2; then part (stage s) is
  // added to acc in fp32 and stage s + 1's products are issued.  Raw
  // stage s + 3 is copied into the slot stage s + 1 leaves.  The tensor
  // cores' accumulation truncates, so each stage sums into a fresh part
  // and acc is promoted once a stage (a bias of ~1 ulp a step otherwise
  // grows with the depth: 5x the plain fp32 error at in = 896).
  for (int r = 0; r < 3; ++r) {
    if (r < nk)
      load_stage<kVec>(smem + (r % 2) * kRawBytes, Wl, Vi, Pi, o0, c0, r * kBK, out_d, in_d,
                       tid);
    cp_commit();
    if (r == 1) {                // raw 0 has landed: split it, free its slot
      cp_wait<1>();
      __syncthreads();
      split_stage(smem, planes, tid);
      __syncthreads();
    }
  }
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
  pin(part);
  stage_mma(part, planes0, wg);

  for (int s = 0; s < nk; ++s) {
    const int sn = s + 1;
    if (sn < nk) {
      cp_wait<1>();              // raw sn has landed, for this thread's copies
      __syncthreads();           // ... and everyone's
      split_stage(smem + (sn % 2) * kRawBytes, planes + (sn % 2) * kPlaneBytes, tid);
      __syncthreads();           // raw slot sn % 2 is spent; plane set sn % 2 is ready
      if (sn + 2 < nk)
        load_stage<kVec>(smem + (sn % 2) * kRawBytes, Wl, Vi, Pi, o0, c0, (sn + 2) * kBK,
                         out_d, in_d, tid);
      cp_commit();
    }
    wg_wait0();
    pin(part);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
    if (sn < nk) stage_mma(part, planes0 + (sn % 2) * kPlaneBytes, wg);
  }

  // accumulator register 4 n + 2 i + j: row ra + 8 i, column 8 n + 2 t + j
  float* Oi = out + il * OI;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
    float ss = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (o >= out_d || c >= in_d) continue;
      const size_t idx = (size_t)o * in_d + c;
      if constexpr (kVec) {      // c even and in % 4 == 0: both columns in, 8-byte aligned
        const float2 v = *reinterpret_cast<const float2*>(Vi + idx);
        const float2 w = *reinterpret_cast<const float2*>(Wl + idx);
        const float u0 = (w.x - v.x) - frac * acc[4 * n + 2 * ii],
                    u1 = (w.y - v.y) - frac * acc[4 * n + 2 * ii + 1];
        *reinterpret_cast<float2*>(Oi + idx) =
            NORM ? make_float2(u0, u1) : make_float2(v.x + u0, v.y + u1);
        ss = fmaf(u0, u0, ss);
        ss = fmaf(u1, u1, ss);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (c + j >= in_d) break;
          const float v = Vi[idx + j];
          const float u = (Wl[idx + j] - v) - frac * acc[4 * n + 2 * ii + j];
          Oi[idx + j] = NORM ? u : v + u;
          ss = fmaf(u, u, ss);
        }
      }
    }
    if (NORM) {
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (t == 0 && o < out_d) rowss[(il * out_d + o) * gridDim.x + blockIdx.x] = ss;
    }
  }
}

}  // namespace tf32
}  // namespace

extern "C" {

// Floats of workspace a launch needs: per-row, per-128-column-tile sums of
// squares when norm is on, none otherwise.
long long maecho_v_update_stacked_workspace_floats(int N, int L, int out_d, int in_d,
                                                   int norm) {
  return norm ? (long long)N * L * out_d * tf32::tiles128(in_d) : 0;
}

int maecho_v_update_stacked_launch(const void* W, const void* V, const void* P, void* out,
                                   void* workspace, int N, int L, int out_d, int in_d,
                                   float frac, int norm, float eps, void* stream) {
  using namespace tf32;
  const long long rows = (long long)N * L * out_d;
  if (N < 1 || L < 1 || (long long)N * L > 65535 || out_d < 1 || in_d < 1 ||
      tiles128(out_d) > 65535 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles128(in_d), tiles128(out_d), N * L);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* p = static_cast<const float*>(P);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  const bool vec = vec_ok(in_d, W, V, P);
  auto kernel = norm ? (vec ? v_update_tf32_kernel<true, true> : v_update_tf32_kernel<true, false>)
                     : (vec ? v_update_tf32_kernel<false, true>
                            : v_update_tf32_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmem, s>>>(w, v, p, o, ws, N, L, out_d, in_d, frac);
  err = cudaGetLastError();
  if (err != cudaSuccess || !norm) return (int)err;
  v_norm_kernel<<<(unsigned)rows, 256, 0, s>>>(v, o, ws, in_d, (int)grid.x, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
