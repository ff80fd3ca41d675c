// B17 — MA-Echo Eq. 11 anchor update of a scan-stacked leaf with
// factored projectors, one launch for all layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_v_update.py:212
// (`maecho_v_update_factored_stacked`, pl.pallas_call at :233):
//     V_il' = V_il + Norm((W_l' - V_il) - frac * B_li UT_li)
// with B (N, L, out, k) the compressed residual of W' (so B_li UT_li =
// (W_l' - V_il) P_il for P_il = U_il diag(s_il) U_il^T), UT (N, L, k, in),
// W' (L, out, in), V (N, L, out, in), frac = mu/(1+mu); Norm divides each
// row (over in) by max(||row||, eps) when norm is on.  fp32 in and out,
// held to the fp32 tolerances.  B is formed before the launch, as the
// reference does outside its pallas_call.
//
// Bound.  2*N*L*out*in*k flops (plus 2*N*L*out*in elementwise) against
// 4*L*(N*out*k + N*k*in + out*in + N*out*in) bytes with the norm off (V
// cancels: V + (W' - V) - frac B UT = W' - frac B UT), and V's
// 4*N*L*out*in more with it on.  At Qwen2-0.5B's w_gate (L=24, 4864x896,
// N=2, k=89), norm off: 37.2 GFLOP on 1.35 GB, 0.404 ms at 3.35 TB/s
// against 0.23 ms for the products at the 3xTF32 rate (495/3 TFLOP/s):
// bound by bytes.  W' is 0.42 GB of those bytes, V' 0.84, B and UT 0.10.
//
// Design.  3xTF32 on the tensor cores (wgmma), on maecho_tf32.cuh's left
// form: a left raw stage is B_li's 128 x 32 tile and UT_li's 32 x 128
// tile (B's rows of k floats take 4-byte copies unless k % 4 == 0), the
// depth the rank, 3 stages at k = 89 (the last 25 deep, masked on load),
// small products first, a fresh accumulator a stage added in fp32.  A
// unit is one (layer, 128 (out) x 128 (in) tile, client).  Its epilogue,
// norm off, stores W' - frac acc, one fmaf a position: V is not read.
// With the norm on it is B16's: u = (W' - V_i) - frac acc and the tile's
// per-row sums of squares, then v_norm_kernel (maecho_tile.cuh) sums each
// row's tile partials in tile order and rescales.
//
// What the design does about the bytes.  A unit moves 128 KiB through its
// epilogue (W' read, V' written) against 3 short stages of products, and
// the 193 KiB of shared memory a CTA of this staging holds allow one CTA
// an SM.  So the grid is persistent, one CTA an SM, CTA b taking units b,
// b + C, ... as one run_stages pipeline walked by a cursor: a unit's
// epilogue runs while the next unit's first products do, with its next
// stages' copies in flight.  Units are ordered (layer, out tile, in tile,
// client), clients fastest, so the CTAs at work at once hold neighbouring
// units: the N units that read one W' tile run side by side and the tile
// comes from HBM once (dealt in runs of consecutive units, the grid had
// lost 30 % to a CTA a unit, on an NVIDIA H100: PERF.md §6).  When a
// unit's first stage is copied in, its W' tile (and V's with the norm
// on) is prefetched into L2, one cp.async.bulk.prefetch a row.  A
// thread's 32 W' loads all issue at once, while the products of the
// unit's last stage run (in two batches of 16 inside the epilogue the
// kernel took 1.84 ms at w_gate, all at once 1.26, on an NVIDIA H100).
// No atomics: V' is bitwise reproducible.
//
// The SIMT body this replaces (maecho_tile.cuh's v_update_kernel on
// StackedLeftOp, one CTA a (layer, client, 32 x 32 tile)) took 4.64 ms at
// w_gate on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

#include "maecho_tile.cuh"
#include "maecho_tf32.cuh"

namespace {
namespace tf32 {

// Stage cursor over the units blockIdx.x, blockIdx.x + C, ... of U in
// (layer, out tile, in tile, client) order, clients fastest; a unit is nk
// stages.  set() divides once a unit (every third stage at k = 89).
struct UnitCursor {
  int u, l, tile, client, step, o0, c0;
  __device__ __forceinline__ void set(int unit, int N, int tiles, int ct) {
    u = unit;
    const int q = u / N;
    client = u - q * N;
    l = q / tiles;
    tile = q - l * tiles;
    step = 0;
    const int by = tile / ct;
    o0 = by * 128;
    c0 = (tile - by * ct) * 128;
  }
  __device__ __forceinline__ void next(int C, int U, int N, int nk, int tiles, int ct) {
    if (++step < nk) return;
    if (u + C < U) set(u + C, N, tiles, ct);
  }
};

// One thread a row prefetches rows o0 .. o0 + 127, columns c0 .. c0 + 127
// of a row-major (out, in) fp32 matrix into L2 (cp.async.bulk.prefetch:
// one instruction a 512-byte row; rows and columns outside the leaf are
// skipped).  Needs in % 4 == 0 and a 16-byte-aligned base.
__device__ __forceinline__ void prefetch_tile(const float* M, int o0, int c0, int out_d,
                                              int in_d, int tid) {
  if (tid >= 128 || o0 + tid >= out_d) return;
  const int bytes = 4 * min(128, in_d - c0);
  const size_t g = __cvta_generic_to_global(M + (size_t)(o0 + tid) * in_d + c0);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(g), "r"(bytes) : "memory");
}

// A thread's 32 positions of a unit's 128 x 128 tile: register pair
// (4 n + 2 ii, + 1) of the accumulator holds row ra + 8 ii, columns
// 8 n + 2 t and + 1; position 16 ii + n below.

// W' at the thread's positions (zero outside the leaf): 32 loads, all in
// flight at once, issued a stage before the epilogue needs them.
template <bool kVec>
__device__ __forceinline__ void load_w(float2 (&w)[32], const float* __restrict__ Wl, int o0,
                                       int c0, int out_d, int in_d) {
  const int tid = threadIdx.x, t = tid % 4, ra = acc_row(tid);
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      const size_t idx = (size_t)o * in_d + c;
      float2& x = w[16 * ii + n];
      x = make_float2(0.f, 0.f);
      if (o >= out_d || c >= in_d) continue;
      if constexpr (kVec) {        // c even and in % 4 == 0: both columns in, 8-byte aligned
        x = __ldg(reinterpret_cast<const float2*>(Wl + idx));
      } else {
        x.x = __ldg(Wl + idx);
        if (c + 1 < in_d) x.y = __ldg(Wl + idx + 1);
      }
    }
  }
}

// The norm-off epilogue: V_i' = V_i + (W' - V_i) - frac acc = W' - frac
// acc, one fmaf a position (a rounding fewer than the plain version's),
// and V is not read: a third of the bytes fewer.
template <bool kVec>
__device__ __forceinline__ void store_update(const float (&acc)[64], const float2 (&w)[32],
                                             float* __restrict__ Oi, int o0, int c0,
                                             int out_d, int in_d, float frac) {
  const int tid = threadIdx.x, t = tid % 4, ra = acc_row(tid);
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (o >= out_d || c >= in_d) continue;
      const size_t idx = (size_t)o * in_d + c;
      const float2 x = w[16 * ii + n];
      const float r0 = fmaf(-frac, acc[4 * n + 2 * ii], x.x),
                  r1 = fmaf(-frac, acc[4 * n + 2 * ii + 1], x.y);
      if constexpr (kVec) {
        *reinterpret_cast<float2*>(Oi + idx) = make_float2(r0, r1);
      } else {
        Oi[idx] = r0;
        if (c + 1 < in_d) Oi[idx + 1] = r1;
      }
    }
  }
}

// The norm-on epilogue, B16's arithmetic: u = (W' - V_i) - frac acc and
// the tile's per-row sums of squares (rowss: this (client, layer)'s (out,
// n_col_tiles)), for v_norm_kernel.  The positions go in four batches of
// 8 whose W' and V loads all issue before any store.
template <bool kVec>
__device__ __forceinline__ void epilogue_norm(const float (&acc)[64],
                                              const float* __restrict__ Wl,
                                              const float* __restrict__ Vi,
                                              float* __restrict__ Oi, float* __restrict__ rowss,
                                              int o0, int c0, int out_d, int in_d, int ct,
                                              float frac) {
  const int tid = threadIdx.x, t = tid % 4, ra = acc_row(tid);
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int o = o0 + ra + 8 * ii;
    float ss = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v[8], w[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + 8 * (8 * h + n) + 2 * t;
        const size_t idx = (size_t)o * in_d + c;
        v[n] = w[n] = make_float2(0.f, 0.f);
        if (o >= out_d || c >= in_d) continue;
        if constexpr (kVec) {
          w[n] = __ldg(reinterpret_cast<const float2*>(Wl + idx));
          v[n] = __ldg(reinterpret_cast<const float2*>(Vi + idx));
        } else {
          w[n].x = __ldg(Wl + idx);
          v[n].x = __ldg(Vi + idx);
          if (c + 1 < in_d) {
            w[n].y = __ldg(Wl + idx + 1);
            v[n].y = __ldg(Vi + idx + 1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = c0 + 8 * (8 * h + n) + 2 * t;
        if (o >= out_d || c >= in_d) continue;
        const size_t idx = (size_t)o * in_d + c;
        const int e = 4 * (8 * h + n) + 2 * ii;
        const float u0 = (w[n].x - v[n].x) - frac * acc[e],
                    u1 = (w[n].y - v[n].y) - frac * acc[e + 1];
        ss = fmaf(u0, u0, ss);
        if constexpr (kVec) {
          ss = fmaf(u1, u1, ss);
          *reinterpret_cast<float2*>(Oi + idx) = make_float2(u0, u1);
        } else {
          Oi[idx] = u0;
          if (c + 1 < in_d) {
            ss = fmaf(u1, u1, ss);
            Oi[idx + 1] = u1;
          }
        }
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (t == 0 && o < out_d) rowss[(size_t)o * ct + c0 / 128] = ss;
  }
}

// The units b, b + C, b + 2 C, ... of U for CTA b of C.  Without norm the
// epilogue stores W' - frac acc; with it, u and the tile's per-row sums of
// squares to rowss (N, L, out, n_col_tiles).
template <bool kVecA, bool kVecB, bool NORM>
__global__ void __launch_bounds__(kThreads, 1)
v_update_left_tf32_kernel(LeftStage<kVecA, kVecB> form, const float* __restrict__ B,
                          const float* __restrict__ UT, const float* __restrict__ W,
                          const float* __restrict__ V, float* __restrict__ out,
                          float* __restrict__ rowss, int N, int L, int out_d, int in_d,
                          float frac, int U, int C) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int ct = tiles128(in_d), tiles = tiles128(out_d) * ct;
  const int nk = (form.rank + kBK - 1) / kBK;
  const size_t OI = (size_t)out_d * in_d;
  const int G = ((U - 1 - (int)blockIdx.x) / C + 1) * nk;

  UnitCursor ld, fin;            // next stage to load; stage being finished
  ld.set(blockIdx.x, N, tiles, ct);
  fin = ld;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float2 w[32];                  // W' at this thread's positions of the unit being finished
  run_stages(
      form, smem, G, out_d, in_d,
      [&](int) {
        const size_t il = (size_t)ld.client * L + ld.l;   // (client, layer) of B, UT, V
        if (kVecB && ld.step == 0) {   // the epilogue's tiles, 3 stages ahead of it
          prefetch_tile(W + ld.l * OI, ld.o0, ld.c0, out_d, in_d, tid);
          if (NORM) prefetch_tile(V + il * OI, ld.o0, ld.c0, out_d, in_d, tid);
        }
        const StageRef r{B + il * ((size_t)out_d * form.rank), nullptr,
                         UT + il * ((size_t)form.rank * in_d), ld.o0, ld.c0, ld.step * kBK};
        ld.next(C, U, N, nk, tiles, ct);
        return r;
      },
      [&](int, float(&part)[64]) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];
      },
      [&](int) {
        // Without the norm, W' comes into registers after the products of
        // the unit's last stage are issued, a stage before its epilogue.
        if (!NORM && fin.step == (nk > 1 ? nk - 2 : 0))
          load_w<kVecB>(w, W + fin.l * OI, fin.o0, fin.c0, out_d, in_d);
        if (fin.step == nk - 1) {    // the unit's last stage: its epilogue
          const size_t il = (size_t)fin.client * L + fin.l;
          if (NORM)
            epilogue_norm<kVecB>(acc, W + fin.l * OI, V + il * OI, out + il * OI,
                                 rowss + il * out_d * ct, fin.o0, fin.c0, out_d, in_d, ct,
                                 frac);
          else
            store_update<kVecB>(acc, w, out + il * OI, fin.o0, fin.c0, out_d, in_d, frac);
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] = 0.f;
        }
        fin.next(C, U, N, nk, tiles, ct);
      });
}

template <bool kVecA, bool kVecB>
int v_update_left_run(int rank, const float* B, const float* UT, const float* W,
                      const float* V, float* out, float* rowss, int N, int L, int out_d,
                      int in_d, float frac, int norm, int U, int C, cudaStream_t s) {
  using F = LeftStage<kVecA, kVecB>;
  auto kernel = norm ? v_update_left_tf32_kernel<kVecA, kVecB, true>
                     : v_update_left_tf32_kernel<kVecA, kVecB, false>;
  constexpr int smem = smem_of<F>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, kThreads, smem, s>>>(F{rank}, B, UT, W, V, out, rowss, N, L, out_d, in_d, frac,
                                   U, C);
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace

extern "C" {

// Floats of workspace a launch needs: per-row, per-128-column-tile sums of
// squares when norm is on, none otherwise.
long long maecho_v_update_factored_stacked_workspace_floats(int N, int L, int out_d,
                                                            int in_d, int norm) {
  return norm ? (long long)N * L * out_d * tf32::tiles128(in_d) : 0;
}

int maecho_v_update_factored_stacked_launch(const void* B, const void* UT,
                                            const void* W, const void* V, void* out,
                                            void* workspace, int N, int L, int out_d,
                                            int in_d, int rank, float frac, int norm,
                                            float eps, void* stream) {
  using namespace tf32;
  const long long rows = (long long)N * L * out_d;
  const long long U = rows / out_d * tiles128(out_d) * tiles128(in_d);
  if (N < 1 || L < 1 || out_d < 1 || in_d < 1 || rank < 1 || rows > 0x7fffffffLL ||
      U * ((rank + kBK - 1) / kBK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    return (int)cudaErrorInvalidDevice;
  const int C = (int)(U < sms ? U : sms), Ui = (int)U;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *b = static_cast<const float*>(B), *ut = static_cast<const float*>(UT),
              *w = static_cast<const float*>(W), *v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  const bool va = rows_vec_ok(rank, B);
  const bool vb = rows_vec_ok(in_d, UT) && vec_ok(in_d, W, V, out);
  const int err =
      va ? (vb ? v_update_left_run<true, true>(rank, b, ut, w, v, o, ws, N, L, out_d, in_d,
                                               frac, norm, Ui, C, s)
               : v_update_left_run<true, false>(rank, b, ut, w, v, o, ws, N, L, out_d, in_d,
                                                frac, norm, Ui, C, s))
         : (vb ? v_update_left_run<false, true>(rank, b, ut, w, v, o, ws, N, L, out_d, in_d,
                                                frac, norm, Ui, C, s)
               : v_update_left_run<false, false>(rank, b, ut, w, v, o, ws, N, L, out_d, in_d,
                                                 frac, norm, Ui, C, s));
  if (err != 0 || !norm) return err;
  v_norm_kernel<<<(unsigned)rows, 256, 0, s>>>(v, o, ws, in_d, tiles128(in_d), eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
