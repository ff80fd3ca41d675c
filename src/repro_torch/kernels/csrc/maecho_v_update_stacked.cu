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
// Design: 3xTF32 on the tensor cores (wgmma).  One CTA of two consumer
// warpgroups per (layer, client, 128 (out) x 128 (in) output tile),
// blockIdx.z = l*N + i (N*L <= 65535); warpgroup w owns out rows
// 64 w .. 64 w + 63.  The depth (in) runs in stages of 32 fp32 columns
// (128 bytes, one 128-byte swizzle row).  A raw stage holds the W' and V_i
// tiles (128 x 32, 16-byte chunks swizzled by row) and the P_i tile
// (32 x 128), copied by 16-byte cp.async (4-byte copies when in % 4 != 0
// or a base is not 16-byte aligned; a template flag) two stages ahead.
// The 256 threads split a raw stage into a set of four K-major,
// 128-byte-swizzled planes:
//   - A = D = W' - V_i, subtracted in fp32 as the plain version, split
//     into hi = tf32_rna(d) and lo = tf32_rna(d - hi) (cvt.rna.tf32.f32);
//   - B = P_i^T, hi and lo the same way.  TF32 wgmma takes only K-major
//     operands (the transpose bits exist for f16/bf16 only) and P_i is
//     row-major, i.e. MN-major for D P: the threads read the staged tile
//     column by column and write its transpose.  P_i's symmetry is not
//     used: block-RLS projectors are symmetric only to ~3e-5.
// Three products a k8 step, hi.hi, hi.lo and lo.hi, in that fixed order,
// by wgmma.mma_async m64n128k8.f32.tf32.tf32 with both operands from
// shared memory (lo.lo, ~2^-22 relative, is dropped).  Two plane sets:
// stage s + 1 is split while stage s's products run.  The tensor cores'
// accumulation truncates, so each stage's 12 products sum into a fresh
// accumulator that is then added to the running one in fp32 (summed over
// the whole depth, the truncation's bias had made the error 5x the plain
// fp32 version's at in = 896).  No atomics: the result is bitwise
// reproducible.
// Epilogue: u = (W' - V_i) - frac * acc, then V_i + u; with the norm on,
// u and the tile's per-row sums of squares, and the second pass
// v_norm_kernel (maecho_tile.cuh) sums each row's tile partials in tile
// order and rescales.  Ragged out, in and depth are masked on load (zero,
// exact) and on store; offsets are 64-bit.  The SIMT template of B7/B10/
// B13 (residual_tile) is not used here.
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

#include <stdint.h>

namespace {
namespace tf32 {

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBK = 32;                  // depth a stage
constexpr int kTile = 128 * kBK * 4;     // bytes of a 128 x 32 fp32 tile
constexpr int kRawBytes = 3 * kTile;     // a staged W', V_i, P_i
constexpr int kPlaneBytes = 4 * kTile;   // A hi, A lo, B hi, B lo
// two raw stages, two sets of split planes, 1 KiB to align
constexpr int kSmem = 2 * kRawBytes + 2 * kPlaneBytes + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-22 |x|), hi and lo tf32 (low 13 bits zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define TF_D64(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TF_R64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A.B, m64n128k8 tf32, A and B K-major in shared memory; acc = 0
// overwrites d
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF_R64
      ", %64, %65, p, 1, 1;\n}\n"
      : TF_D64(d)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of (row r, column k) in a 128 x 32 fp32 tile: 16-byte chunk
// k / 4 of row r at (k / 4 ^ r % 8) * 16, the 128-byte swizzle
__device__ __forceinline__ int sw(int r, int k) {
  return r * 128 + ((((k >> 2) ^ (r & 7))) << 4) + (k & 3) * 4;
}

// Stage k0 .. k0 + 31 of the depth: W'[o0.., k0..] and V_i[o0.., k0..]
// into two swizzled 128 x 32 tiles, P_i[k0.., c0..] into a plain 32 x 128
// tile; zero outside the leaf.
template <bool kVec>
__device__ __forceinline__ void load_stage(unsigned char* st, const float* Wl, const float* Vi,
                                           const float* Pi, int o0, int c0, int k0, int out_d,
                                           int in_d, int tid) {
  const uint32_t base = smem_u32(st);
  if constexpr (kVec) {          // in % 4 == 0: a chunk is in or out whole
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * kThreads, r = e >> 3, c = e & 7;
      const int o = o0 + r, k = k0 + 4 * c;
      const bool in = o < out_d && k < in_d;
      const size_t idx = in ? (size_t)o * in_d + k : 0;
      const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
      cp16(base + off, Wl + idx, in ? 16 : 0);
      cp16(base + kTile + off, Vi + idx, in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * kThreads, r = e >> 5, c = e & 31;
      const int kr = k0 + r, cc = c0 + 4 * c;
      const bool in = kr < in_d && cc < in_d;
      cp16(base + 2 * kTile + r * 512 + c * 16, Pi + (in ? (size_t)kr * in_d + cc : 0),
           in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < 128 * kBK; e += kThreads) {
      const int r = e >> 5, k = e & 31;
      const int o = o0 + r, kk = k0 + k;
      const bool in = o < out_d && kk < in_d;
      const size_t idx = in ? (size_t)o * in_d + kk : 0;
      cp4(base + sw(r, k), Wl + idx, in ? 4 : 0);
      cp4(base + kTile + sw(r, k), Vi + idx, in ? 4 : 0);
    }
    for (int e = tid; e < kBK * 128; e += kThreads) {
      const int r = e >> 7, c = e & 127;
      const int kr = k0 + r, cc = c0 + c;
      const bool in = kr < in_d && cc < in_d;
      cp4(base + 2 * kTile + r * 512 + c * 4, Pi + (in ? (size_t)kr * in_d + cc : 0),
          in ? 4 : 0);
    }
  }
}

// One raw stage into a set of split planes: A = W' - V_i as hi / lo
// (K-major, the raw tiles' swizzle), B = P_i^T as hi / lo (K-major, row c
// = 128 bytes of 32 k values, swizzled the same way).
__device__ __forceinline__ void split_stage(const unsigned char* raw, unsigned char* planes,
                                            int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int e = tid + it * kThreads, r = e >> 3, c = e & 7;
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    const float4 w = *reinterpret_cast<const float4*>(raw + off);
    const float4 v = *reinterpret_cast<const float4*>(raw + kTile + off);
    uint32_t h[4], lo[4];
    split(w.x - v.x, h[0], lo[0]);
    split(w.y - v.y, h[1], lo[1]);
    split(w.z - v.z, h[2], lo[2]);
    split(w.w - v.w, h[3], lo[3]);
    *reinterpret_cast<uint4*>(planes + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(planes + kTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  const float* Pst = reinterpret_cast<const float*>(raw + 2 * kTile);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int e = tid + it * kThreads, c = e & 127, kq = e >> 7;
    uint32_t h[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(Pst[(4 * kq + j) * 128 + c], h[j], lo[j]);
    const int off = c * 128 + ((kq ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(planes + 2 * kTile + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(planes + 3 * kTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
}

// The stage's 12 products into part, overwriting it: for each k8 step
// hi.hi, hi.lo, lo.hi, in that order; warpgroup wg takes A rows 64 wg ..
__device__ __forceinline__ void stage_mma(float (&part)[64], uint32_t planes, int wg) {
  const uint32_t ahi = planes + wg * 64 * 128, alo = ahi + kTile;
  const uint32_t bhi = planes + 2 * kTile, blo = planes + 3 * kTile;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = sw128_desc(ahi + kk * 32), al = sw128_desc(alo + kk * 32);
    const uint64_t bh = sw128_desc(bhi + kk * 32), bl = sw128_desc(blo + kk * 32);
    mma(part, ah, bh, kk > 0);
    mma(part, ah, bl, 1);
    mma(part, al, bh, 1);
  }
  wg_commit();
}

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

inline int col_tiles(int in_d) { return (in_d + 127) / 128; }

}  // namespace tf32
}  // namespace

extern "C" {

// Floats of workspace a launch needs: per-row, per-128-column-tile sums of
// squares when norm is on, none otherwise.
long long maecho_v_update_stacked_workspace_floats(int N, int L, int out_d, int in_d,
                                                   int norm) {
  return norm ? (long long)N * L * out_d * tf32::col_tiles(in_d) : 0;
}

int maecho_v_update_stacked_launch(const void* W, const void* V, const void* P, void* out,
                                   void* workspace, int N, int L, int out_d, int in_d,
                                   float frac, int norm, float eps, void* stream) {
  using namespace tf32;
  const long long rows = (long long)N * L * out_d;
  if (N < 1 || L < 1 || (long long)N * L > 65535 || out_d < 1 || in_d < 1 ||
      (out_d + 127) / 128 > 65535 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(col_tiles(in_d), (out_d + 127) / 128, N * L);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* p = static_cast<const float*>(P);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  // 16-byte copies need in % 4 == 0 and 16-byte-aligned bases
  const bool vec = in_d % 4 == 0 && ((reinterpret_cast<uintptr_t>(W) |
                                      reinterpret_cast<uintptr_t>(V) |
                                      reinterpret_cast<uintptr_t>(P)) % 16 == 0);
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
