// 3xTF32 tensor-core machinery of the MA-Echo kernels for Hopper
// (sm_90a): B10 (Eq. 6 Gram, maecho_gram_stacked.cu), B13 (Eq. 7,
// maecho_update_stacked.cu) and B16 (Eq. 11, maecho_v_update_stacked.cu),
// and through maecho_splitk.cuh B1 and B4 (maecho_gram.cu,
// maecho_update.cu), which split a leaf's stage sequence into shares; in
// its left form (below) B2 (maecho_gram_left.cu, through
// maecho_splitk.cuh) and B17 (maecho_v_update_factored_stacked.cu).
//
// Each forms residual tiles R_i = (W_l - V_il) P_il of 128 (out) x 128 (in)
// with fp32 accuracy on the tensor cores.  A CTA is two consumer warpgroups
// (256 threads); warpgroup w owns out rows 64 w .. 64 w + 63 of the tile.
// The depth (in) runs in stages of 32 fp32 columns (128 bytes, one
// 128-byte swizzle row).  A raw stage holds the W and V_i tiles (128 x 32,
// 16-byte chunks swizzled by row) and the P_i tile (32 x 128), copied by
// 16-byte cp.async (4-byte copies when in % 4 != 0 or a base is not
// 16-byte aligned; the kVec flag) two stages ahead.  The 256 threads split
// a raw stage into a set of four K-major, 128-byte-swizzled planes:
//   - A = D = W - V_i, subtracted in fp32 as the plain versions do, split
//     into hi = tf32_rna(d) and lo = tf32_rna(d - hi) (cvt.rna.tf32.f32);
//   - B = P_i^T, hi and lo the same way.  TF32 wgmma takes only K-major
//     operands (the transpose bits exist for f16/bf16 only) and P_i is
//     row-major, i.e. MN-major for D P: the threads read the staged tile
//     column by column and write its transpose.  P_i's symmetry is not
//     used: block-RLS projectors are symmetric only to ~3e-5.
// Three products a k8 step, hi.hi, hi.lo and lo.hi, in a fixed order (see
// below), by wgmma.mma_async m64n128k8.f32.tf32.tf32 with both operands from
// shared memory (lo.lo, ~2^-22 relative, is dropped).  Two plane sets:
// stage s + 1 is split while stage s's products run.  The tensor cores'
// accumulation truncates, so each stage's 12 products sum into a fresh
// accumulator (`part`) that the kernel then adds to its running sums in
// fp32 (summed over the whole depth, the truncation's bias had made B16's
// error 5x the plain fp32 version's at in = 896).  Ragged out, in and
// depth are masked on load (zero, exact); offsets are 64-bit.
//
// Accumulator register 4 n + 2 i + j of thread tid holds row
// ra + 8 i, column 8 n + 2 t + j of the tile, with t = tid % 4 and
// ra = 64 (tid / 128) + 16 ((tid / 32) % 4) + (tid % 32) / 4.
//
// B16 runs its own loop over one client's depth (stage_mma: each k8 step's
// hi.hi, hi.lo, lo.hi in turn); B10 and B13 run run_stages, the same
// pipeline over a sequence of (tile, client, depth) stages, with the small
// products first (stage_mma_small_first).
//
// The left form (LeftStage) takes the factored kernels' product A_i UT_i,
// depth k, the projector's rank: A_i (out, k) is the compressed residual,
// UT_i (k, in) = U_i^T.  A left raw stage is two tiles (32 KiB): the A
// tile (128 x 32, swizzled as W's) and the UT tile (32 x 128, plain as
// P's).  Its split takes A whole (no subtraction) and transposes UT as it
// does P (UT is row-major with in contiguous: MN-major).  A's rows are k
// floats, 78 or 89 on the main paths, so not 16-byte aligned: A and UT
// choose their copy width apart (kVecA: k % 4 == 0; kVecB: in % 4 == 0;
// each with aligned bases).  The last stage of a depth of k is short and
// masked on load like a ragged in.  The dense form (DenseStage) is the
// stage above, unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tf32 {

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBK = 32;                  // depth a stage
constexpr int kTile = 128 * kBK * 4;     // bytes of a 128 x 32 fp32 tile
constexpr int kRawBytes = 3 * kTile;     // a staged W, V_i, P_i
constexpr int kPlaneBytes = 4 * kTile;   // A hi, A lo, B hi, B lo
// two raw stages, two sets of split planes, 1 KiB to align
constexpr int kSmem = 2 * kRawBytes + 2 * kPlaneBytes + 1024;
constexpr int kLeftRawBytes = 2 * kTile;   // a staged A_i, UT_i (the left form)

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

// 1024-byte-aligned base of the dynamic shared memory (the swizzle's atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Stage k0 .. k0 + 31 of the depth: W[o0.., k0..] and V_i[o0.., k0..]
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

// The B operand of a raw stage, a plain 32 x 128 tile (P_i or UT_i), into
// planes 2 and 3 of a set as its transpose's hi / lo (K-major, row c = 128
// bytes of 32 k values, swizzled as the A planes).
__device__ __forceinline__ void split_b_transposed(const float* Bst, unsigned char* planes,
                                                   int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int e = tid + it * kThreads, c = e & 127, kq = e >> 7;
    uint32_t h[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(Bst[(4 * kq + j) * 128 + c], h[j], lo[j]);
    const int off = c * 128 + ((kq ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(planes + 2 * kTile + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(planes + 3 * kTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One raw stage into a set of split planes: A = W - V_i as hi / lo
// (K-major, the raw tiles' swizzle), B = P_i^T as hi / lo.
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
  split_b_transposed(reinterpret_cast<const float*>(raw + 2 * kTile), planes, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
}

// The left form's stage k0 .. k0 + 31 of the depth (the rank): A_i[o0..,
// k0..] (rows of depth floats) into a swizzled 128 x 32 tile, UT_i[k0..,
// c0..] into a plain 32 x 128 tile after it; zero outside the leaf and
// past the depth.  kVecA: depth % 4 == 0, so an A chunk is in or out
// whole; kVecB: in % 4 == 0, the same for UT.
template <bool kVecA, bool kVecB>
__device__ __forceinline__ void load_left_stage(unsigned char* st, const float* Ai,
                                                const float* UTi, int o0, int c0, int k0,
                                                int out_d, int in_d, int depth, int tid) {
  const uint32_t base = smem_u32(st);
  if constexpr (kVecA) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * kThreads, r = e >> 3, c = e & 7;
      const int o = o0 + r, k = k0 + 4 * c;
      const bool in = o < out_d && k < depth;
      cp16(base + r * 128 + ((c ^ (r & 7)) << 4), Ai + (in ? (size_t)o * depth + k : 0),
           in ? 16 : 0);
    }
  } else {                       // a warp copies one row's 32 floats: 128 coalesced bytes
    for (int e = tid; e < 128 * kBK; e += kThreads) {
      const int r = e >> 5, k = e & 31;
      const int o = o0 + r, kk = k0 + k;
      const bool in = o < out_d && kk < depth;
      cp4(base + sw(r, k), Ai + (in ? (size_t)o * depth + kk : 0), in ? 4 : 0);
    }
  }
  if constexpr (kVecB) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * kThreads, r = e >> 5, c = e & 31;
      const int kr = k0 + r, cc = c0 + 4 * c;
      const bool in = kr < depth && cc < in_d;
      cp16(base + kTile + r * 512 + c * 16, UTi + (in ? (size_t)kr * in_d + cc : 0),
           in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kBK * 128; e += kThreads) {
      const int r = e >> 7, c = e & 127;
      const int kr = k0 + r, cc = c0 + c;
      const bool in = kr < depth && cc < in_d;
      cp4(base + kTile + r * 512 + c * 4, UTi + (in ? (size_t)kr * in_d + cc : 0),
          in ? 4 : 0);
    }
  }
}

// A left raw stage into a set of split planes: A_i whole as hi / lo, B =
// UT_i^T as hi / lo.
__device__ __forceinline__ void split_left_stage(const unsigned char* raw,
                                                 unsigned char* planes, int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int e = tid + it * kThreads, r = e >> 3, c = e & 7;
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    const float4 a = *reinterpret_cast<const float4*>(raw + off);
    uint32_t h[4], lo[4];
    split(a.x, h[0], lo[0]);
    split(a.y, h[1], lo[1]);
    split(a.z, h[2], lo[2]);
    split(a.w, h[3], lo[3]);
    *reinterpret_cast<uint4*>(planes + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(planes + kTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  split_b_transposed(reinterpret_cast<const float*>(raw + kTile), planes, tid);
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

// The same 12 products with the small ones first: hi.lo and lo.hi of the
// four k8 steps, then the four hi.hi.  The tensor cores truncate each
// instruction's sum; in this order only the four hi.hi land on a sum of
// the part's full magnitude (twelve in stage_mma's), which cuts the bias
// toward zero that a Gram's diagonal sums coherently (B10 at wq, x1e3
// inputs: 7.5e-4 -> 2.9e-4 of 1.0e3 against float64, on an NVIDIA H100).
__device__ __forceinline__ void stage_mma_small_first(float (&part)[64], uint32_t planes,
                                                      int wg) {
  const uint32_t ahi = planes + wg * 64 * 128, alo = ahi + kTile;
  const uint32_t bhi = planes + 2 * kTile, blo = planes + 3 * kTile;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma(part, sw128_desc(ahi + kk * 32), sw128_desc(blo + kk * 32), kk > 0);
    mma(part, sw128_desc(alo + kk * 32), sw128_desc(bhi + kk * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma(part, sw128_desc(ahi + kk * 32), sw128_desc(bhi + kk * 32), 1);
  wg_commit();
}

// One stage of a sequence: the 32-deep slice k0 .. k0 + 31 of
// (W_l - V_il) P_il for the output tile at (o0, c0); in the left form of
// A_i UT_i (W = A_i, P = UT_i, V unused).
struct StageRef {
  const float* W;              // layer l of W
  const float* V;              // V_il
  const float* P;              // P_il
  int o0, c0, k0;
};

// The operand forms of a stage: what a raw stage holds (kRaw bytes), how
// it is copied in and split, the depth, and stage (client, o0, c0, k0) of
// a leaf's operands (W, V, P; the left form's A, -, UT).
template <bool kVec>
struct DenseStage {
  static constexpr int kRaw = kRawBytes;
  __host__ __device__ int depth(int in_d) const { return in_d; }
  __device__ __forceinline__ StageRef ref(const float* W, const float* V, const float* P,
                                          int client, int o0, int c0, int k0, int out_d,
                                          int in_d) const {
    return StageRef{W, V + client * ((size_t)out_d * in_d), P + client * ((size_t)in_d * in_d),
                    o0, c0, k0};
  }
  __device__ __forceinline__ void load(unsigned char* st, const StageRef& s, int out_d,
                                       int in_d, int tid) const {
    load_stage<kVec>(st, s.W, s.V, s.P, s.o0, s.c0, s.k0, out_d, in_d, tid);
  }
  __device__ __forceinline__ void split(const unsigned char* raw, unsigned char* planes,
                                        int tid) const {
    split_stage(raw, planes, tid);
  }
};

template <bool kVecA, bool kVecB>
struct LeftStage {
  static constexpr int kRaw = kLeftRawBytes;
  int rank;                    // the depth
  __host__ __device__ int depth(int) const { return rank; }
  __device__ __forceinline__ StageRef ref(const float* A, const float*, const float* UT,
                                          int client, int o0, int c0, int k0, int out_d,
                                          int in_d) const {
    return StageRef{A + client * ((size_t)out_d * rank), nullptr,
                    UT + client * ((size_t)rank * in_d), o0, c0, k0};
  }
  __device__ __forceinline__ void load(unsigned char* st, const StageRef& s, int out_d,
                                       int in_d, int tid) const {
    load_left_stage<kVecA, kVecB>(st, s.W, s.P, s.o0, s.c0, s.k0, out_d, in_d, rank, tid);
  }
  __device__ __forceinline__ void split(const unsigned char* raw, unsigned char* planes,
                                        int tid) const {
    split_left_stage(raw, planes, tid);
  }
};

// Dynamic shared memory of a run_stages kernel on form F: two raw stages,
// two plane sets, 1 KiB to align (kSmem for the dense form).
template <class F>
constexpr int smem_of() {
  return 2 * F::kRaw + 2 * kPlaneBytes + 1024;
}

// B16's pipeline over a sequence of G >= 1 stages, at(g) naming stage g,
// with the products small first (stage_mma_small_first): raw stage g + 1
// is split into plane set (g + 1) % 2 while the products of stage g run
// on set g % 2; once stage g's products have landed in part,
// consume(g, part) adds them to the caller's sums, stage g + 1's products
// are issued, and after(g) runs while they do (a client's or a tile's
// epilogue: it must not touch part).  Raw stage g + 3 is copied into the
// slot stage g + 1 leaves.  at, consume and after are each called for
// g = 0, 1, ..., G - 1 in that order, so a caller may walk its stages
// with cursors: integer division there sits on the path between the
// barriers (B10 with five divisions a stage took 6.40 ms at w_gate, with
// cursors 5.47 ms, on an NVIDIA H100).  Every thread of the CTA calls
// this alike.  The stages are of form F (DenseStage, LeftStage).
template <class F, class At, class Consume, class After>
__device__ __forceinline__ void run_stages(const F& form, unsigned char* smem, int G, int out_d,
                                           int in_d, At at, Consume consume, After after) {
  const int tid = threadIdx.x, wg = tid / 128;
  unsigned char* planes = smem + 2 * F::kRaw;   // two sets, kPlaneBytes apart
  const uint32_t planes0 = smem_u32(planes);
  auto load = [&](int g) { form.load(smem + (g % 2) * F::kRaw, at(g), out_d, in_d, tid); };
  for (int r = 0; r < 3; ++r) {
    if (r < G) load(r);
    cp_commit();
    if (r == 1) {                // raw 0 has landed: split it, free its slot
      cp_wait<1>();
      __syncthreads();
      form.split(smem, planes, tid);
      __syncthreads();
    }
  }
  float part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) part[e] = 0.f;
  pin(part);
  stage_mma_small_first(part, planes0, wg);

  for (int g = 0; g < G; ++g) {
    const int gn = g + 1;
    if (gn < G) {
      cp_wait<1>();              // raw gn has landed, for this thread's copies
      __syncthreads();           // ... and everyone's
      form.split(smem + (gn % 2) * F::kRaw, planes + (gn % 2) * kPlaneBytes, tid);
      __syncthreads();           // raw slot gn % 2 is spent; plane set gn % 2 is ready
      if (gn + 2 < G) load(gn + 2);
      cp_commit();
    }
    wg_wait0();
    pin(part);
    consume(g, part);
    if (gn < G) stage_mma_small_first(part, planes0 + (gn % 2) * kPlaneBytes, wg);
    after(g);
  }
}

// A share of a run_stages sequence (B1, B4: maecho_splitk.cuh).  The
// (tile, client, depth step) stages of an unstacked leaf, T of them, are
// cut into C equal shares (stream-K): CTA c takes stages share_begin(c)
// .. share_begin(c + 1) - 1, and cta_of(x) is the CTA whose share holds
// stage x.  Stage g is depth step g % nk of client (g / nk) % N on tile
// g / (nk N), tiles in (out tile, in tile) order.  A cursor is set once
// at a share's first stage (its only divisions) and then walks the share
// a stage at a time, refreshing the tile's coordinates once a tile, as
// B10's and B13's own cursors do.
__host__ __device__ inline long long share_begin(long long c, long long T, int C) {
  return c * T / C;
}
__host__ __device__ inline int cta_of(long long x, long long T, int C) {
  return (int)(((x + 1) * C - 1) / T);
}

struct StageCursor {
  int tile, client, step, o0, c0;
  __device__ __forceinline__ void coords(int ct) {
    const int by = tile / ct;
    o0 = by * 128;
    c0 = (tile - by * ct) * 128;
  }
  __device__ __forceinline__ void set(long long g, int N, int nk, int ct) {
    const long long q = g / nk;
    step = (int)(g - q * nk);
    tile = (int)(q / N);
    client = (int)(q - (long long)tile * N);
    coords(ct);
  }
  __device__ __forceinline__ void next(int N, int nk, int ct) {
    if (++step < nk) return;
    step = 0;
    if (++client < N) return;
    client = 0;
    ++tile;
    coords(ct);
  }
};

// Row of the accumulator register pair (4 n + 2 i + j) for thread tid: ra
// (i = 0) and ra + 8 (i = 1).
__device__ __forceinline__ int acc_row(int tid) {
  return (tid / 128) * 64 + ((tid / 32) % 4) * 16 + (tid % 32) / 4;
}

__host__ __device__ inline int tiles128(int d) { return (d + 127) / 128; }

// 16-byte copies need in % 4 == 0 and 16-byte-aligned bases
inline bool vec_ok(int in_d, const void* W, const void* V, const void* P) {
  return in_d % 4 == 0 && ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(V) |
                            reinterpret_cast<uintptr_t>(P)) % 16 == 0);
}

// Rows of d floats at a 16-byte-aligned base (a left operand's kVecA, kVecB)
inline bool rows_vec_ok(int d, const void* base) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

}  // namespace tf32
}  // namespace
