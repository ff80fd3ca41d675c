// B21 — causal / non-causal GQA flash attention (forward only) for Hopper
// (sm_90a):
//     o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / group] * D^-1/2) v[b, t, h / group]
// for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) in float32 or bfloat16,
// every score and sum in fp32, the output in q's dtype.  Causal: key t is
// masked for query row s when t > s, with the reference's NEG_INF =
// -1e30; the sum l is clamped at 1e-30 before the division.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:76
// (`flash_attention`, pl.pallas_call at :103, body `_kernel`), whose grid
// (B, Hq, n_q, n_k) carries the online-softmax state (m, l, acc) in VMEM
// across the innermost kv axis and skips (pl.when) the kv blocks strictly
// after a causal q block.  The reference has no backward kernel, so this
// port has none either.
//
// Common design.  Hopper runs blocks in no order, so the carried kv axis
// becomes a loop inside the block: one CTA per (64-row q block, q head,
// batch row) walks the kv axis in 64-row tiles, and under the causal mask
// stops at the q block's last row, so the tiles after it are never loaded
// (the reference's skip).  The kv head is h / group, as the reference's
// index map; the k / v re-reads of a group's heads hit the 50 MB L2 (one
// (b, kv head) slice is 128 KB at S = 512 in bf16).  q, k and v are read
// in their (B, S, H, D) layout through the strides they come with (head
// dim contiguous), so the reference's transposes have no counterpart;
// ragged S (rows past Sq or Sk) and D <= 128 (zero-filled to 64 or 128)
// are masked in the kernel, so nothing is padded in device memory.  No
// atomics: the output is bitwise reproducible.  Each dtype has exactly
// one kernel, chosen in flash_attention_launch.
//
// bfloat16 (the serving dtype): the bf16 tensor cores, exactly.  One
// warpgroup (128 threads) per CTA; the q tile is loaded once and the k / v
// tiles are double-buffered by 16-byte cp.async (zero-filling rows past Sk
// and columns past D) into shared memory in the 128-byte-swizzled layout
// that wgmma's descriptors read; the heavy causal q blocks launch first.
//   - S = Q.K^T: wgmma m64n64k16 with A (q) and B (k) from shared memory,
//     both K-major, D / 16 k-steps.  bf16 x bf16 products are exact in
//     fp32 and the tensor cores sum them in fp32: the reference's q.k^T of
//     the upcast operands.
//   - Online softmax on the accumulator fragments in registers: each
//     thread holds two rows, whose max and sum reduce over the 4 lanes
//     that share them; masked scores (only on a causal diagonal tile and
//     the ragged last tile) leave the max and get p = 0.
//   - O += P.V: A = P from registers (the m64n64 f32 accumulator layout is
//     the bf16 A-fragment layout, so p is converted in place), B = V from
//     shared memory, MN-major (the transpose bit).  p stays the
//     reference's fp32 p: it is split into three bf16 terms
//     p = hi + mid + lo, each the top 8 significant bits of what is left
//     (exact for p >= 2^-100, whose 24 significant bits the three take 8
//     at a time), one wgmma each into the same fp32 accumulator, and v is
//     exact in bf16.
//   - Epilogue: divide by max(l, 1e-30), store bf16, rows < Sq, cols < D.
// When a base pointer or a stride is not 16-byte aligned the tiles are
// copied element by element into the same layout (a template flag).
//
// float32 (the exactness paths: fp32 "kernel" serving and the CLI's
// --check-parity): a SIMT fp32 body.  fp32 operands are not exact on the
// tensor cores (TF32 keeps 10 bits); this body keeps every product a
// plain fp32 FMA, within 2e-5 of the plain version, and is not on the
// bf16 serving path.  One CTA of 256 threads per (q block, head, batch);
// the q tile and each k / v tile are staged in shared memory as fp32 (rows
// padded to a 16-byte multiple, so each thread reads 4 dims with one
// 16-byte load and the 16 rows a warp reads land in distinct banks).
// Thread (ty, tx) owns score rows ty + 16 m and columns tx + 16 n
// (m, n < 4); the row max and row sum reduce over the 16 lanes of a row
// with shuffles, m and l stay in registers, p goes through shared memory
// to the p.v product, where the thread owns output columns 64 g + 4 tx + j.
//
// Bound.  Causal at (B, S, Hq, Hkv, D) = (8, 512, 14, 2, 64): the least
// work is the unmasked half of q.k^T and p.v, 4 B Hq D S (S + 1) / 2
// ~ 3.77 GFLOP, against ~16.8 MB of q, k, v and o in bf16 (0.005 ms at
// 3.35 TB/s).  The fastest exact rate for bf16 operands is the one this
// kernel runs at: q.k^T on the bf16 tensor cores (989 TFLOP/s) and p.v as
// three bf16 products (a third of that), so the bound is ~0.0076 ms, by
// operations.  The kernel also computes the masked upper half of each
// causal diagonal tile, and each CTA runs its load -> S -> softmax -> P.V
// steps in series (no producer warp, no overlap of one tile's softmax with
// the next tile's products inside a CTA: the SM interleaves its resident
// CTAs instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // kv rows per tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLP = kBK + 4;     // row stride of the p tile

template <int KD>
constexpr int smem_bytes() {
  return (3 * kBQ * (KD + 4) + kBQ * kLP) * (int)sizeof(float);
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                       int Hq, int group, int D, int causal, float scale, long long qb,
                       long long qs, long long qh, long long kb, long long ks, long long kh,
                       long long vb, long long vs, long long vh) {
  constexpr int LD = KD + 4;     // row stride of the q / k / v tiles
  constexpr int NG = KD / 64;    // groups of 64 output columns
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const float* qp = q + b * qb + h * qh;
  const float* kp = k + b * kb + hk * kh;
  const float* vp = v + b * vb + hk * vh;

  for (int e = tid; e < kBQ * KD; e += kThreads) {
    const int r = e / KD, c = e % KD;
    sQ[r * LD + c] = (q0 + r < Sq && c < D) ? qp[(q0 + r) * qs + c] : 0.f;
  }
  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }

  // under the causal mask no key after the q block's last row is needed
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();             // the previous tile's readers are done
    for (int e = tid; e < kBK * KD; e += kThreads) {
      const int r = e / KD, c = e % KD;
      const bool in = k0 + r < Sk && c < D;
      sK[r * LD + c] = in ? kp[(k0 + r) * ks + c] : 0.f;
      sV[r * LD + c] = in ? vp[(k0 + r) * vs + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[i][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < KD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        c[n] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * n) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          s[i][n] = fmaf(a[i].x, c[n].x, s[i][n]);
          s[i][n] = fmaf(a[i].y, c[n].y, s[i][n]);
          s[i][n] = fmaf(a[i].z, c[n].z, s[i][n]);
          s[i][n] = fmaf(a[i].w, c[n].w, s[i][n]);
        }
    }

    // online softmax over this tile; the 16 lanes of a row share m and l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = k0 + tx + 16 * n;
        ok[n] = col < Sk && (!causal || col <= row);
        s[i][n] = ok[n] ? s[i][n] * scale : kNegInf;
        mx = fmaxf(mx, s[i][n]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float p = ok[n] ? expf(s[i][n] - m_new) : 0.f;
        sP[(ty + 16 * i) * kLP + tx + 16 * n] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p v (rows of v past Sk are zero, and so is p there)
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * kLP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[4 * NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(&sV[(c + cc) * LD + 64 * g + 4 * tx]);
          vv[4 * g] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int j = 0; j < 4 * NG; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 64 * g + 4 * tx + j;
        if (col < D) orow[col] = acc[i][4 * g + j] / den;
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWThreads = 128;   // one warpgroup
constexpr int kAtom = kBQ * 128;  // bytes of one 64-row x 64-column bf16 swizzle column

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define FA_D32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FA_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A.B^T, m64n64k16, A and B K-major in shared memory; acc = 0
// overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d += A.B, m64n64k16, A (four bf16x2 registers a thread) from registers,
// B MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses to wgmma registers across the
// asynchronous region
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// p = hi + mid + lo, each term the top 8 significant bits (a truncation to
// bf16) of what is left; exact for p >= 2^-100, whose 24 significant bits
// the three terms take 8 at a time.  Returns the terms' fp32 bits (low
// halves zero).
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffff0000u;
  const float r1 = x - __uint_as_float(hi);
  mid = __float_as_uint(r1) & 0xffff0000u;
  lo = __float_as_uint(r1 - __uint_as_float(mid));
}

// The online-softmax step of one tile on the thread's two rows
// row0 + 8 i of the m64n64 score fragment s (register 4 n + 2 i + j is
// column col0 + 8 n + j); the 4 lanes of a row share m and l, which are
// in scaled units (max commutes with the positive scale, so m is the
// reference's max of the scaled scores).  p = exp(s * scale - m) with the
// scale folded into one FMA; with kMask, columns past Sk and (causal)
// past the row are left out of the max and get p = 0.
template <int NA, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&acc)[NA][32], float (&m)[2],
                                             float (&l)[2], int row0, int col0, int Sk,
                                             int causal, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    auto in = [&](int n, int j) {
      const int col = col0 + 8 * n + j;
      return !kMask || (col < Sk && (!causal || col <= row));
    };
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) mx = fmaxf(mx, in(n, j) ? s[4 * n + 2 * i + j] : kNegInf);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale);
    const float corr = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[4 * n + 2 * i + j];
        x = in(n, j) ? expf(fmaf(x, scale, -m_new)) : 0.f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[i] = l[i] * corr + sum;
    m[i] = m_new;
#pragma unroll
    for (int g = 0; g < NA; ++g)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[g][4 * n + 2 * i] *= corr;
        acc[g][4 * n + 2 * i + 1] *= corr;
      }
  }
}

// Rows [r0, r0 + 64) of a row-major (S, D) bf16 view with row stride rs
// into a 64 x KD tile: column block a = col / 64 at a * kAtom bytes, row r
// at r * 128, 16-byte chunk c at (c ^ r % 8) * 16 (the 128-byte swizzle,
// on a 1024-byte-aligned tile).  Rows >= S and columns >= D are zero.
template <int KD, bool kVec>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* g, long long rs,
                                          int r0, int S, int D, int tid) {
  if constexpr (kVec) {
    constexpr int CH = KD / 8;   // 16-byte chunks a row
    const uint32_t base = smem_u32(tile);
#pragma unroll
    for (int it = 0; it < kBQ * CH / kWThreads; ++it) {
      const int e = tid + it * kWThreads, r = e / CH, c = e % CH, col = 8 * c;
      const bool in = r0 + r < S && col < D;
      const int bytes = in ? min(16, 2 * (D - col)) : 0;
      const bf16* src = in ? g + (long long)(r0 + r) * rs + col : g;
      const uint32_t dst = base + (c / 8) * kAtom + r * 128 + (((c % 8) ^ (r % 8)) << 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                   "r"(bytes)
                   : "memory");
    }
  } else {
    for (int e = tid; e < kBQ * KD; e += kWThreads) {
      const int r = e / KD, col = e % KD;
      const bf16 x = (r0 + r < S && col < D) ? g[(long long)(r0 + r) * rs + col]
                                             : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(tile + (col / 64) * kAtom + r * 128 +
                               ((((col % 64) / 8) ^ (r % 8)) << 4) + (col % 8) * 2) = x;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int KD>
constexpr int bf16_smem_bytes() {
  return 5 * kBQ * KD * 2 + 1024;   // q, two k and two v tiles; 1 KiB to align
}

template <int KD, bool kVec>
__global__ void __launch_bounds__(kWThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
                            int Hq, int group, int D, int causal, float scale, long long qb,
                            long long qs, long long qh, long long kb, long long ks,
                            long long kh, long long vb, long long vs, long long vh) {
  constexpr int NA = KD / 64;          // 64-column blocks of a tile and of the output
  constexpr int TILE = kBQ * KD * 2;   // bytes of one 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + TILE;       // two buffers each
  unsigned char* sV = sK + 2 * TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heavy causal blocks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const bf16* qp = q + b * qb + h * qh;
  const bf16* kp = k + b * kb + hk * kh;
  const bf16* vp = v + b * vb + hk * vh;

  // under the causal mask no key after the q block's last row is needed
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  load_tile<KD, kVec>(sQ, qp, qs, q0, Sq, D, tid);
  cp_async_commit();
  load_tile<KD, kVec>(sK, kp, ks, 0, Sk, D, tid);
  load_tile<KD, kVec>(sV, vp, vs, 0, Sk, D, tid);
  cp_async_commit();

  // thread rows r_in + 8 i (i < 2) and columns 8 n + c_in + j (j < 2) of
  // every m64n64 accumulator: register 4 n + 2 i + j
  const int r_in = warp * 16 + lane / 4, c_in = 2 * (lane % 4);
  float acc[NA][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < NA; ++g)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[g][e] = 0.f;
  const uint32_t q_addr = smem_u32(sQ);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {       // the other buffer was freed at the end of t - 1
      load_tile<KD, kVec>(sK + (buf ^ 1) * TILE, kp, ks, (t + 1) * kBK, Sk, D, tid);
      load_tile<KD, kVec>(sV + (buf ^ 1) * TILE, vp, vs, (t + 1) * kBK, Sk, D, tid);
    }
    cp_async_commit();
    cp_async_wait1();            // q and tile t have landed, for this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();             // ... and for everyone's

    // S = Q.K^T over D / 16 k-steps of 32 bytes, 4 a swizzle column
    const uint32_t k_addr = smem_u32(sK + buf * TILE), v_addr = smem_u32(sV + buf * TILE);
    float s[32];
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      mma_ss(s, sw128_desc(q_addr + off, 16, 1024), sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(s);

    // online softmax over this tile; only a causal diagonal tile and the
    // ragged last tile have masked columns
    const int k0 = t * kBK;
    if ((causal && k0 + kBK > q0) || k0 + kBK > Sk)
      softmax_tile<NA, true>(s, acc, m, l, q0 + r_in, k0 + c_in, Sk, causal, scale);
    else
      softmax_tile<NA, false>(s, acc, m, l, q0 + r_in, k0 + c_in, Sk, causal, scale);

    // p = hi + mid + lo, packed as the bf16 A fragments of the 4 k-steps:
    // register r of k-step kk holds rows + 8 (r & 1), columns
    // 16 kk + 8 (r >> 1) + c_in + {0, 1} (low half first)
    uint32_t ph[16], pm[16], pl[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        uint32_t h0, m0, l0, h1, m1, l1;
        split3(s[e], h0, m0, l0);
        split3(s[e + 1], h1, m1, l1);
        ph[4 * kk + r] = __byte_perm(h0, h1, 0x7632);   // the high halves
        pm[4 * kk + r] = __byte_perm(m0, m1, 0x7632);
        pl[4 * kk + r] = __byte_perm(l0, l1, 0x7632);
      }

    // O += P.V: k-step kk takes v rows 16 kk .. 16 kk + 15 (two 8-row
    // swizzle groups, 1 KiB apart), output block g v's columns 64 g ..
#pragma unroll
    for (int g = 0; g < NA; ++g) pin(acc[g]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < NA; ++g) {
        const uint64_t dv = sw128_desc(v_addr + g * kAtom + kk * 2048, kAtom, 1024);
        mma_rs(acc[g], ph + 4 * kk, dv);
        mma_rs(acc[g], pm + 4 * kk, dv);
        mma_rs(acc[g], pl + 4 * kk, dv);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int g = 0; g < NA; ++g) pin(acc[g]);
    __syncthreads();             // every warp is done with buffer buf
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_in + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = o + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < NA; ++g)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 64 * g + 8 * n + c_in + j;
          if (col < D) orow[col] = __float2bfloat16(acc[g][4 * n + 2 * i + j] / den);
        }
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  strides: the batch,
// sequence and head strides of q, k and v, in elements (head dim stride 1).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Sk, int Hq, int Hkv, int D, int causal, int dtype,
                           long long qb, long long qs, long long qh, long long kb,
                           long long ks, long long kh, long long vb, long long vs,
                           long long vh, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 128 ||
      B > 65535 || Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const int group = Hq / Hkv;
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 0) {
    auto kernel = D <= 64 ? flash_attention_kernel<64> : flash_attention_kernel<128>;
    const int smem = D <= 64 ? smem_bytes<64>() : smem_bytes<128>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Sq, Sk, Hq, group, D, causal, scale, qb, qs, qh, kb, ks, kh, vb,
        vs, vh);
    return (int)cudaGetLastError();
  }
  // 16-byte copies need 16-byte-aligned rows: every base and stride
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   (qb | qs | qh | kb | ks | kh | vb | vs | vh) % 8 == 0;
  auto kernel = D <= 64 ? (vec ? flash_attention_bf16_kernel<64, true>
                               : flash_attention_bf16_kernel<64, false>)
                        : (vec ? flash_attention_bf16_kernel<128, true>
                               : flash_attention_bf16_kernel<128, false>);
  const int smem = D <= 64 ? bf16_smem_bytes<64>() : bf16_smem_bytes<128>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, Hq, group, D, causal, scale, qb, qs, qh, kb, ks, kh, vb,
      vs, vh);
  return (int)cudaGetLastError();
}

}  // extern "C"
