// B21 — causal / non-causal GQA flash attention (forward only) for Hopper
// (sm_90a):
//     o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / group] * D^-1/2) v[b, t, h / group]
// for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) in float32 or bfloat16,
// every product, score and sum in fp32 (plain FMA, no TF32), the output in
// q's dtype.  Causal: key t is masked for query row s when t > s, with the
// reference's NEG_INF = -1e30; the sum l is clamped at 1e-30 before the
// division.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:76
// (`flash_attention`, pl.pallas_call at :103, body `_kernel`), whose grid
// (B, Hq, n_q, n_k) carries the online-softmax state (m, l, acc) in VMEM
// across the innermost kv axis and skips (pl.when) the kv blocks strictly
// after a causal q block.  The reference has no backward kernel, so this
// port has none either.
//
// Design.  Hopper runs blocks in no order, so the carried kv axis becomes
// a loop inside the block: one CTA of 256 threads per (64-row q block,
// q head, batch row) walks the kv axis in 64-row tiles, and under the
// causal mask stops at the q block's last row, so the tiles after it are
// never loaded (the reference's skip).  The kv head is h / group, as the
// reference's index map.  q, k and v are read in their (B, S, H, D)
// layout through the strides they come with (head dim contiguous), so
// the reference's transposes have no counterpart; ragged S (rows past Sq
// or Sk) and D <= 128 (zero-filled to 64 or 128) are masked in the
// kernel, so nothing is padded.  The q tile and each k / v tile are
// staged in shared memory as fp32 (rows padded to a 16-byte multiple, so
// each thread reads 4 dims with one 16-byte load and the 16 rows a warp
// reads land in distinct banks).  Thread (ty, tx) owns score rows
// ty + 16 m and columns tx + 16 n (m, n < 4); the row max and row sum
// reduce over the 16 lanes of a row with shuffles, m and l stay in
// registers, p goes through shared memory to the p.v product, where the
// thread owns output columns 64 g + 4 tx + j.
//
// Why not one CTA per kv head serving all `group` q heads (which would
// load each k / v tile once instead of `group` times)?  At Qwen2-0.5B
// (group 7, D 64) that CTA would hold 7 x 64 q rows: too many registers
// or too little occupancy for a SIMT kernel, and the k / v re-reads of
// the 7 heads hit the 50 MB L2 (one (b, kv head) slice is 128 KB at
// S = 512 in bf16), so the kernel is bound by its shared-memory traffic
// and FMAs, not by device memory.
//
// Bound.  Causal at (B, S, Hq, Hkv, D) = (8, 512, 14, 2, 64): the least
// work is the unmasked half of q.k^T and p.v, 4 B Hq D S (S + 1) / 2
// ~ 3.77 GFLOP, against ~16.8 MB of q, k, v and o in bf16 (0.005 ms at
// 3.35 TB/s).  The card computes that work exactly faster than in fp32
// SIMT: q.k^T of bf16 operands is exact on the bf16 tensor cores with
// fp32 accumulation (989 TFLOP/s), and p.v takes p in fp32 exactly as
// three bf16 terms (a third of that rate), so the bound is ~0.0076 ms,
// by operations (0.056 ms if all of it ran at 67 TFLOP/s fp32).  This
// SIMT fp32 kernel feeds 16 FMAs from each 16-byte shared load and sits
// tens of times above that bound; a bf16 tensor-core (`wgmma`) version
// with a split p is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLP = kBK + 4;     // row stride of the p tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int KD>
constexpr int smem_bytes() {
  return (3 * kBQ * (KD + 4) + kBQ * kLP) * (int)sizeof(float);
}

template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
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
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + hk * kh;
  const T* vp = v + b * vb + hk * vh;

  for (int e = tid; e < kBQ * KD; e += kThreads) {
    const int r = e / KD, c = e % KD;
    sQ[r * LD + c] = (q0 + r < Sq && c < D) ? to_f(qp[(q0 + r) * qs + c]) : 0.f;
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
      sK[r * LD + c] = in ? to_f(kp[(k0 + r) * ks + c]) : 0.f;
      sV[r * LD + c] = in ? to_f(vp[(k0 + r) * vs + c]) : 0.f;
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
    T* orow = o + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 64 * g + 4 * tx + j;
        if (col < D) store(orow + col, acc[i][4 * g + j] / den);
      }
  }
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int Hq, int Hkv, int D, int causal, const long long* st, cudaStream_t s) {
  constexpr int smem = smem_bytes<KD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, KD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hq / Hkv, D, causal, 1.0f / sqrtf((float)D), st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
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
  const long long st[9] = {qb, qs, qh, kb, ks, kh, vb, vs, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch<float, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, st, s)
                   : launch<float, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, st, s);
  return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, st, s)
                 : launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, st, s);
}

}  // extern "C"
