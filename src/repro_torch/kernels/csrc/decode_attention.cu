// B22 — one-token decode attention over a ring-buffer KV cache under a
// validity mask, for Hopper (sm_90a):
//     o[b, h] = sum_w p[b, h, w] v[b, w, h / group] / sum_w p[b, h, w],
//     p[b, h, w] = valid[b, w] * exp(q[b, h] . k[b, w, h / group] * D^-1/2 - m),
// for q (B, 1, Hq, D), caches (B, W, Hkv, D) in float32 or bfloat16 and a
// boolean mask (B, W); every product and sum in fp32 (plain FMA), the output
// in q's dtype.  Invalid slots get the score NEG_INF = -1e30 and are zeroed
// in p explicitly (with m = NEG_INF, exp(s - m) would be 1), so a row with no
// valid slot returns zeros, as the reference kernel does (its dense oracle
// returns mean(v) there).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:128
// (`decode_attention`, pl.pallas_call at :189, body `_kernel_fine`), whose
// grid (B, Hkv, n_w) carries (m, l, acc) across the window blocks, skips
// (pl.when) the blocks with no valid slot and folds the GQA group into the
// q rows (head h = hkv * group + g).  Only that per-(b, kv head) layout is
// ported: the whole-batch `fold_batch` layout exists for the interpreter.
//
// Design.  At Qwen2-0.5B's serving shape (B = 8, Hkv = 2) one CTA per
// (b, kv head) would fill 16 of 132 SMs, so the window is split: one CTA of
// 128 threads per (128-slot block, kv head, batch row) — the split-K over
// W.  A block whose mask holds no valid slot writes the empty partial
// (m = NEG_INF, l = 0, acc = 0) without loading the cache (the reference's
// skip).  Otherwise it stages its k / v rows and the group's q rows in
// shared memory as fp32, thread w scores slot w against all `group` q rows
// (the rows share each k / v tile), one warp per q row takes the block's
// max and sum, and the threads form the block's partial p.v.  A second
// launch combines the blocks' partials per (b, h, d) in block order, with
// no atomics, so the output is bitwise reproducible.  The caches and the
// mask are read through their strides (head dim and slot contiguous), so a
// view cropped along W (the serving loop's w_live) is read in place; any
// W is taken, masked at the ragged edge.
//
// Bound.  At (B, W, Hkv, group, D) = (8, 640, 2, 7, 64) in bf16 the cache is
// 2 B W Hkv D * 2 bytes = 2.6 MB (0.0008 ms at 3.35 TB/s) and the work
// 4 B Hq W D = 18 MFLOP: bound by bytes, under a microsecond, so the two
// launches' latency dominates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBW = 128;          // slots per block (and threads per CTA)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

inline int round8(int g) { return (g + 7) / 8 * 8; }

template <int KD>
int smem_bytes(int group) {
  const int g8 = round8(group);
  return (kBW * (KD + 1) + kBW * KD + g8 * KD + g8 * kBW) * (int)sizeof(float);
}

// partial (m, l, acc) of one 128-slot block for the `group` q rows of one
// (b, kv head): ml (B, Hkv, nb, group, 2), acc (B, Hkv, nb, group, D)
template <typename T, int KD>
__global__ void __launch_bounds__(kBW)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ ml, float* __restrict__ part, int W, int Hkv,
                      int group, int D, float scale, long long qb, long long qh,
                      long long kb, long long kw, long long kh, long long vb, long long vw,
                      long long vh, long long mb) {
  extern __shared__ float smem[];
  const int g8 = (group + 7) / 8 * 8;
  float* sK = smem;                     // [kBW][KD + 1]
  float* sV = sK + kBW * (KD + 1);      // [kBW][KD]
  float* sQ = sV + kBW * KD;            // [g8][KD]
  float* sS = sQ + g8 * KD;             // [g8][kBW]: scores, then p
  const int tid = threadIdx.x, blk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x, w0 = blk * kBW;
  const long long slot = (((long long)b * Hkv + hk) * nb + blk) * group;   // first q row's partial
  const bool valid = w0 + tid < W && mask[b * mb + w0 + tid] != 0;
  if (!__syncthreads_or(valid)) {       // no valid slot: the empty partial
    for (int e = tid; e < group * D; e += kBW) part[slot * D + e] = 0.f;
    for (int g = tid; g < group; g += kBW) {
      ml[2 * (slot + g)] = kNegInf;
      ml[2 * (slot + g) + 1] = 0.f;
    }
    return;
  }
  const T* kp = k + b * kb + hk * kh;
  const T* vp = v + b * vb + hk * vh;
  for (int e = tid; e < kBW * KD; e += kBW) {
    const int r = e / KD, c = e % KD;
    const bool in = w0 + r < W && c < D;
    sK[r * (KD + 1) + c] = in ? to_f(kp[(w0 + r) * kw + c]) : 0.f;
    sV[r * KD + c] = in ? to_f(vp[(w0 + r) * vw + c]) : 0.f;
  }
  const T* qp = q + b * qb + (long long)hk * group * qh;
  for (int e = tid; e < g8 * KD; e += kBW) {
    const int g = e / KD, c = e % KD;
    sQ[e] = (g < group && c < D) ? to_f(qp[g * qh + c]) : 0.f;
  }
  __syncthreads();

  // thread tid scores slot w0 + tid against every q row of the group
  for (int g0 = 0; g0 < g8; g0 += 8) {
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < KD; ++d) {
      const float kv = sK[tid * (KD + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = fmaf(sQ[(g0 + j) * KD + d], kv, s[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sS[(g0 + j) * kBW + tid] = valid ? s[j] * scale : kNegInf;
  }
  __syncthreads();

  // one warp per q row: the block's max m and sum l; p back into sS
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < group; g += kBW / 32) {
    float x[kBW / 32], mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kBW / 32; ++i) {
      x[i] = sS[g * kBW + lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBW / 32; ++i) {
      // invalid slots hold NEG_INF; zero them explicitly
      const float p = x[i] > 0.5f * kNegInf ? expf(x[i] - mx) : 0.f;
      sS[g * kBW + lane + 32 * i] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[2 * (slot + g)] = mx;
      ml[2 * (slot + g) + 1] = sum;
    }
  }
  __syncthreads();

  // the block's partial p.v, one (q row, dim) per thread and step
  for (int e = tid; e < group * D; e += kBW) {
    const int g = e / D, c = e % D;
    float a = 0.f;
#pragma unroll 8
    for (int w = 0; w < kBW; ++w) a = fmaf(sS[g * kBW + w], sV[w * KD + c], a);
    part[slot * D + e] = a;
  }
}

// o[b, h, d] from the blocks' partials, combined in block order
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ml,
                                      const float* __restrict__ part, T* __restrict__ o,
                                      int B, int Hkv, int group, int D, int nb) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * Hkv * group * D;
  if (e >= total) return;
  const int d = (int)(e % D);
  const long long bh = e / D;                       // (b * Hkv + hk) * group + g
  const int g = (int)(bh % group);
  const long long base = bh / group * nb;           // (b * Hkv + hk) * nb
  float M = kNegInf;
  for (int j = 0; j < nb; ++j) M = fmaxf(M, ml[2 * ((base + j) * group + g)]);
  float L = 0.f, A = 0.f;
  for (int j = 0; j < nb; ++j) {
    const long long r = (base + j) * group + g;
    const float c = expf(ml[2 * r] - M);
    L = fmaf(ml[2 * r + 1], c, L);
    A = fmaf(part[r * D + d], c, A);
  }
  store(o + e, A / fmaxf(L, 1e-30f));               // o (B, 1, Hkv * group, D) contiguous
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, const void* mask, float* ws, void* o,
           int B, int W, int Hq, int Hkv, int D, const long long* st, cudaStream_t s) {
  const int group = Hq / Hkv, nb = (W + kBW - 1) / kBW;
  const int smem = smem_bytes<KD>(group);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float* ml = ws;
  float* part = ws + 2LL * B * Hkv * nb * group;
  decode_partial_kernel<T, KD><<<dim3(nb, Hkv, B), kBW, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), ml, part, W, Hkv, group, D,
      1.0f / sqrtf((float)D), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * Hq * D;
  decode_combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      ml, part, static_cast<T*>(o), B, Hkv, group, D, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace one launch needs: (m, l) and the partial acc of every
// 128-slot block, q row and (b, kv head).
long long decode_attention_workspace_floats(int B, int W, int Hq, int Hkv, int D) {
  return (long long)B * Hq * ((W + kBW - 1) / kBW) * (D + 2);
}

// dtype: 0 float32, 1 bfloat16 (q, caches and o alike); mask is bool (one
// byte a slot).  Strides in elements: q's batch and head strides; each
// cache's batch, slot and head strides; the mask's batch stride (head dim
// and the mask's slot axis contiguous).
int decode_attention_launch(const void* q, const void* k, const void* v, const void* mask,
                            void* ws, void* o, int B, int W, int Hq, int Hkv, int D,
                            int dtype, long long qb, long long qh, long long kb,
                            long long kw, long long kh, long long vb, long long vw,
                            long long vh, long long mb, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > 64 || D < 1 || D > 128 ||
      B > 65535 || Hkv > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qb, qh, kb, kw, kh, vb, vw, vh, mb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return D <= 64 ? launch<float, 64>(q, k, v, mask, w, o, B, W, Hq, Hkv, D, st, s)
                   : launch<float, 128>(q, k, v, mask, w, o, B, W, Hq, Hkv, D, st, s);
  return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, mask, w, o, B, W, Hq, Hkv, D, st, s)
                 : launch<__nv_bfloat16, 128>(q, k, v, mask, w, o, B, W, Hq, Hkv, D, st, s);
}

}  // extern "C"
