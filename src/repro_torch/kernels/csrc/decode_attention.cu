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
// Design: one launch, one thread block cluster per (batch row, kv head).
// At Qwen2-0.5B's serving shape (B = 8, Hkv = 2) one CTA per (b, kv head)
// would fill 16 of 132 SMs, so the window is cut across the C CTAs of a
// cluster (C <= 8, the portable size; grid (C, Hkv, B), cluster (C, 1, 1)):
// CTA rank r owns the contiguous slots [r * run, (r + 1) * run).  The
// wrapper picks C and run (`decode_attention.window_split`), so its CPU
// emulation cuts the window the same way.  Each CTA of 128 threads:
//   - stages the group's q rows in shared memory as fp32, once;
//   - walks its run in sub-blocks of up to kSub slots with an online
//     softmax.  A sub-block whose mask holds no valid slot is skipped
//     before any load (the reference's pl.when).  Otherwise k and v are
//     copied in their own dtype by 16-byte cp.async (a 64-dim bf16 row is
//     8 chunks; k rows padded by 16 bytes so the 8 rows a quarter-warp
//     reads land in 8 bank groups), and converted at use;
//   - thread t scores slot t against 8 q rows a pass (the rows share each
//     k row), one warp a q row takes the sub-block's max and sum;
//   - p.v: warp j takes the slots j, j + 4, ... (20 each at the serving
//     shape), each lane kD / 32 output dims of 8 q rows a pass; the four
//     warps' partials are summed in warp order in shared memory and folded
//     into the CTA's accumulator with the softmax correction.
// Combine in the cluster: after a cluster barrier, rank r combines the
// output entries [r * per, (r + 1) * per) of the (group, D) block, reading
// every CTA's (m, l, acc) through distributed shared memory in rank order;
// a second barrier keeps each CTA's shared memory alive until all reads are
// done.  No workspace, no second launch and no atomics: the output is
// bitwise reproducible.  Caches and mask are read through their strides
// (head dim and slot contiguous), so a view cropped along W (the serving
// loop's w_live) is read in place; any W is taken, groups up to 64 and
// D <= 128 (zero-filled to 64 or 128).  When a base or a stride is not
// 16-byte aligned, rows are copied element by element into the same layout
// (a template flag).
//
// No tensor cores are needed.  At (B, W, Hkv, group, D) = (8, 640, 2, 7, 64)
// filled to 576, in bf16, the work is 4 B Hq D * 576 = 18 MFLOP against
// 2.4 MB of valid cache rows: under a microsecond at either rate.  The time
// is latency (global loads, barriers, the cluster's exchange), which is
// what one launch and a short critical path per CTA address.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGP = 8;               // q rows a pass
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// a 16-byte chunk of k as fp32: 4 floats or 8 bf16 (low half first)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int KD>
struct Geo {
  static constexpr int kRow = KD * (int)sizeof(T);       // bytes of one k / v row
  static constexpr int kSub = kRow <= 256 ? 128 : 64;    // slots a sub-block
  static constexpr int kKLd = kRow + 16;                  // padded k row
  static constexpr int kChunks = kRow / 16;               // 16-byte chunks a row
  static constexpr int kEpc = 16 / (int)sizeof(T);        // elements a chunk
  static constexpr int kDpl = KD / 32;                    // p.v output dims a lane
};

inline int round8(int g) { return (g + 7) / 8 * 8; }

// shared memory: k, v sub-block; q, s/p, acc (fp32); m, l, corr
template <typename T, int KD>
int smem_bytes(int group) {
  using G = Geo<T, KD>;
  const int g8 = round8(group);
  return G::kSub * G::kKLd + G::kSub * G::kRow +
         (int)sizeof(float) * (g8 * KD + g8 * G::kSub + g8 * KD + 3 * g8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [w0, w0 + n) of a (W, D) cache view with row stride rs into a
// sub-block tile of row pitch ld bytes; columns past D are zero
template <typename T, int KD, bool kVec>
__device__ __forceinline__ void load_rows(unsigned char* tile, int ld, const T* g, long long rs,
                                          int w0, int n, int D, int tid) {
  using G = Geo<T, KD>;
  if constexpr (kVec) {
    const uint32_t base = smem_u32(tile);
    for (int e = tid; e < n * G::kChunks; e += kThreads) {
      const int r = e / G::kChunks, c = e % G::kChunks, col = c * G::kEpc;
      const int bytes = col < D ? min(16, (int)sizeof(T) * (D - col)) : 0;
      cp16(base + r * ld + c * 16, bytes ? g + (w0 + r) * rs + col : g, bytes);
    }
  } else {
    for (int e = tid; e < n * KD; e += kThreads) {
      const int r = e / KD, c = e % KD;
      *reinterpret_cast<T*>(tile + r * ld + c * (int)sizeof(T)) =
          c < D ? g[(w0 + r) * rs + c] : T(0.f);
    }
  }
}

template <typename T, int KD, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        T* __restrict__ o, int W, int run, int Hkv, int group, int D,
                        float scale, long long qb, long long qh, long long kb, long long kw,
                        long long kh, long long vb, long long vw, long long vh,
                        long long mb) {
  using G = Geo<T, KD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g8 = (group + 7) / 8 * 8;
  unsigned char* sK = smem;                                  // [kSub][kKLd]
  unsigned char* sV = sK + G::kSub * G::kKLd;                // [kSub][kRow]
  float* sQ = reinterpret_cast<float*>(sV + G::kSub * G::kRow);   // [g8][KD]
  float* sS = sQ + g8 * KD;                                  // [g8][kSub]: s, then p
  float* sAcc = sS + g8 * G::kSub;                           // [g8][KD]
  float* sM = sAcc + g8 * KD;
  float* sL = sM + g8;
  float* sCorr = sL + g8;
  float* sRed = reinterpret_cast<float*>(sK);                // [kWarps][kGP][KD], k is spent

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* kp = k + b * kb + hk * kh;
  const T* vp = v + b * vb + hk * vh;
  const uint8_t* mp = mask + b * mb;

  const T* qp = q + b * qb + (long long)hk * group * qh;
  for (int e = tid; e < g8 * KD; e += kThreads) {
    const int g = e / KD, c = e % KD;
    sQ[e] = (g < group && c < D) ? to_f(qp[g * qh + c]) : 0.f;
    sAcc[e] = 0.f;
  }
  for (int g = tid; g < g8; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  const int s1 = min(W, (rank + 1) * run);
  for (int w0 = rank * run; w0 < s1; w0 += G::kSub) {
    const int n = min(G::kSub, s1 - w0);
    const bool valid = tid < n && mp[w0 + tid] != 0;
    if (!__syncthreads_or(valid)) continue;     // no valid slot: nothing to load
    load_rows<T, KD, kVec>(sK, G::kKLd, kp, kw, w0, n, D, tid);
    cp_commit();
    load_rows<T, KD, kVec>(sV, G::kRow, vp, vw, w0, n, D, tid);
    cp_commit();
    cp_wait1();                                 // k has landed (this thread's copies)
    __syncthreads();

    // scores: thread tid takes slot w0 + tid, 8 q rows a pass
    if (tid < n) {
      const unsigned char* krow = sK + tid * G::kKLd;
      for (int g0 = 0; g0 < g8; g0 += kGP) {
        float s[kGP];
#pragma unroll
        for (int j = 0; j < kGP; ++j) s[j] = 0.f;
#pragma unroll 2
        for (int c = 0; c < G::kChunks; ++c) {
          float kf[G::kEpc];
          unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
          for (int j = 0; j < kGP; ++j) {     // q read as float4 broadcasts
            const float4* qc = reinterpret_cast<const float4*>(sQ + (g0 + j) * KD + c * G::kEpc);
#pragma unroll
            for (int h = 0; h < G::kEpc / 4; ++h) {
              const float4 qq = qc[h];
              s[j] = fmaf(qq.x, kf[4 * h], s[j]);
              s[j] = fmaf(qq.y, kf[4 * h + 1], s[j]);
              s[j] = fmaf(qq.z, kf[4 * h + 2], s[j]);
              s[j] = fmaf(qq.w, kf[4 * h + 3], s[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kGP; ++j) sS[(g0 + j) * G::kSub + tid] = valid ? s[j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // one warp a q row: the sub-block's max, p in place, the running (m, l)
    for (int g = warp; g < group; g += kWarps) {
      constexpr int PL = G::kSub / 32;
      float x[PL], mx = kNegInf;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int w = lane + 32 * i;
        x[i] = w < n ? sS[g * G::kSub + w] : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        // invalid slots hold NEG_INF: zero them explicitly
        const float p = x[i] > 0.5f * kNegInf ? expf(x[i] - m_new) : 0.f;
        if (lane + 32 * i < n) sS[g * G::kSub + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = fmaf(sL[g], corr, sum);
        sM[g] = m_new;
        sCorr[g] = corr;
      }
    }
    cp_wait0();                                 // v has landed
    __syncthreads();

    // p.v, 8 q rows a pass: warp j sums the slots j, j + 4, ...; lane
    // `lane` owns dims lane * kDpl ..
    for (int g0 = 0; g0 < group; g0 += kGP) {
      float a[kGP][G::kDpl];
#pragma unroll
      for (int j = 0; j < kGP; ++j)
#pragma unroll
        for (int d = 0; d < G::kDpl; ++d) a[j][d] = 0.f;
      for (int t = warp; t < n; t += kWarps) {
        const T* vr = reinterpret_cast<const T*>(sV + t * G::kRow) + lane * G::kDpl;
        float vf[G::kDpl];
#pragma unroll
        for (int d = 0; d < G::kDpl; ++d) vf[d] = to_f(vr[d]);
#pragma unroll
        for (int j = 0; j < kGP; ++j) {
          const float p = sS[(g0 + j) * G::kSub + t];
#pragma unroll
          for (int d = 0; d < G::kDpl; ++d) a[j][d] = fmaf(p, vf[d], a[j][d]);
        }
      }
#pragma unroll
      for (int j = 0; j < kGP; ++j)
#pragma unroll
        for (int d = 0; d < G::kDpl; ++d) sRed[(warp * kGP + j) * KD + lane * G::kDpl + d] = a[j][d];
      __syncthreads();
      for (int e = tid; e < kGP * KD; e += kThreads) {
        const int g = g0 + e / KD;
        if (g >= group) break;
        float r = sRed[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) r += sRed[w * kGP * KD + e];
        sAcc[g0 * KD + e] = fmaf(sAcc[g0 * KD + e], sCorr[g], r);
      }
      __syncthreads();
    }
  }

  // every CTA's (m, l, acc) is final: combine across the cluster
  cluster.sync();
  const int total = group * D, per = (total + C - 1) / C;
  const int e1 = min(total, (rank + 1) * per);
  T* ob = o + ((long long)b * Hkv + hk) * group * D;
  for (int e = rank * per + tid; e < e1; e += kThreads) {
    const int g = e / D, d = e % D;
    float M = kNegInf;
    for (int r = 0; r < C; ++r) M = fmaxf(M, *cluster.map_shared_rank(sM + g, r));
    float L = 0.f, A = 0.f;
    for (int r = 0; r < C; ++r) {
      const float c = expf(*cluster.map_shared_rank(sM + g, r) - M);
      L = fmaf(*cluster.map_shared_rank(sL + g, r), c, L);
      A = fmaf(*cluster.map_shared_rank(sAcc + g * KD + d, r), c, A);
    }
    store(ob + e, A / fmaxf(L, 1e-30f));       // o (B, 1, Hkv * group, D) contiguous
  }
  cluster.sync();                               // keep shared memory alive for the readers
}

template <typename T, int KD, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
           int W, int Hq, int Hkv, int D, int ctas, int run, const long long* st,
           cudaStream_t s) {
  const int group = Hq / Hkv;
  const int smem = smem_bytes<T, KD>(group);
  auto kernel = decode_attention_kernel<T, KD, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
                           static_cast<T*>(o), W, run, Hkv, group, D, 1.0f / sqrtf((float)D),
                           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
             int W, int Hq, int Hkv, int D, int ctas, int run, const long long* st,
             cudaStream_t s) {
  // 16-byte copies need 16-byte-aligned rows: both caches' bases and strides
  const long long a = (long long)sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   ((st[2] | st[3] | st[4] | st[5] | st[6] | st[7]) * a) % 16 == 0;
  if (D <= 64)
    return vec ? launch<T, 64, true>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s)
               : launch<T, 64, false>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s);
  return vec ? launch<T, 128, true>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s)
             : launch<T, 128, false>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, caches and o alike); mask is bool (one
// byte a slot).  ctas (1..8) CTAs a cluster, each owning `run` slots of
// the window (ctas * run >= W).  Strides in elements: q's batch and head
// strides; each cache's batch, slot and head strides; the mask's batch
// stride (head dim and the mask's slot axis contiguous).
int decode_attention_launch(const void* q, const void* k, const void* v, const void* mask,
                            void* o, int B, int W, int Hq, int Hkv, int D, int ctas, int run,
                            int dtype, long long qb, long long qh, long long kb, long long kw,
                            long long kh, long long vb, long long vw, long long vh,
                            long long mb, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > 64 || D < 1 || D > 128 ||
      B > 65535 || Hkv > 65535 || ctas < 1 || ctas > 8 || run < 1 ||
      (long long)ctas * run < W || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qb, qh, kb, kw, kh, vb, vw, vh, mb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s);
  return dispatch<__nv_bfloat16>(q, k, v, mask, o, B, W, Hq, Hkv, D, ctas, run, st, s);
}

}  // extern "C"
