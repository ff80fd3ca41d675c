// B19 — cross-Gram block of two client chunks' flat residual rows, for
// Hopper (sm_90a): the pair contraction of the client-chunked MA-Echo
// Gram (kernels/ops.py, the chunked pipeline).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:227
// (`maecho_gram_cross`, pl.pallas_call at :242, body `_gram_cross_kernel`):
//     G[i, j] = sum_c Ra[i, c] * Rb[j, c],   Ra (ca, D), Rb (cb, D)
// all fp32, fp32 accumulation (plain FMA, no TF32).  Ra and Rb may be the
// same tensor (a chunk's diagonal block).
//
// Design.  The TPU kernel streamed D through VMEM in bd-wide slabs and
// carried one (ca, cb) accumulator across its sequential grid.  Hopper
// runs blocks in no order, so this is a split-K GEMM: the client axes are
// cut into 64 x 64 output tiles (any ca and cb, no cap: a chunk of 64, 256
// or all N clients), D into slabs of whole 32-column k-steps, and one CTA
// of 256 threads takes one (slab, tile): it streams its slab through
// shared memory (the next k-step's loads in registers while the current
// one is contracted), each thread holding a 4 x 4 block of the tile, and
// writes its partial to a workspace.  The shared gram_reduce_kernel
// (maecho_tile.cuh) then sums the partials in slab order: no atomics, so
// G — and the QP's alpha — is bitwise reproducible, and with Ra == Rb
// exactly symmetric (fmaf(a, b, s) == fmaf(b, a, s)).  The slab count
// fills the card (about 4 CTAs per SM, so 528 CTAs at ca = cb = 64) with
// at least 8 and at most 512 k-steps a slab, and keeps the workspace
// under 2^26 floats.  The ragged end of D is masked on load, not padded
// (the reference pads to bd: zero columns add zero), and so are the
// ragged client edges.
//
// Bound.  Each input read once and G written once: 4*(ca + cb)*D bytes,
// against 2*ca*cb*D fp32 operations.  At ca = cb = 64, D = 400*784:
// 160.6 MB (0.048 ms at 3.35 TB/s) and 2.57 GFLOP (0.038 ms at 67
// TFLOP/s): bound by bytes.  A 64 x 64 tile reads each operand row once,
// so at ca, cb <= 64 the kernel moves exactly those bytes.

#include <algorithm>

#include "maecho_tile.cuh"

namespace {

constexpr int kCT = 64;          // output tile edge on both client axes
constexpr int kCK = 32;          // columns per k-step
constexpr int kCThreads = 256;   // 16 x 16 threads, a 4 x 4 block each
constexpr int kCLoads = kCT * kCK / kCThreads;   // operand floats a thread loads a step
constexpr long long kTargetCtas = 4 * 132;
constexpr long long kMinSteps = 8;
constexpr long long kMaxSteps = 512;
constexpr long long kMaxWorkspace = 1LL << 26;   // floats

struct Split {
  long long nk;   // k-steps in D
  long long ks;   // k-steps a slab
  int slabs;
};

Split split(int ca, int cb, long long D) {
  const long long nk = (D + kCK - 1) / kCK;
  const long long tiles = (long long)((ca + kCT - 1) / kCT) * ((cb + kCT - 1) / kCT);
  long long s = (kTargetCtas + tiles - 1) / tiles;
  s = std::min(s, (nk + kMinSteps - 1) / kMinSteps);
  s = std::max(s, (nk + kMaxSteps - 1) / kMaxSteps);
  s = std::min(s, std::max(1LL, kMaxWorkspace / ((long long)ca * cb)));
  s = std::max(1LL, std::min(s, nk));
  const long long ks = (nk + s - 1) / s;
  return Split{nk, ks, (int)((nk + ks - 1) / ks)};
}

// Partial G of one (slab, 64 x 64 tile): slab = blockIdx.x, tile columns
// (Rb rows) blockIdx.y, tile rows (Ra rows) blockIdx.z.
__global__ void __launch_bounds__(kCThreads)
gram_cross_partial_kernel(const float* __restrict__ Ra, const float* __restrict__ Rb,
                          float* __restrict__ ws, int ca, int cb, long long D,
                          long long ks, long long nk) {
  // [k][row]: a warp stores 32 consecutive k of one row (stride 65: no
  // bank conflicts) and reads 16 consecutive rows of one k
  __shared__ float sa[kCK][kCT + 1];
  __shared__ float sb[kCK][kCT + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.z * kCT, j0 = blockIdx.y * kCT;
  const long long step0 = (long long)blockIdx.x * ks;
  const long long step1 = min(step0 + ks, nk);
  float ra[kCLoads], rb[kCLoads];
  auto load = [&](long long step) {
    const long long c0 = step * kCK;
#pragma unroll
    for (int q = 0; q < kCLoads; ++q) {
      const int e = tid + q * kCThreads, r = e / kCK;
      const long long c = c0 + e % kCK;
      ra[q] = (i0 + r < ca && c < D) ? Ra[(size_t)(i0 + r) * D + c] : 0.f;
      rb[q] = (j0 + r < cb && c < D) ? Rb[(size_t)(j0 + r) * D + c] : 0.f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  if (step0 < step1) load(step0);
  for (long long step = step0; step < step1; ++step) {
#pragma unroll
    for (int q = 0; q < kCLoads; ++q) {
      const int e = tid + q * kCThreads;
      sa[e % kCK][e / kCK] = ra[q];
      sb[e % kCK][e / kCK] = rb[q];
    }
    __syncthreads();
    if (step + 1 < step1) load(step + 1);
#pragma unroll
    for (int k = 0; k < kCK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = sa[k][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sb[k][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
  float* out = ws + (size_t)blockIdx.x * ca * cb;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (i < ca && j < cb) out[(size_t)i * cb + j] = acc[m][n];
    }
  }
}

}  // namespace

extern "C" {

long long maecho_gram_cross_workspace_floats(int ca, int cb, long long D) {
  if (ca < 1 || cb < 1 || D < 1) return 0;
  return (long long)split(ca, cb, D).slabs * ca * cb;
}

int maecho_gram_cross_launch(const void* Ra, const void* Rb, void* workspace, void* G,
                             int ca, int cb, long long D, void* stream) {
  if (ca < 1 || cb < 1 || D < 1 || (long long)ca * cb > 0x7fffffffLL ||
      (ca + kCT - 1) / kCT > 65535 || (cb + kCT - 1) / kCT > 65535)
    return (int)cudaErrorInvalidValue;
  const Split sp = split(ca, cb, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(sp.slabs, (cb + kCT - 1) / kCT, (ca + kCT - 1) / kCT);
  float* ws = static_cast<float*>(workspace);
  gram_cross_partial_kernel<<<grid, kCThreads, 0, s>>>(
      static_cast<const float*>(Ra), static_cast<const float*>(Rb), ws, ca, cb, D,
      sp.ks, sp.nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = ca * cb;
  gram_reduce_kernel<<<reduce_grid(NN, 1), 256, 0, s>>>(ws, static_cast<float*>(G),
                                                       sp.slabs, NN);
  return (int)cudaGetLastError();
}

}  // extern "C"
