// B20 — symmetric rank-b downdate of a block-RLS null-space projector,
// for Hopper (sm_90a):
//     out = Q - U A U^T,   Q (d, d), U (d, b), A (b, b) symmetric,
// all fp32, fp32 accumulation (plain FMA, no TF32).  The step of
// kernels/rank_update.block_rls_update, with U = Q X_b^T and
// A = (alpha I + X_b Q X_b^T)^-1 formed outside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/rank_update.py:40
// (`rank_downdate`, pl.pallas_call at :48, body `_kernel`), which keeps A
// resident in VMEM and, per (bo, bj) output tile, computes U_i A U_j^T.
//
// Design.  One CTA of 256 threads per 64 x 64 output tile (i, j).  The b
// axis is walked in 32-wide pieces, so no b is too large for shared
// memory: for each column piece c of A the CTA forms the 64 x 32 block
// T_c = U_i A[:, c] (the pieces of U_i's columns and of A's rows stream
// through shared memory, every piece of A read once per CTA), parks T_c
// in shared memory and adds T_c U_j[:, c]^T into its 4 x 4 register
// block per thread; then it writes Q_ij minus the sum.  Ragged d and b
// are masked on load and store (d = 784 or 896 needs no padding), and
// the output is a new tensor, as in the reference.  Each CTA recomputes
// its row block's U_i A: 2 d^2 b^2 / 64 extra operations, b / 32 times
// the T U^T product — the price of needing no second launch or
// workspace.
//
// Bound.  Each input read once and out written once: 4*(2 d^2 + d b + b^2)
// bytes.  A is symmetric, so U A U^T is too and only its upper triangle
// needs the product: the least work is 2 d b^2 + d (d+1) b + d^2
// operations (this kernel computes both triangles, 2 d^2 b).  At d = 784,
// b = 128: 5.38 MB (0.0016 ms at 3.35 TB/s) and 0.105 GFLOP (0.0016 ms
// at 67 TFLOP/s): bound by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kRT = 64;          // output tile edge
constexpr int kRP = 32;          // piece of the b axis
constexpr int kRThreads = 256;   // 16 x 16; rows ty + 16 m, columns tx + 16 n

__global__ void __launch_bounds__(kRThreads)
rank_downdate_kernel(const float* __restrict__ Q, const float* __restrict__ U,
                     const float* __restrict__ A, float* __restrict__ out, int d,
                     int b) {
  __shared__ float su[kRP][kRT + 1];   // su[r][o] = U[i0 + o][r0 + r]
  __shared__ float sa[kRP][kRP + 1];   // sa[r][c] = A[r0 + r][c0 + c]
  __shared__ float st[kRP][kRT + 1];   // st[c][o] = T_c[o][c]
  __shared__ float sv[kRP][kRT + 1];   // sv[c][j] = U[j0 + j][c0 + c]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kRT, j0 = blockIdx.x * kRT;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int c0 = 0; c0 < b; c0 += kRP) {
    // T_c = U_i A[:, c0:c0+32]: thread rows ty + 16 m, columns tx + 16 n
    float t[4][2];
#pragma unroll
    for (int m = 0; m < 4; ++m) t[m][0] = t[m][1] = 0.f;
    for (int r0 = 0; r0 < b; r0 += kRP) {
      for (int e = tid; e < kRT * kRP; e += kRThreads) {
        const int r = e % kRP, o = e / kRP;
        su[r][o] = (i0 + o < d && r0 + r < b) ? U[(size_t)(i0 + o) * b + r0 + r] : 0.f;
      }
      for (int e = tid; e < kRP * kRP; e += kRThreads) {
        const int r = e / kRP, c = e % kRP;
        sa[r][c] = (r0 + r < b && c0 + c < b) ? A[(size_t)(r0 + r) * b + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kRP; ++r) {
        const float b0 = sa[r][tx], b1 = sa[r][tx + 16];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float a = su[r][ty + 16 * m];
          t[m][0] = fmaf(a, b0, t[m][0]);
          t[m][1] = fmaf(a, b1, t[m][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      st[tx][ty + 16 * m] = t[m][0];
      st[tx + 16][ty + 16 * m] = t[m][1];
    }
    for (int e = tid; e < kRT * kRP; e += kRThreads) {
      const int c = e % kRP, j = e / kRP;
      sv[c][j] = (j0 + j < d && c0 + c < b) ? U[(size_t)(j0 + j) * b + c0 + c] : 0.f;
    }
    __syncthreads();
    // acc += T_c U_j[:, c0:c0+32]^T
#pragma unroll 8
    for (int c = 0; c < kRP; ++c) {
      float a[4], v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = st[c][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = sv[c][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], v[n], acc[m][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (i < d && j < d) {
        const size_t at = (size_t)i * d + j;
        out[at] = Q[at] - acc[m][n];
      }
    }
  }
}

}  // namespace

extern "C" {

int rank_downdate_launch(const void* Q, const void* U, const void* A, void* out, int d,
                         int b, void* stream) {
  if (d < 1 || b < 1 || (d + kRT - 1) / kRT > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((d + kRT - 1) / kRT, (d + kRT - 1) / kRT);
  rank_downdate_kernel<<<grid, kRThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(U),
      static_cast<const float*>(A), static_cast<float*>(out), d, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
