// B1 — MA-Echo Eq. 6 Gram of projected residuals, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:118
// (`maecho_gram`, pl.pallas_call at :131):
//     G[i, j] = <R_i, R_j>,   R_i = (W - V_i) P_i
// with W (out, in), V (N, out, in), P (N, in, in), all fp32, fp32
// accumulation (no TF32).
//
// Design.  The TPU grid ran in order and carried one (N, N)
// accumulator across every step; Hopper runs blocks in no order.  So
// each CTA owns one 32x32 (out, in) tile, forms every client's residual
// tile in turn (a K-loop over (W - V_i) and P_i tiles staged in shared
// memory, plain fp32 FMA), parks all N finished tiles in shared memory,
// contracts every client pair over the tile and writes its partial
// (N, N) Gram to a (n_tiles, N, N) workspace.  A second small launch
// sums the workspace over tiles in a fixed order, so G is bitwise
// reproducible run to run (no atomics: the QP's alpha is sensitive to
// G).  Ragged edges are masked on load (zero residual outside the
// leaf), which is exact, so no operand is padded or copied.
//
// Bound.  2*N*out*in^2 FMA-flops for the residual GEMM chain against
// ~4*(N*in^2 + N*out*in) bytes read: at the paper MLP's W0 (400x784,
// N=4) that is ~2 GFLOP on ~15 MB, bound by fp32 operations (67 TFLOP/s
// without tensor cores), not by the 3.35 TB/s memory.
//
// Shared memory: N parked tiles (N*4 KiB) plus two staging tiles must
// fit the 227 KiB a block may use, which caps N at kMaxClients = 54.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;          // tile edge: out rows, in columns, k depth
constexpr int NT = 256;        // threads per CTA; each owns a 2x2 micro-tile
constexpr int kMaxClients = 54;

constexpr size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * T * T + T * (T + 1) + T * T);
}

__global__ void __launch_bounds__(NT)
gram_partial_kernel(const float* __restrict__ W, const float* __restrict__ V,
                    const float* __restrict__ P, float* __restrict__ partial,
                    int N, int out_d, int in_d) {
  extern __shared__ float smem[];
  float* rstore = smem;                                  // N x T x T
  float (*As)[T + 1] = reinterpret_cast<float (*)[T + 1]>(smem + (size_t)N * T * T);
  float (*Bs)[T] = reinterpret_cast<float (*)[T]>(smem + (size_t)N * T * T + T * (T + 1));

  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;

  for (int i = 0; i < N; ++i) {
    const float* Vi = V + i * OI;
    const float* Pi = P + i * II;
    float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
    for (int k0 = 0; k0 < in_d; k0 += T) {
      for (int e = tid; e < T * T; e += NT) {
        const int r = e / T, c = e % T;
        const int o = o0 + r, k = k0 + c;
        As[r][c] = (o < out_d && k < in_d)
                       ? W[(size_t)o * in_d + k] - Vi[(size_t)o * in_d + k] : 0.f;
        const int kr = k0 + r, cc = c0 + c;
        Bs[r][c] = (kr < in_d && cc < in_d) ? Pi[(size_t)kr * in_d + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T; ++kk) {
        const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
        const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
        acc00 = fmaf(a0, b0, acc00);
        acc01 = fmaf(a0, b1, acc01);
        acc10 = fmaf(a1, b0, acc10);
        acc11 = fmaf(a1, b1, acc11);
      }
      __syncthreads();
    }
    float* Ri = rstore + (size_t)i * T * T;
    Ri[ty * T + tx] = acc00;
    Ri[ty * T + tx + 16] = acc01;
    Ri[(ty + 16) * T + tx] = acc10;
    Ri[(ty + 16) * T + tx + 16] = acc11;
  }
  __syncthreads();

  // pair contraction: one warp per (i <= j) pair, lanes stride the tile,
  // a fixed butterfly reduction keeps the sum order deterministic
  const int warp = tid / 32, lane = tid % 32;
  float* out = partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * N * N;
  for (int p = warp; p < N * N; p += NT / 32) {
    const int i = p / N, j = p % N;
    if (j < i) continue;                      // warp-uniform
    const float* Ri = rstore + (size_t)i * T * T;
    const float* Rj = rstore + (size_t)j * T * T;
    float s = 0.f;
    for (int e = lane; e < T * T; e += 32) s = fmaf(Ri[e], Rj[e], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      out[i * N + j] = s;
      out[j * N + i] = s;
    }
  }
}

// G[e] = sum over tiles of partial[t][e], tiles in index order.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ G, int n_tiles, int NN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NN) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * NN + e];
  G[e] = s;
}

int tiles(int d) { return (d + T - 1) / T; }

}  // namespace

extern "C" {

// Floats of workspace the launch needs: one partial (N, N) per tile.
long long maecho_gram_workspace_floats(int N, int out_d, int in_d) {
  return (long long)tiles(out_d) * tiles(in_d) * N * N;
}

int maecho_gram_max_clients() { return kMaxClients; }

int maecho_gram_launch(const void* W, const void* V, const void* P,
                       void* workspace, void* G, int N, int out_d, int in_d,
                       void* stream) {
  if (N < 1 || N > kMaxClients || out_d < 1 || in_d < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      gram_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles(in_d), tiles(out_d));
  gram_partial_kernel<<<grid, NT, smem, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(P), static_cast<float*>(workspace), N, out_d, in_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = N * N;
  gram_reduce_kernel<<<(NN + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(G),
      (int)(grid.x * grid.y), NN);
  return (int)cudaGetLastError();
}

}  // extern "C"
