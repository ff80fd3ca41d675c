// B3 — MA-Echo Eq. 6 Gram of diagonally projected residuals, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:386
// (`maecho_gram_diag`, pl.pallas_call at :396, body `_gram_diag_kernel`):
//     G[i, j] = sum_{o, c} R_i[o, c] * R_j[o, c],   R_i = (W - V_i) * p_i[None, :]
// with W (out, in), V (N, out, in), p (N, in), all fp32, fp32
// accumulation.  Scalar projectors reach it broadcast to a diagonal.
//
// Design.  There is no K-loop: every element of the leaf is read once.
// The leaf is walked as one flat array of out*in elements in chunks of
// kChunk; CTA b takes chunks b, b + gridDim.x, ...  Per chunk the CTA
// stages the N residual rows (N x kChunk floats, 27 KiB at N = 54, so
// static shared memory under the 48 KiB default suffices), then one warp
// per (i <= j) pair contracts them (lanes stride the chunk, fixed
// butterfly) and adds the sum into the CTA's (N, N) accumulator in
// shared memory.  A pair always belongs to the same warp, so there are
// no atomics.  Each CTA writes its partial (N, N) and the shared
// gram_reduce_kernel (maecho_tile.cuh) sums the partials in CTA order:
// G, and so the QP's alpha, is bitwise reproducible.  The grid size
// depends on the shape only.  Ragged edges need no masking beyond the
// end of the flat array.
//
// Bound.  4*(out*in*(N+1) + N*in) bytes against ~(N+1)*N*out*in flops:
// at the paper MLP's W0 (400x784, N=4) 6.28 MB and 9 MFLOP, bound by
// bytes (3.35 TB/s): 1.9 us, below one launch's latency.

#include "maecho_tile.cuh"

namespace {

constexpr int kChunk = 128;      // elements staged per client per step
constexpr int kMaxCtas = 264;    // two per SM of an H100

inline int gram_diag_ctas(long long total) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  return (int)(chunks < kMaxCtas ? chunks : kMaxCtas);
}

__global__ void __launch_bounds__(NT)
gram_diag_partial_kernel(const float* __restrict__ W, const float* __restrict__ V,
                         const float* __restrict__ p, float* __restrict__ partial,
                         int N, int in_d, long long total) {
  __shared__ float R[kMaxClients][kChunk];
  __shared__ float acc[kMaxClients * kMaxClients];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NN = N * N;
  for (int q = tid; q < NN; q += NT) acc[q] = 0.f;
  __syncthreads();

  // staging: thread t owns element t % kChunk of the chunk for clients
  // t / kChunk, t / kChunk + NT / kChunk, ... (coalesced rows of V_i)
  const int le = tid % kChunk, i0 = tid / kChunk;
  const long long n_chunks = (total + kChunk - 1) / kChunk;
  for (long long ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long long e = ch * kChunk + le;
    const bool live = e < total;
    const float w = live ? W[e] : 0.f;
    const int c = live ? (int)(e % in_d) : 0;
    for (int i = i0; i < N; i += NT / kChunk)
      R[i][le] = live ? (w - V[(size_t)i * total + e]) * p[(size_t)i * in_d + c] : 0.f;
    __syncthreads();
    for (int q = warp; q < NN; q += NT / 32) {
      const int i = q / N, j = q % N;
      if (j < i) continue;                    // warp-uniform
      float s = 0.f;
      for (int k = lane; k < kChunk; k += 32) s = fmaf(R[i][k], R[j][k], s);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) acc[q] += s;
    }
    __syncthreads();
  }

  float* out = partial + (size_t)blockIdx.x * NN;
  for (int q = tid; q < NN; q += NT) {
    const int i = q / N, j = q % N;
    out[q] = i <= j ? acc[q] : acc[j * N + i];
  }
}

}  // namespace

extern "C" {

long long maecho_gram_diag_workspace_floats(int N, int out_d, int in_d) {
  return (long long)gram_diag_ctas((long long)out_d * in_d) * N * N;
}

int maecho_gram_diag_max_clients() { return kMaxClients; }

int maecho_gram_diag_launch(const void* W, const void* V, const void* p,
                            void* workspace, void* G, int N, int out_d, int in_d,
                            void* stream) {
  if (N < 1 || N > kMaxClients || out_d < 1 || in_d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)out_d * in_d;
  const int ctas = gram_diag_ctas(total);
  float* ws = static_cast<float*>(workspace);
  gram_diag_partial_kernel<<<ctas, NT, 0, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(p), ws, N, in_d, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = N * N;
  gram_reduce_kernel<<<(NN + 255) / 256, 256, 0, s>>>(ws, static_cast<float*>(G),
                                                      ctas, NN);
  return (int)cudaGetLastError();
}

}  // extern "C"
