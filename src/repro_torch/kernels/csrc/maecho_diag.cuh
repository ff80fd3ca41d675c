// Shared bodies of the elementwise MA-Echo kernels with diagonal
// projectors P_i = diag(p_i), for Hopper (sm_90a): B3/B6/B9 and their
// stacked twins B12/B15/B18.  Every launch covers L scan-stacked layers
// (L = 1 for an unstacked leaf): W (L, out, in), V (N, L, out, in),
// p (N, L, in), alpha (L, N), G (L, N, N).  Indices and offsets are
// 64-bit.  Each kernel is a template on STACKED, whose L = 1 instance
// folds the layer arithmetic away (see maecho_tile.cuh).  The designs
// and bounds are in each entry point's source.

#pragma once

#include "maecho_tile.cuh"

namespace {

// ---------------------------------------------------------------- Gram

constexpr int kChunk = 128;      // elements staged per client per step
constexpr int kMaxCtas = 264;    // two per SM of an H100, per layer

inline int gram_diag_ctas(long long total) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  return (int)(chunks < kMaxCtas ? chunks : kMaxCtas);
}

// CTA (b, l) walks chunks b, b + gridDim.x, ... of layer l's flat leaf
// of total = out*in elements and writes its partial (N, N).
template <bool STACKED>
__global__ void __launch_bounds__(NT)
gram_diag_partial_kernel(const float* __restrict__ W, const float* __restrict__ V,
                         const float* __restrict__ p, float* __restrict__ partial,
                         int N, int L, int in_d, long long total) {
  __shared__ float R[kMaxClients][kChunk];
  __shared__ float acc[kMaxClients * kMaxClients];
  const int tid = threadIdx.x;
  const int l = STACKED ? blockIdx.y : 0;
  const int NN = N * N;
  for (int q = tid; q < NN; q += NT) acc[q] = 0.f;
  __syncthreads();

  // staging: thread t owns element t % kChunk of the chunk for clients
  // t / kChunk, t / kChunk + NT / kChunk, ... (coalesced rows of V_il)
  const float* Wl = W + (size_t)l * total;
  const int le = tid % kChunk, i0 = tid / kChunk;
  const long long n_chunks = (total + kChunk - 1) / kChunk;
  for (long long ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long long e = ch * kChunk + le;
    const bool live = e < total;
    const float w = live ? Wl[e] : 0.f;
    const int c = live ? (int)(e % in_d) : 0;
    for (int i = i0; i < N; i += NT / kChunk) {
      const size_t il = STACKED ? (size_t)i * L + l : i;
      R[i][le] = live ? (w - V[il * total + e]) * p[il * in_d + c] : 0.f;
    }
    __syncthreads();
    contract_pairs(&R[0][0], kChunk, kChunk, N, 0, N, true,
                   [&](int q, int, int, float s) { acc[q] += s; });
    __syncthreads();
  }

  float* out = partial + ((size_t)l * gridDim.x + blockIdx.x) * NN;
  for (int q = tid; q < NN; q += NT) {
    const int i = q / N, j = q % N;
    out[q] = i <= j ? acc[q] : acc[j * N + i];
  }
}

// Client blocks (N > kMaxClients; see ClientBlocks): CTA (x, l, q) walks
// the chunks of CTA (x, l) above for the clients of block pair q only and
// writes its (a, b) and (b, a) sub-blocks of CTA (x, l)'s partial (N, N).
template <bool STACKED>
__global__ void __launch_bounds__(NT)
gram_diag_blocked_partial_kernel(const float* __restrict__ W,
                                 const float* __restrict__ V,
                                 const float* __restrict__ p,
                                 float* __restrict__ partial, ClientBlocks cb, int L,
                                 int in_d, long long total) {
  __shared__ float R[kMaxClients][kChunk];
  __shared__ float acc[kMaxClients * kMaxClients];
  const int tid = threadIdx.x;
  const int l = STACKED ? blockIdx.y : 0;
  const int N = cb.N;
  int a, b;
  cb.pair(blockIdx.z, a, b);
  const int ia = a * cb.bs, na = cb.size(a);
  const int jb = b * cb.bs, ncols = cb.size(b);
  const bool diag = a == b;
  const int col0 = diag ? 0 : na;          // first staged row of block b
  const int nres = diag ? na : na + ncols;
  const int NP = na * ncols;
  for (int q = tid; q < NP; q += NT) acc[q] = 0.f;
  __syncthreads();

  // staging: thread t owns element t % kChunk of the chunk for staged
  // rows t / kChunk, t / kChunk + NT / kChunk, ... (coalesced rows of V_il)
  const float* Wl = W + (size_t)l * total;
  const int le = tid % kChunk, r0 = tid / kChunk;
  const long long n_chunks = (total + kChunk - 1) / kChunk;
  for (long long ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long long e = ch * kChunk + le;
    const bool live = e < total;
    const float w = live ? Wl[e] : 0.f;
    const int c = live ? (int)(e % in_d) : 0;
    for (int r = r0; r < nres; r += NT / kChunk) {
      const int i = r < na ? ia + r : jb + (r - na);
      const size_t il = STACKED ? (size_t)i * L + l : i;
      R[r][le] = live ? (w - V[il * total + e]) * p[il * in_d + c] : 0.f;
    }
    __syncthreads();
    contract_pairs(&R[0][0], kChunk, kChunk, na, col0, ncols, diag,
                   [&](int q, int, int, float s) { acc[q] += s; });
    __syncthreads();
  }

  float* out = partial + ((size_t)l * gridDim.x + blockIdx.x) * N * N;
  for (int q = tid; q < NP; q += NT) {
    const int r = q / ncols, cc = q % ncols;
    const int i = ia + r, j = jb + cc;
    if (diag) {
      out[i * N + j] = r <= cc ? acc[q] : acc[cc * ncols + r];
    } else {
      out[i * N + j] = acc[q];
      out[j * N + i] = acc[q];
    }
  }
}

inline long long gram_diag_workspace_floats(int N, int out_d, int in_d, int L) {
  return (long long)L * gram_diag_ctas((long long)out_d * in_d) * N * N;
}

inline int gram_diag_launch(const void* W, const void* V, const void* p,
                            void* workspace, void* G, int N, int L, int out_d,
                            int in_d, void* stream) {
  if (N < 1 || N > 46340 || L < 1 || L > 65535 || out_d < 1 || in_d < 1)
    return (int)cudaErrorInvalidValue;
  const ClientBlocks cb = client_blocks(N);
  if (cb.pairs > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)out_d * in_d;
  const int ctas = gram_diag_ctas(total);
  float* ws = static_cast<float*>(workspace);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* pp = static_cast<const float*>(p);
  if (cb.nb == 1) {
    auto kernel = L == 1 ? gram_diag_partial_kernel<false> : gram_diag_partial_kernel<true>;
    kernel<<<dim3(ctas, L), NT, 0, s>>>(w, v, pp, ws, N, L, in_d, total);
  } else {
    auto kernel = L == 1 ? gram_diag_blocked_partial_kernel<false>
                         : gram_diag_blocked_partial_kernel<true>;
    kernel<<<dim3(ctas, L, cb.pairs), NT, 0, s>>>(w, v, pp, ws, cb, L, in_d, total);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = N * N;
  gram_reduce_kernel<<<reduce_grid(NN, L), 256, 0, s>>>(
      ws, static_cast<float*>(G), ctas, NN);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- Eq. 7

constexpr int kMaxCtasUpdate = 4096;

// One thread per element of a layer's flat (out, in) leaf (grid-stride),
// layer after layer, the client loop inside the thread in the TPU
// kernel's order.
template <bool STACKED>
__global__ void __launch_bounds__(NT)
update_diag_kernel(const float* __restrict__ W, const float* __restrict__ V,
                   const float* __restrict__ p, const float* __restrict__ alpha,
                   float* __restrict__ out, int N, int L, int in_d, long long total,
                   float eta) {
  const long long stride = (long long)gridDim.x * NT;
  for (int l = 0; l < (STACKED ? L : 1); ++l) {
    const float* Wl = W + (size_t)l * total;
    float* Ol = out + (size_t)l * total;
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < total; e += stride) {
      const float w = Wl[e];
      const int c = (int)(e % in_d);
      float acc = 0.f;
      for (int i = 0; i < N; ++i) {
        const size_t il = STACKED ? (size_t)i * L + l : i;
        acc += (-2.0f * alpha[(size_t)l * N + i] * (w - V[il * total + e])) *
               p[il * in_d + c];
      }
      Ol[e] = w + eta * acc;
    }
  }
}

inline int update_diag_launch(const void* W, const void* V, const void* p,
                              const void* alpha, void* out, int N, int L, int out_d,
                              int in_d, float eta, void* stream) {
  if (N < 1 || L < 1 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)out_d * in_d;
  const long long need = (total + NT - 1) / NT;
  const int ctas = (int)(need < kMaxCtasUpdate ? need : kMaxCtasUpdate);
  auto kernel = L == 1 ? update_diag_kernel<false> : update_diag_kernel<true>;
  kernel<<<ctas, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(p), static_cast<const float*>(alpha),
      static_cast<float*>(out), N, L, in_d, total, eta);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- Eq. 11

constexpr int kRowsPerCta = NT / 32;

// One warp per (client, layer, row); V's flat row r = (i*L + l)*out + o.
// With norm the warp sums the row's squares (fixed butterfly), then a
// second pass recomputes the update and writes it scaled.
template <bool NORM, bool STACKED>
__global__ void __launch_bounds__(NT)
v_update_diag_kernel(const float* __restrict__ W, const float* __restrict__ V,
                     const float* __restrict__ p, float* __restrict__ out,
                     int L, int out_d, int in_d, long long rows, float frac,
                     float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                        // warp-uniform
  const long long lo = STACKED ? (long long)L * out_d : out_d;
  const long long i = row / lo, rem = row - i * lo;  // rem = l*out + o
  const long long l = STACKED ? rem / out_d : 0;
  const float* Wr = W + (size_t)rem * in_d;
  const float* Vr = V + (size_t)row * in_d;
  const float* pr = p + (STACKED ? (size_t)i * L + l : (size_t)i) * in_d;
  float* Or = out + (size_t)row * in_d;
  float den = 1.f;
  if (NORM) {
    float ss = 0.f;
    for (int c = lane; c < in_d; c += 32) {
      const float u = (Wr[c] - Vr[c]) * (1.0f - frac * pr[c]);
      ss = fmaf(u, u, ss);
    }
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    den = fmaxf(sqrtf(ss), eps);
  }
  for (int c = lane; c < in_d; c += 32) {
    const float v = Vr[c];
    const float u = (Wr[c] - v) * (1.0f - frac * pr[c]);
    Or[c] = v + (NORM ? u / den : u);
  }
}

inline int v_update_diag_launch(const void* W, const void* V, const void* p,
                                void* out, int N, int L, int out_d, int in_d,
                                float frac, int norm, float eps, void* stream) {
  if (N < 1 || L < 1 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)N * L * out_d;
  const long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  const float* pp = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  auto kernel = norm ? (L == 1 ? v_update_diag_kernel<true, false>
                                : v_update_diag_kernel<true, true>)
                     : (L == 1 ? v_update_diag_kernel<false, false>
                                : v_update_diag_kernel<false, true>);
  kernel<<<(unsigned)ctas, NT, 0, s>>>(w, v, pp, o, L, out_d, in_d, rows, frac, eps);
  return (int)cudaGetLastError();
}

}  // namespace
