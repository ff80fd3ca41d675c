// Shared SIMT tile machinery of the MA-Echo kernels for Hopper (sm_90a),
// plain fp32 FMA on the CUDA cores.  Its users: B5 (Eq. 7 update from
// left factors), B7/B8 (Eq. 11 update), the stacked B11/B14 (Gram and
// Eq. 7 from left factors), B10's Gram past 54 clients (the
// client-blocked launch) and the row-norm pass v_norm_kernel of B16 and
// B17.  The elementwise diagonal kernels (maecho_diag.cuh: B3/B6/B9,
// B12/B15/B18) use only its constants, the client blocking and the
// fixed-order gram_reduce_kernel.  B1 and B4 left it for 3xTF32 wgmma
// with the depth split across the card (maecho_splitk.cuh; B1 then
// contracts by maecho_cross.cuh), B13 and B10 up to 54 clients for
// maecho_tf32.cuh, B2 (on B1's route) and B17 (a persistent grid) for
// that header's left form: the 32 x 32 tiles below give a thread a 2 x 2
// block, about one FMA a shared load, a tenth of the card's fp32 rate
// (B1 at W0: 6.3 TFLOP/s).
//
// Layer axis.  Every launch covers L scan-stacked layers at once
// (L = 1 for an unstacked leaf): W (L, out, in), V (N, L, out, in),
// P (N, L, in, in), alpha (L, N), G (L, N, N).  The grid's z axis
// carries the layer (Gram, Eq. 7) or the (layer, client) pair
// z = l*N + i (Eq. 11), and every offset is 64-bit.  A stacked operand
// (StackedDenseOp, StackedLeftOp) has kStacked = true and a layer(l)
// that shifts its base pointers to layer l; the unstacked operands
// (DenseOp, LeftOp) have kStacked = false, their kernels fold the layer
// arithmetic away and read the operand straight from kernel-parameter
// space, so B1-B8 compile as they did before the layer axis existed (a
// shifted copy of the operand in registers had cost them 4-28 % at the
// MLP's leaves).
//
// Each of them forms, for one client i and one 32x32 (out, in) tile, a
// residual tile
//     R_i[o, c] = sum_{k < depth} L_i[o, k] * Rt_i[k, c]
// with plain fp32 FMA (no TF32).  A dense kernel takes L_i = W - V_i
// and Rt_i = P_i (depth = in); its factored twin takes the compressed
// residual L_i = A_i (N, out, rank) and Rt_i = U_i^T (N, rank, in), so
// the K-loop runs over the projector's rank.  The twins differ only in
// how they load L and Rt, so every kernel body here is a template over
// an operand struct with
//     int depth;
//     __device__ float left(int i, int o, int k) const;   // o < out, k < depth
//     __device__ float right(int i, int k, int c) const;  // k < depth, c < in
// Ragged edges on out, in and depth are masked on load (zero outside the
// leaf, which is exact) and on store, so no operand is ever padded.
//
// The TPU grids ran in order and carried sums across grid steps; Hopper
// runs blocks in no order.  So:
//   - Gram: each CTA parks residual tiles in shared memory (4 KiB a
//     client), writes its part of the tile's partial (N, N) to a
//     workspace, and a second launch sums the partials in tile order: no
//     atomics, so G (and the QP's alpha) is bitwise reproducible.  Up to
//     kMaxClients = 54 clients fit the 227 KiB a block may use, and one
//     CTA per tile parks them all.  Above that the client axis is cut
//     into blocks of at most kBlockClients = 27 (ClientBlocks), and one
//     CTA per tile and pair (a <= b) of blocks parks those two blocks
//     only and writes the (a, b) and (b, a) sub-blocks of the partial;
//     the pair rides grid z beside the layer.  Each entry of G is still
//     one dot product over the same tile in the same order.  The blocked
//     launch is a kernel of its own: up to 54 clients the launch is the
//     kernel without blocks (on an H100 the pair bookkeeping had cost B10
//     19 % at N = 2 through register pressure, 5 % as a template flag).
//   - Eq. 7: the client sum is a loop inside the CTA; alpha is read from
//     device memory (no host sync).
//   - Eq. 11: one CTA per (client, tile).  The optional row norm needed
//     whole rows resident on the TPU; here the first launch stores the
//     unnormalised update and per-tile row sums of squares, and a second
//     launch sums each row in tile order and rescales.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;          // tile edge: out rows, in columns, depth
constexpr int NT = 256;        // threads per CTA; each owns a 2x2 micro-tile
constexpr int kMaxClients = 54;      // clients one Gram CTA can park
constexpr int kBlockClients = 27;    // block size above that: two blocks fit

inline int tiles(int d) { return (d + T - 1) / T; }

// The client axis of a Gram launch cut into nb blocks of bs clients (the
// last may be short): one block of all N when N <= kMaxClients, else
// ceil(N / 27) blocks of near-equal size.  A CTA takes one pair (a <= b)
// of blocks, numbered row by row: pairs = nb (nb + 1) / 2.
struct ClientBlocks {
  int N, bs, nb, pairs;
  __host__ __device__ int parked() const { return nb == 1 ? N : 2 * bs; }
  // pair index -> (a, b), a <= b
  __device__ __forceinline__ void pair(int q, int& a, int& b) const {
    a = 0;
    while (q >= nb - a) {
      q -= nb - a;
      ++a;
    }
    b = a + q;
  }
  __device__ __forceinline__ int size(int a) const { return min(bs, N - a * bs); }
};

inline ClientBlocks client_blocks(int N) {
  if (N <= kMaxClients) return ClientBlocks{N, N, 1, 1};
  const int nb = (N + kBlockClients - 1) / kBlockClients;
  const int bs = (N + nb - 1) / nb;
  const int n_blocks = (N + bs - 1) / bs;
  return ClientBlocks{N, bs, n_blocks, n_blocks * (n_blocks + 1) / 2};
}

struct Stage {                 // one K-step's operand tiles
  float a[T][T + 1];
  float b[T][T];
};

// r = this thread's 2x2 micro-tile of R_i for the tile at (o0, c0).
template <class Op>
__device__ __forceinline__ void residual_tile(const Op& op, int i, int o0, int c0,
                                              int out_d, int in_d, Stage& st,
                                              float r[2][2]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  r[0][0] = r[0][1] = r[1][0] = r[1][1] = 0.f;
  for (int k0 = 0; k0 < op.depth; k0 += T) {
    for (int e = tid; e < T * T; e += NT) {
      const int rr = e / T, c = e % T;
      const int o = o0 + rr, k = k0 + c;
      st.a[rr][c] = (o < out_d && k < op.depth) ? op.left(i, o, k) : 0.f;
      const int kr = k0 + rr, cc = c0 + c;
      st.b[rr][c] = (kr < op.depth && cc < in_d) ? op.right(i, kr, cc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T; ++kk) {
      const float a0 = st.a[ty][kk], a1 = st.a[ty + 16][kk];
      const float b0 = st.b[kk][tx], b1 = st.b[kk][tx + 16];
      r[0][0] = fmaf(a0, b0, r[0][0]);
      r[0][1] = fmaf(a0, b1, r[0][1]);
      r[1][0] = fmaf(a1, b0, r[1][0]);
      r[1][1] = fmaf(a1, b1, r[1][1]);
    }
    __syncthreads();
  }
}

// residual_tile on layer l's operand: the parameter itself when unstacked.
template <class Op>
__device__ __forceinline__ void layer_residual_tile(const Op& op, int l, int i, int o0,
                                                    int c0, int out_d, int in_d,
                                                    Stage& st, float r[2][2]) {
  if constexpr (Op::kStacked)
    residual_tile(op.layer(l), i, o0, c0, out_d, in_d, st, r);
  else
    residual_tile(op, i, o0, c0, out_d, in_d, st, r);
}

// ---------------------------------------------------------------- Gram

constexpr size_t gram_smem_bytes(int parked) {
  return sizeof(float) * (size_t)parked * T * T + sizeof(Stage);
}

// Parks this thread's 2x2 micro-tile r of a residual tile in Ri (T x T).
__device__ __forceinline__ void park_tile(float* Ri, const float r[2][2]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  Ri[ty * T + tx] = r[0][0];
  Ri[ty * T + tx + 16] = r[0][1];
  Ri[(ty + 16) * T + tx] = r[1][0];
  Ri[(ty + 16) * T + tx + 16] = r[1][1];
}

// The pair contraction of every Gram kernel (here and maecho_diag.cuh):
// one warp per pair q = r * nc + c of staged rows r < nr and col0 + c,
// c < nc (only c >= r when both are one block), each a dot over n floats
// of rows ld floats apart.  Lanes stride the rows and a fixed butterfly
// sums them, so the order is deterministic; lane 0 hands (q, r, c, sum)
// to put.
template <class Put>
__device__ __forceinline__ void contract_pairs(const float* rows, int ld, int n, int nr,
                                               int col0, int nc, bool same, Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < nr * nc; q += NT / 32) {
    const int r = q / nc, c = q % nc;
    if (same && c < r) continue;              // warp-uniform
    const float* Ri = rows + (size_t)r * ld;
    const float* Rj = rows + (size_t)(col0 + c) * ld;
    float s = 0.f;
    for (int e = lane; e < n; e += 32) s = fmaf(Ri[e], Rj[e], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) put(q, r, c, s);
  }
}

// One block of all N clients: one CTA per (32x32 tile, layer), z = l.
// Parks the N residual tiles, then one warp per (i <= j) pair contracts
// two of them (contract_pairs).
template <class Op>
__global__ void __launch_bounds__(NT)
gram_partial_kernel(Op op, float* __restrict__ partial, int N, int out_d, int in_d) {
  extern __shared__ float smem[];
  float* rstore = smem;                                  // N x T x T
  Stage& st = *reinterpret_cast<Stage*>(smem + (size_t)N * T * T);
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int l = Op::kStacked ? blockIdx.z : 0;

  for (int i = 0; i < N; ++i) {
    float r[2][2];
    layer_residual_tile(op, l, i, o0, c0, out_d, in_d, st, r);
    park_tile(rstore + (size_t)i * T * T, r);
  }
  __syncthreads();

  const size_t tile = ((size_t)l * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* out = partial + tile * N * N;
  contract_pairs(rstore, T * T, T * T, N, 0, N, true, [&](int, int i, int j, float s) {
    out[i * N + j] = s;
    out[j * N + i] = s;
  });
}

// Client blocks (N > kMaxClients): one CTA per (tile, layer and block
// pair), z = l * pairs + q.  As gram_partial_kernel, on the residual
// tiles of blocks a and b only (a alone when a == b; i <= j inside it),
// writing the (a, b) and (b, a) sub-blocks of the tile's partial.
template <class Op>
__global__ void __launch_bounds__(NT)
gram_blocked_partial_kernel(Op op, float* __restrict__ partial, ClientBlocks cb,
                            int out_d, int in_d) {
  extern __shared__ float smem[];
  const int N = cb.N;
  const int l = Op::kStacked ? blockIdx.z / cb.pairs : 0;
  int a, b;
  cb.pair(blockIdx.z - l * cb.pairs, a, b);
  const int ia = a * cb.bs, na = cb.size(a);
  const int jb = b * cb.bs, ncols = cb.size(b);
  const bool diag = a == b;
  const int col0 = diag ? 0 : na;          // first parked tile of block b
  const int nres = diag ? na : na + ncols;
  float* rstore = smem;                                  // nres x T x T
  Stage& st = *reinterpret_cast<Stage*>(smem + (size_t)cb.parked() * T * T);
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;

  for (int r = 0; r < nres; ++r) {
    float t[2][2];
    const int i = r < na ? ia + r : jb + (r - na);
    layer_residual_tile(op, l, i, o0, c0, out_d, in_d, st, t);
    park_tile(rstore + (size_t)r * T * T, t);
  }
  __syncthreads();

  const size_t tile = ((size_t)l * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* out = partial + tile * N * N;
  contract_pairs(rstore, T * T, T * T, na, col0, ncols, diag,
                 [&](int, int r, int c, float s) {
                   const int i = ia + r, j = jb + c;
                   out[i * N + j] = s;
                   out[j * N + i] = s;
                 });
}

// G[l][e] = sum over layer l's tiles of partial[l][t][e], tiles in index
// order (partials are grouped by layer, n_tiles per layer; l = blockIdx.y).
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ G, int n_tiles, int NN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NN) return;
  const size_t l = blockIdx.y;
  const float* base = partial + l * n_tiles * NN;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += base[(size_t)t * NN + e];
  G[l * NN + e] = s;
}

inline dim3 reduce_grid(int NN, int L) { return dim3((NN + 255) / 256, L); }

// Floats of workspace a Gram launch needs: one partial (N, N) per tile
// and layer.
inline long long gram_workspace_floats(int N, int out_d, int in_d, int L = 1) {
  return (long long)L * tiles(out_d) * tiles(in_d) * N * N;
}

template <class Op>
int gram_launch(const Op& op, void* workspace, void* G, int N, int out_d,
                int in_d, void* stream, int L = 1) {
  if (N < 1 || N > 46340 || out_d < 1 || in_d < 1 || op.depth < 1 || L < 1 ||
      L > (Op::kStacked ? 65535 : 1))
    return (int)cudaErrorInvalidValue;
  const ClientBlocks cb = client_blocks(N);
  if ((long long)L * cb.pairs > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)gram_smem_bytes(cb.parked());
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cb.nb == 1
                        ? cudaFuncSetAttribute(gram_partial_kernel<Op>, attr, smem)
                        : cudaFuncSetAttribute(gram_blocked_partial_kernel<Op>, attr, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles(in_d), tiles(out_d), L * cb.pairs);
  float* ws = static_cast<float*>(workspace);
  if (cb.nb == 1)
    gram_partial_kernel<Op><<<grid, NT, smem, s>>>(op, ws, N, out_d, in_d);
  else
    gram_blocked_partial_kernel<Op><<<grid, NT, smem, s>>>(op, ws, cb, out_d, in_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = N * N;
  gram_reduce_kernel<<<reduce_grid(NN, L), 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(G),
      (int)(grid.x * grid.y), NN);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- Eq. 7

// out = W + eta * sum_i (-2 alpha_i) R_i, one CTA per output tile and
// layer (blockIdx.z).
template <class Op>
__global__ void __launch_bounds__(NT)
update_kernel(Op op, const float* __restrict__ W, const float* __restrict__ alpha,
              float* __restrict__ out, int N, int out_d, int in_d, float eta) {
  __shared__ Stage st;
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int l = Op::kStacked ? blockIdx.z : 0;
  const size_t base = (size_t)l * out_d * in_d;
  const float* al = alpha + (size_t)l * N;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int i = 0; i < N; ++i) {
    float r[2][2];
    layer_residual_tile(op, l, i, o0, c0, out_d, in_d, st, r);
    const float m = -2.0f * al[i];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) acc[a][b] += m * r[a][b];
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int o = o0 + ty + 16 * a, c = c0 + tx + 16 * b;
      if (o < out_d && c < in_d) {
        const size_t idx = base + (size_t)o * in_d + c;
        out[idx] = W[idx] + eta * acc[a][b];
      }
    }
  }
}

template <class Op>
int update_launch(const Op& op, const void* W, const void* alpha, void* out,
                  int N, int out_d, int in_d, float eta, void* stream, int L = 1) {
  if (N < 1 || out_d < 1 || in_d < 1 || op.depth < 1 || L < 1 ||
      L > (Op::kStacked ? 65535 : 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(in_d), tiles(out_d), L);
  update_kernel<Op><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(W), static_cast<const float*>(alpha),
      static_cast<float*>(out), N, out_d, in_d, eta);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- Eq. 11

// u = (W' - V_i) - frac * R_i for one (layer, client, tile), z = l*N + i;
// without norm the launch stores V_i + u, with norm it stores u and the
// tile's per-row sums of squares (summed in column order) to rowss
// (N, L, out, n_col_tiles).
template <bool NORM, class Op>
__global__ void __launch_bounds__(NT)
v_update_kernel(Op op, const float* __restrict__ W, const float* __restrict__ V,
                float* __restrict__ out, float* __restrict__ rowss, int N, int L,
                int out_d, int in_d, float frac) {
  __shared__ Stage st;
  __shared__ float Sq[T][T + 1];
  const int l = Op::kStacked ? blockIdx.z / N : 0;
  const int i = Op::kStacked ? blockIdx.z % N : blockIdx.z;
  const int o0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t OI = (size_t)out_d * in_d;
  const size_t il = Op::kStacked ? (size_t)i * L + l : i;  // (client, layer) of V
  const float* Vi = V + il * OI;
  float* Oi = out + il * OI;
  const float* Wl = W + (size_t)l * OI;

  float r[2][2];
  layer_residual_tile(op, l, i, o0, c0, out_d, in_d, st, r);

#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int lr = ty + 16 * a, lc = tx + 16 * b;
      const int o = o0 + lr, c = c0 + lc;
      float u = 0.f;
      if (o < out_d && c < in_d) {
        const size_t idx = (size_t)o * in_d + c;
        const float v = Vi[idx];
        u = (Wl[idx] - v) - frac * r[a][b];
        Oi[idx] = NORM ? u : v + u;
      }
      if (NORM) Sq[lr][lc] = u * u;
    }
  }
  if (NORM) {
    __syncthreads();
    if (tid < T && o0 + tid < out_d) {
      float s = 0.f;
      for (int c = 0; c < T; ++c) s += Sq[tid][c];
      rowss[(il * out_d + o0 + tid) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// One CTA per (client, layer, row): sum the row's tile partials in tile order,
// then V_i' = V_i + u / max(||u||, eps) over the row.
__global__ void v_norm_kernel(const float* __restrict__ V, float* __restrict__ out,
                              const float* __restrict__ rowss, int in_d,
                              int n_ct, float eps) {
  const size_t row = blockIdx.x;
  float ss = 0.f;
  for (int t = 0; t < n_ct; ++t) ss += rowss[row * n_ct + t];
  const float den = fmaxf(sqrtf(ss), eps);
  for (int c = threadIdx.x; c < in_d; c += blockDim.x) {
    const size_t idx = row * in_d + c;
    out[idx] = V[idx] + out[idx] / den;
  }
}

// Floats of workspace an Eq. 11 launch needs: per-row, per-column-tile
// sums of squares when norm is on, none otherwise.
inline long long v_update_workspace_floats(int N, int out_d, int in_d, int norm,
                                           int L = 1) {
  return norm ? (long long)N * L * out_d * tiles(in_d) : 0;
}

template <class Op>
int v_update_launch(const Op& op, const void* W, const void* V, void* out,
                    void* workspace, int N, int out_d, int in_d, float frac,
                    int norm, float eps, void* stream, int L = 1) {
  const long long rows = (long long)N * L * out_d;
  if (N < 1 || L < 1 || L > (Op::kStacked ? 65535 : 1) || (long long)N * L > 65535 ||
      out_d < 1 || in_d < 1 || op.depth < 1 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles(in_d), tiles(out_d), N * L);
  const float* w = static_cast<const float*>(W);
  const float* v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (!norm) {
    v_update_kernel<false, Op><<<grid, NT, 0, s>>>(op, w, v, o, ws, N, L, out_d,
                                                   in_d, frac);
    return (int)cudaGetLastError();
  }
  v_update_kernel<true, Op><<<grid, NT, 0, s>>>(op, w, v, o, ws, N, L, out_d, in_d,
                                                frac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  v_norm_kernel<<<(unsigned)rows, 256, 0, s>>>(v, o, ws, in_d, (int)grid.x, eps);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- operands

// Dense projector: L_i = W - V_i (out, in), Rt_i = P_i (in, in).
struct DenseOp {
  static constexpr bool kStacked = false;
  const float* W;
  const float* V;
  const float* P;
  int in_d;
  size_t OI;
  int depth;                   // = in_d
  __device__ __forceinline__ float left(int i, int o, int k) const {
    const size_t idx = (size_t)o * in_d + k;
    return W[idx] - V[i * OI + idx];
  }
  __device__ __forceinline__ float right(int i, int k, int c) const {
    return P[(size_t)i * in_d * in_d + (size_t)k * in_d + c];
  }
};

inline DenseOp dense_op(const void* W, const void* V, const void* P, int out_d,
                        int in_d) {
  return DenseOp{static_cast<const float*>(W), static_cast<const float*>(V),
                 static_cast<const float*>(P), in_d, (size_t)out_d * in_d, in_d};
}

// The dense projector of a stacked leaf: layer 0 of W (L, out, in),
// V (N, L, out, in), P (N, L, in, in); layer(l) moves the bases to layer l.
struct StackedDenseOp {
  static constexpr bool kStacked = true;
  const float* W;
  const float* V;
  const float* P;
  int in_d;
  size_t OI;                   // out*in: one layer of W
  size_t vstride, pstride;     // client strides of V and P: L*out*in, L*in*in
  int depth;                   // = in_d
  __device__ __forceinline__ float left(int i, int o, int k) const {
    const size_t idx = (size_t)o * in_d + k;
    return W[idx] - V[i * vstride + idx];
  }
  __device__ __forceinline__ float right(int i, int k, int c) const {
    return P[i * pstride + (size_t)k * in_d + c];
  }
  __device__ __forceinline__ StackedDenseOp layer(int l) const {
    StackedDenseOp op = *this;
    op.W += l * OI;
    op.V += l * OI;
    op.P += (size_t)l * in_d * in_d;
    return op;
  }
};

inline StackedDenseOp stacked_dense_op(const void* W, const void* V, const void* P,
                                       int out_d, int in_d, int L) {
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;
  return StackedDenseOp{static_cast<const float*>(W), static_cast<const float*>(V),
                        static_cast<const float*>(P), in_d, OI, L * OI, L * II, in_d};
}

// Factored projector P_i = U_i diag(s_i) U_i^T: L_i = A_i (out, rank), the
// compressed residual, and Rt_i = U_i^T (rank, in).
struct LeftOp {
  static constexpr bool kStacked = false;
  const float* A;
  const float* UT;
  int out_d, in_d;
  int depth;                   // the rank
  __device__ __forceinline__ float left(int i, int o, int k) const {
    return A[((size_t)i * out_d + o) * depth + k];
  }
  __device__ __forceinline__ float right(int i, int k, int c) const {
    return UT[((size_t)i * depth + k) * in_d + c];
  }
};

inline LeftOp left_op(const void* A, const void* UT, int out_d, int in_d, int rank) {
  return LeftOp{static_cast<const float*>(A), static_cast<const float*>(UT),
                out_d, in_d, rank};
}

// The factored projector of a stacked leaf: layer 0 of A (N, L, out, rank)
// and UT (N, L, rank, in); layer(l) moves the bases to layer l.
struct StackedLeftOp {
  static constexpr bool kStacked = true;
  const float* A;
  const float* UT;
  int out_d, in_d;
  size_t astride, ustride;     // client strides of A and UT: L*out*rank, L*rank*in
  int depth;                   // the rank
  __device__ __forceinline__ float left(int i, int o, int k) const {
    return A[i * astride + (size_t)o * depth + k];
  }
  __device__ __forceinline__ float right(int i, int k, int c) const {
    return UT[i * ustride + (size_t)k * in_d + c];
  }
  __device__ __forceinline__ StackedLeftOp layer(int l) const {
    StackedLeftOp op = *this;
    op.A += (size_t)l * out_d * depth;
    op.UT += (size_t)l * depth * in_d;
    return op;
  }
};

inline StackedLeftOp stacked_left_op(const void* A, const void* UT, int out_d,
                                     int in_d, int rank, int L) {
  return StackedLeftOp{static_cast<const float*>(A), static_cast<const float*>(UT),
                       out_d, in_d, (size_t)L * out_d * rank,
                       (size_t)L * rank * in_d, rank};
}

}  // namespace
