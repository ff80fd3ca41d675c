// B10 — MA-Echo Eq. 6 Grams of a scan-stacked leaf, one launch for all
// layers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_gram.py:283
// (`maecho_gram_stacked`, pl.pallas_call at :299):
//     G[l, i, j] = <R_li, R_lj>,   R_li = (W_l - V_il) P_il
// with W (L, out, in), V (N, L, out, in), P (N, L, in, in), all fp32,
// -> G (L, N, N), held to the fp32 tolerances.
//
// Route, by the number of clients N:
//   - N <= 54 (kMaxClients): gram_tf32_kernel below, then
//     gram_reduce_f64_kernel.  Only the residual product runs on the
//     tensor cores (3xTF32 wgmma, B16's stage machinery in
//     maecho_tf32.cuh, small products first); the pair contraction stays
//     fp32 in a fixed order, and the tile partials are summed in fp64.
//   - N > 54: the SIMT blocked launch of maecho_tile.cuh
//     (gram_blocked_partial_kernel over StackedDenseOp, 32x32 tiles, the
//     client axis in blocks of <= 27), then its fp32 gram_reduce_kernel.
//
// Design of gram_tf32_kernel.  A persistent grid: one CTA of two consumer
// warpgroups per SM (at most one per 128 (out) x 128 (in) tile), CTA b
// taking tiles b, b + grid, b + 2 grid, ... of the (layer, out tile, in
// tile) order.  For each tile it forms R_i client by client in registers,
// each client's depth in 32-deep stages with a fresh accumulator a stage
// added in fp32, all of the CTA's (tile, client, stage) sequence as one
// pipeline (run_stages, walked by cursors, not divisions: 6.40 -> 5.47 ms
// at w_gate on an NVIDIA H100): copies run two stages ahead across client
// and tile boundaries, and a client's epilogue runs while the next
// stage's products do.  A Gram needs every client's tile at once, and B16's
// staging leaves no shared memory for 64 KiB tiles, so each CTA has a
// scratch slab of (N - 1) x 64 KiB in the workspace (8.4 MB over 132 CTAs
// a client: L2-resident at small N).  After client i's depth, each thread
// forms <R_i, R_j> for j <= i over its own 64 accumulator registers,
// against the fragments of earlier clients it wrote to the slab itself
// (thread-major: coalesced, and read back by the thread that wrote them,
// so no barrier), then writes its R_i fragment there (not for the last
// client).  A fixed xor butterfly in each warp and the warps in index
// order reduce each pair over the CTA; the tile's (N, N) partial goes to
// the workspace, and gram_reduce_f64_kernel sums each layer's partials in
// tile order in fp64, rounding once (in fp32, as maecho_tile.cuh's
// gram_reduce_kernel does, the sum over w_gate's 266 tiles had put B10's
// error against float64 at 9x the plain version's).  No atomics, and a
// tile's partial does not depend on which CTA formed it: G is bitwise
// reproducible, and layer l's Gram equals an L = 1 launch on layer l's
// slices.
//
// Bound.  2*N*L*out*in^2 flops against ~4*L*(out*in*(N+1) + N*in^2) bytes.
// At Qwen2-0.5B's w_gate (L=24, 4864x896, N=2) 374.9 GFLOP; at the 3xTF32
// rate (495/3 TFLOP/s) 2.27 ms, by operations.  The SIMT body this
// replaces for N <= 54 (maecho_tile.cuh's gram_partial_kernel) took
// 32.3 ms there on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).

#include "maecho_tile.cuh"
#include "maecho_tf32.cuh"

namespace {
namespace tf32 {

constexpr int kFrag = 64 * kThreads;                 // floats of one residual tile
constexpr int kGramSmem = kSmem + 8 * kMaxClients * 4;   // + per-warp pair sums

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gram_tf32_kernel(const float* __restrict__ W, const float* __restrict__ V,
                 const float* __restrict__ P, float* __restrict__ partial,
                 float* __restrict__ scratch, int N, int L, int out_d, int in_d,
                 int tiles_per_layer, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem + 2 * kRawBytes + 2 * kPlaneBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = tiles128(in_d), nk = (in_d + kBK - 1) / kBK;
  const int mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const size_t OI = (size_t)out_d * in_d, II = (size_t)in_d * in_d;
  // this thread's column of the CTA's slab: fragment of client j, register e
  // at slab[(j * 64 + e) * kThreads]
  float* slab = scratch + (size_t)blockIdx.x * (N - 1) * kFrag + tid;

  // Stages are loaded, and finish, in order: two cursors (tile, client,
  // depth step) walk them without a division a stage.  The load cursor's
  // tile coordinates are refreshed once a tile.
  int lt = blockIdx.x, li = 0, ls = 0, ll = 0, lo0 = 0, lc0 = 0;   // next stage to load
  auto tile_at = [&]() {
    ll = lt / tiles_per_layer;
    const int tt = lt - ll * tiles_per_layer, by = tt / ct;
    lo0 = by * 128;
    lc0 = (tt - by * ct) * 128;
  };
  tile_at();
  int et = blockIdx.x, ei = 0, es = 0;                           // next stage to finish

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  run_stages(
      DenseStage<kVec>{}, smem, mine * N * nk, out_d, in_d,
      [&](int) {
        const size_t il = (size_t)li * L + ll;
        const StageRef r{W + ll * OI, V + il * OI, P + il * II, lo0, lc0, ls * kBK};
        if (++ls == nk) {
          ls = 0;
          if (++li == N) {
            li = 0;
            lt += gridDim.x;
            tile_at();
          }
        }
        return r;
      },
      [&](int, float(&part)[64]) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];
      },
      [&](int) {
        if (++es < nk) return;                     // client i's depth is not done
        es = 0;
        const int i = ei, t = et;
        if (++ei == N) {
          ei = 0;
          et += gridDim.x;
        }
        __syncthreads();                           // red of the last client is read
        for (int j = 0; j <= i; ++j) {
          float s = 0.f;
          if (j < i) {
            const float* Rj = slab + (size_t)j * kFrag;
#pragma unroll
            for (int e = 0; e < 64; ++e) s = fmaf(acc[e], Rj[e * kThreads], s);
          } else {
#pragma unroll
            for (int e = 0; e < 64; ++e) s = fmaf(acc[e], acc[e], s);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) red[warp * kMaxClients + j] = s;
        }
        if (i < N - 1) {
          float* Ri = slab + (size_t)i * kFrag;
#pragma unroll
          for (int e = 0; e < 64; ++e) Ri[e * kThreads] = acc[e];
        }
        __syncthreads();
        if (tid <= i) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kThreads / 32; ++w) s += red[w * kMaxClients + tid];
          float* out = partial + (size_t)t * N * N;
          out[i * N + tid] = s;
          out[tid * N + i] = s;
        }
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      });
}

// G[l][e] = sum over layer l's tiles of partial[l][t][e], tiles in index
// order, in fp64 (l = blockIdx.y).
__global__ void gram_reduce_f64_kernel(const float* __restrict__ partial,
                                       float* __restrict__ G, int n_tiles, int NN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NN) return;
  const size_t l = blockIdx.y;
  const float* base = partial + l * n_tiles * NN;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s += base[(size_t)t * NN + e];
  G[l * NN + e] = (float)s;
}

// CTAs of the persistent grid: one an SM (the stage buffers fill an SM's
// shared memory), at most one a tile; -1 when the device cannot be
// queried.
inline int persistent_ctas(long long n_tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    return -1;
  return (int)(n_tiles < sms ? n_tiles : sms);
}

// Floats of the tile partials, rounded up to 256 bytes (the slab follows).
inline long long partial_floats(int N, int L, int out_d, int in_d) {
  const long long f = (long long)L * tiles128(out_d) * tiles128(in_d) * N * N;
  return (f + 63) / 64 * 64;
}

}  // namespace tf32
}  // namespace

extern "C" {

// Floats of workspace a launch needs: for N <= 54 one (N, N) partial per
// 128 x 128 tile and layer, then the persistent CTAs' slabs of N - 1
// residual tiles; above, the blocked route's partials per 32 x 32 tile.
long long maecho_gram_stacked_workspace_floats(int N, int L, int out_d, int in_d) {
  using namespace tf32;
  if (N > kMaxClients) return gram_workspace_floats(N, out_d, in_d, L);
  const int ctas = persistent_ctas((long long)L * tiles128(out_d) * tiles128(in_d));
  if (ctas < 1) return -1;
  return partial_floats(N, L, out_d, in_d) + (long long)ctas * (N - 1) * kFrag;
}

int maecho_gram_stacked_launch(const void* W, const void* V, const void* P,
                               void* workspace, void* G, int N, int L, int out_d,
                               int in_d, void* stream) {
  using namespace tf32;
  if (N > kMaxClients)
    return gram_launch(stacked_dense_op(W, V, P, out_d, in_d, L), workspace, G, N, out_d,
                       in_d, stream, L);
  if (N < 1 || L < 1 || L > 65535 || out_d < 1 || in_d < 1) return (int)cudaErrorInvalidValue;
  const long long tpl = (long long)tiles128(out_d) * tiles128(in_d);
  const long long n_tiles = L * tpl;
  const long long stages = n_tiles * N * ((in_d + kBK - 1) / kBK);
  if (stages > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int ctas = persistent_ctas(n_tiles);
  if (ctas < 1) return (int)cudaErrorInvalidDevice;
  auto kernel = vec_ok(in_d, W, V, P) ? gram_tf32_kernel<true> : gram_tf32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGramSmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  kernel<<<ctas, kThreads, kGramSmem, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(V),
      static_cast<const float*>(P), ws, ws + partial_floats(N, L, out_d, in_d), N, L, out_d,
      in_d, (int)tpl, (int)n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = N * N;
  gram_reduce_f64_kernel<<<reduce_grid(NN, L), 256, 0, s>>>(ws, static_cast<float*>(G),
                                                            (int)tpl, NN);
  return (int)cudaGetLastError();
}

}  // extern "C"
