// B4 — MA-Echo Eq. 7 global update, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maecho_update.py:58
// (`maecho_update`, pl.pallas_call at :76):
//     W' = W + eta * ( -sum_i 2 alpha_i (W - V_i) P_i )
// with W (out, in), V (N, out, in), P (N, in, in), alpha (N,), fp32 in
// and out, held to the fp32 tolerances.
//
// Design: 3xTF32 on the tensor cores (wgmma, maecho_tf32.cuh's staging,
// as B13), with the (tile, client, depth step) stages split across the
// card in equal shares, one CTA a share, and a fixed-order fix-up of the
// tiles a share edge crosses (maecho_splitk.cuh).  Eq. 7 is linear in
// each residual, so a share sums its stages straight into the output's
// running sum, each stage's fresh accumulator FMA'd times m_i = -2
// alpha_i (alpha read from device memory: no host sync).  No atomics: the
// output is bitwise reproducible.  The SIMT body this replaces
// (maecho_tile.cuh's update_kernel, one CTA a 32 x 32 tile) took 0.3045 ms
// at W0 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
//
// Bound.  2*N*out*in^2 flops against ~4*(N*in^2 + N*out*in + 2*out*in)
// bytes: at W0 (400x784, N=4) 1.97 GFLOP on ~15 MB, at the 3xTF32 rate
// (495/3 TFLOP/s) 0.0119 ms, bound by operations.

#include "maecho_splitk.cuh"

extern "C" {

// Floats of workspace a launch needs (two partial tiles a CTA); -1 when
// the device cannot be queried.
long long maecho_update_workspace_floats(int N, int out_d, int in_d) {
  const tf32::Split s = tf32::splitk_plan(N, out_d, in_d, false);
  return s.C < 1 ? -1 : tf32::splitk_slot_floats(s);
}

int maecho_update_launch(const void* W, const void* V, const void* P, const void* alpha,
                         void* workspace, void* out, int N, int out_d, int in_d, float eta,
                         void* stream) {
  using namespace tf32;
  const Split s = splitk_plan(N, out_d, in_d, false);
  if (s.C < 0) return (int)cudaErrorInvalidValue;
  if (s.C == 0) return (int)cudaErrorInvalidDevice;
  return splitk_launch<false>(s, static_cast<const float*>(W), static_cast<const float*>(V),
                              static_cast<const float*>(P), static_cast<const float*>(alpha),
                              static_cast<float*>(out), static_cast<float*>(workspace), N,
                              out_d, in_d, eta, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
