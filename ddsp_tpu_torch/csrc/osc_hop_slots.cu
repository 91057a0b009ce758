// osc_hop_slots: one hop of harmonic audio for each of N serving slots.
//
// Replaces ddsp_tpu/ops/pallas/oscillator.py:_kernel_banked, as reached
// through pallas_render_hop_slots (the multi-stream serving hop) and
// through _pallas_forward(impl='banked') (offline: one row per frame of the
// batch, with the harmonic offset h_start, _kernel_banked's h0_ref).
//
//   out[n, j] = (sum_k w[j,k] * loud[n,k])
//             * sum_k w[j,k] * sum_h amps_k[n,h]
//                            * sin(2 pi (h_start+h+1) phase[n,j])
//
// for k over the row's (previous, current, next) frames, h over harmonics.
//
// What bounds it on an H100: arithmetic.  Each (sample, harmonic) point
// costs one sine of an exactly reduced harmonic phase plus three window
// multiply-adds, while the inputs are only the (N, hop) phase, 3 x (N, H)
// amplitudes and the (N, hop) output: ~1.6 MB at N=256, hop 512, H=180,
// against 23.6 M points.  The TPU kernel exists to keep the (N, hop, H)
// sine tensor out of HBM and to hand the harmonic sum to the MXU; here the
// same is done by keeping each sine in a register and folding it into
// three running sums at once, so no harmonic-resolved tensor is ever
// stored.  A slot's three amplitude rows sit in shared memory (read as
// warp-wide broadcasts) and each thread owns one output sample.
//
// Accuracy: every harmonic's phase is formed as in harmonic_sines
// (ops/oscillator.py, osc_phase.cuh): phase = hi + lo with hi on the 1/4096
// grid, so h * hi is exact in float32 for h <= 2048, and the sine is the
// accurate sinf.  Build without --use_fast_math: its __sinf loses the accuracy the
// split buys.
//
// Left for later: seeding exactly every 8 harmonics and rotating in
// between (fewer instructions per point), tensor cores, persistent blocks.

#include <cuda_runtime.h>

#include "osc_phase.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
osc_hop_slots_kernel(const float* __restrict__ phase,   // (N, hop)
                     const float* __restrict__ amps_l,  // (N, H)
                     const float* __restrict__ amps_m,  // (N, H)
                     const float* __restrict__ amps_r,  // (N, H)
                     const float* __restrict__ loud,    // (N, 3)
                     const float* __restrict__ w,       // (hop, 3)
                     float* __restrict__ out,           // (N, hop)
                     int hop, int n_harm, int h_start) {
  extern __shared__ float amps[];  // [3][n_harm]: this slot's window rows
  const size_t slot = blockIdx.y;
  const float* rows[3] = {amps_l + slot * n_harm, amps_m + slot * n_harm,
                          amps_r + slot * n_harm};
  for (int k = 0; k < 3; ++k) {
    for (int i = threadIdx.x; i < n_harm; i += blockDim.x) {
      amps[k * n_harm + i] = rows[k][i];
    }
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= hop) return;

  float hi, lo;
  osc::split_phase(phase[slot * hop + j], &hi, &lo);
  const float* a_l = amps;
  const float* a_m = amps + n_harm;
  const float* a_r = amps + 2 * n_harm;

  float s_l = 0.0f, s_m = 0.0f, s_r = 0.0f;
  for (int i = 0; i < n_harm; ++i) {
    const float h = static_cast<float>(h_start + i + 1);
    const float s = sinf(osc::kTwoPi * osc::harmonic_frac(hi, lo, h));
    s_l = fmaf(a_l[i], s, s_l);
    s_m = fmaf(a_m[i], s, s_m);
    s_r = fmaf(a_r[i], s, s_r);
  }

  const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
  const float* ld = loud + 3 * slot;
  const float harm = w0 * s_l + w1 * s_m + w2 * s_r;
  const float loud_up = w0 * ld[0] + w1 * ld[1] + w2 * ld[2];
  out[slot * hop + j] = loud_up * harm;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes: n <= 65535 slots, h_start + n_harm <= 2048.
extern "C" int osc_hop_slots(const float* phase, const float* amps_l,
                             const float* amps_m, const float* amps_r,
                             const float* loud, const float* w, float* out,
                             int n, int hop, int n_harm, int h_start,
                             void* stream) {
  if (n == 0 || hop == 0) return 0;
  const dim3 grid((hop + kThreads - 1) / kThreads, n);
  const size_t smem = 3 * static_cast<size_t>(n_harm) * sizeof(float);
  osc_hop_slots_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      phase, amps_l, amps_m, amps_r, loud, w, out, hop, n_harm, h_start);
  return static_cast<int>(cudaGetLastError());
}
