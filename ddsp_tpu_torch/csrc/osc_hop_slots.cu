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
// Two fills (osc_fill.cuh), each an instantiation: kExact, one sinf per
// harmonic (the XLA path's function), and kRot, _kernel_banked's own fill
// (_fill_sine_banks_cat, :58): tiles of 8 harmonics from h_start + 1, the
// first seeded exactly, every later one the previous rotated by
// e^{i 2 pi 8 x}, rounded one IEEE operation at a time as the plain
// version (ops/osc_fill.py) is.  The rotation costs 6 operations a point
// against a sine's ~24.
//
// Left for later: tensor cores, persistent blocks.

#include <cuda_runtime.h>

#include "osc_fill.cuh"

namespace {

constexpr int kThreads = 128;

template <int kFill>
__global__ void __launch_bounds__(kThreads)
osc_hop_slots_kernel(const float* __restrict__ phase,   // (N, hop)
                     const float* __restrict__ amps_l,  // (N, H)
                     const float* __restrict__ amps_m,  // (N, H)
                     const float* __restrict__ amps_r,  // (N, H)
                     const float* __restrict__ loud,    // (N, 3)
                     const float* __restrict__ w,       // (hop, 3)
                     float* __restrict__ out,           // (N, hop)
                     int hop, int n_harm, int h_start) {
  extern __shared__ float amps[];  // [3][hb]: this slot's window rows, zero-padded
  const int hb = (n_harm + 7) / 8 * 8;
  const size_t slot = blockIdx.y;
  const float* rows[3] = {amps_l + slot * n_harm, amps_m + slot * n_harm,
                          amps_r + slot * n_harm};
  for (int k = 0; k < 3; ++k) {
    for (int i = threadIdx.x; i < hb; i += blockDim.x) {
      amps[k * hb + i] = i < n_harm ? rows[k][i] : 0.0f;
    }
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= hop) return;

  const float* a_l = amps;
  const float* a_m = amps + hb;
  const float* a_r = amps + 2 * hb;
  osc::TileFill<kFill, false> fill;
  fill.init(phase[slot * hop + j], h_start, 8, 1 << 30);

  float s_l = 0.0f, s_m = 0.0f, s_r = 0.0f;
  for (int g = 0; g < hb / 8; ++g) {
    fill.tile(g);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * g + i;
      s_l = fmaf(a_l[k], fill.s[i], s_l);
      s_m = fmaf(a_m[k], fill.s[i], s_m);
      s_r = fmaf(a_r[k], fill.s[i], s_r);
    }
  }

  const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
  const float* ld = loud + 3 * slot;
  const float harm = w0 * s_l + w1 * s_m + w2 * s_r;
  const float loud_up = w0 * ld[0] + w1 * ld[1] + w2 * ld[2];
  out[slot * hop + j] = loud_up * harm;
}

template <int kFill>
cudaError_t launch(const float* phase, const float* amps_l, const float* amps_m,
                   const float* amps_r, const float* loud, const float* w, float* out,
                   int n, int hop, int n_harm, int h_start, cudaStream_t stream) {
  const dim3 grid((hop + kThreads - 1) / kThreads, n);
  const size_t smem = 3 * static_cast<size_t>((n_harm + 7) / 8 * 8) * sizeof(float);
  osc_hop_slots_kernel<kFill><<<grid, kThreads, smem, stream>>>(
      phase, amps_l, amps_m, amps_r, loud, w, out, hop, n_harm, h_start);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes: n <= 65535 slots, h_start + n_harm <= 2048;
// fill 0 = exact, 1 = rot (osc::Fill).
extern "C" int osc_hop_slots(const float* phase, const float* amps_l,
                             const float* amps_m, const float* amps_r,
                             const float* loud, const float* w, float* out,
                             int n, int hop, int n_harm, int h_start, int fill,
                             void* stream) {
  if (n == 0 || hop == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fill == osc::kExact) {
    err = launch<osc::kExact>(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop, n_harm,
                              h_start, s);
  } else if (fill == osc::kRot) {
    err = launch<osc::kRot>(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop, n_harm,
                            h_start, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
