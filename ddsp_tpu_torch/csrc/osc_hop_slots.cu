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
// What bounds it on an H100: issue slots.  Each (sample, harmonic) point
// costs the fill (6 unfused operations on the rotation fill, a sine on the
// exact one) plus three window multiply-adds, while the inputs are only the
// (N, hop) phase, 3 x (N, H) amplitudes and the (N, hop) output: ~1.6 MB at
// N=256, hop 512, H=180, against 23.6 M points.  The TPU kernel exists to
// keep the (N, hop, H) sine tensor out of HBM and to hand the harmonic sum
// to the MXU; here each sine stays in a register and is folded into three
// running sums at once.
//
// The body is K1's (osc::render_row, osc_fwd.cuh): a thread renders kQ
// samples of its slot, each with the 8 slots of a harmonic tile on one
// osc::SeedClock, and reads the slot's three amplitude rows from shared
// memory as 16-byte broadcasts shared by its samples.  The sums run in the
// order of the one-sample-a-thread kernel it replaced (over tiles, then the
// 8 slots of a tile, a chain per window), so the output keeps its bits on
// both fills, and at every kQ.  K5 differs from K1 only in where a row's
// amplitudes and loudness come from: one row of each of three (N, H)
// arrays, and (N, 3) loudness.
//
// The serving hop is small: 256 slots x 512 samples is 1,024 warps at 4
// samples a thread, under 8 an SM on 132 SMs.  Measured at 256, 1024 and
// 2048 slots and at the frame rows of a training batch, 2 samples a thread
// (osc::kFwdSamples, osc_fwd.cuh) is the fastest or within 2 % of it at
// every N, so the launch takes 2 at every N; osc_hop_slots_shape launches
// any of 1, 2 or 4 for that sweep (utils/osc_kernel_ab.py).
//
// Accuracy: every harmonic's phase is formed as in harmonic_sines
// (ops/oscillator.py, osc_phase.cuh): phase = hi + lo with hi on the 1/4096
// grid, so h * hi is exact in float32 for h <= 2048, and the sine is the
// accurate sinf.  Build without --use_fast_math: its __sinf loses the
// accuracy the split buys.
//
// Two fills (osc_fill.cuh), each an instantiation: kExact, one sinf per
// harmonic (the XLA path's function), and kRot, _kernel_banked's own fill
// (_fill_sine_banks_cat, :58): tiles of 8 harmonics from h_start + 1, the
// first seeded exactly, every later one the previous rotated by
// e^{i 2 pi 8 x}, rounded one IEEE operation at a time as the plain
// version (ops/osc_fill.py) is.

#include <cuda_runtime.h>

#include "osc_fwd.cuh"

namespace {

constexpr int kWholeRow = 1 << 30;  // kRot: one chunk, seeded at tile 0 only

template <int kFill, int kQ>
__global__ void __launch_bounds__(osc::kFwdMaxThreads)
osc_hop_slots_kernel(const float* __restrict__ phase,   // (N, hop)
                     const float* __restrict__ amps_l,  // (N, H)
                     const float* __restrict__ amps_m,  // (N, H)
                     const float* __restrict__ amps_r,  // (N, H)
                     const float* __restrict__ loud,    // (N, 3)
                     const float* __restrict__ w,       // (hop, 3)
                     float* __restrict__ out,           // (N, hop)
                     int hop, int n_harm, int h_start) {
  const size_t slot = blockIdx.y;
  const size_t row = slot * n_harm;
  osc::render_row<kFill, false, kQ>(amps_l + row, amps_m + row, amps_r + row,
                                    loud + 3 * slot, phase + slot * hop, w, out + slot * hop,
                                    blockIdx.x, hop, n_harm, h_start, 8, kWholeRow);
}

template <int kFill, int kQ>
cudaError_t launch(const float* phase, const float* amps_l, const float* amps_m,
                   const float* amps_r, const float* loud, const float* w, float* out,
                   int n, int hop, int n_harm, int h_start, int max_threads,
                   cudaStream_t stream) {
  const osc::FwdShape shape = osc::fwd_shape(hop, kQ, max_threads);
  const dim3 grid(shape.tiles, n);
  osc_hop_slots_kernel<kFill, kQ>
      <<<grid, shape.threads, osc::fwd_smem_bytes(n_harm), stream>>>(
          phase, amps_l, amps_m, amps_r, loud, w, out, hop, n_harm, h_start);
  return cudaGetLastError();
}

template <int kFill>
cudaError_t launch_q(int q, int max_threads, const float* phase, const float* amps_l,
                     const float* amps_m, const float* amps_r, const float* loud,
                     const float* w, float* out, int n, int hop, int n_harm, int h_start,
                     cudaStream_t stream) {
  if (max_threads % 32 != 0 || max_threads < 32 || max_threads > osc::kFwdMaxThreads) {
    return cudaErrorInvalidValue;
  }
  switch (q) {
    case 1: return launch<kFill, 1>(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop,
                                    n_harm, h_start, max_threads, stream);
    case 2: return launch<kFill, 2>(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop,
                                    n_harm, h_start, max_threads, stream);
    case 4: return launch<kFill, 4>(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop,
                                    n_harm, h_start, max_threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` with q samples a thread (1, 2 or 4) in blocks of
// at most max_threads (32, 64, 96 or 128) and returns cudaGetLastError()
// (0 on success).  The caller has checked shapes: n <= 65535 slots,
// h_start + n_harm <= 2048; fill 0 = exact, 1 = rot (osc::Fill).  Every
// shape computes the same bits.
extern "C" int osc_hop_slots_shape(const float* phase, const float* amps_l,
                                   const float* amps_m, const float* amps_r,
                                   const float* loud, const float* w, float* out,
                                   int n, int hop, int n_harm, int h_start, int fill,
                                   int q, int max_threads, void* stream) {
  if (n == 0 || hop == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fill == osc::kExact) {
    err = launch_q<osc::kExact>(q, max_threads, phase, amps_l, amps_m, amps_r, loud, w, out,
                                n, hop, n_harm, h_start, s);
  } else if (fill == osc::kRot) {
    err = launch_q<osc::kRot>(q, max_threads, phase, amps_l, amps_m, amps_r, loud, w, out, n,
                              hop, n_harm, h_start, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// osc_hop_slots_shape at osc::kFwdSamples a thread in blocks of up to 128.
extern "C" int osc_hop_slots(const float* phase, const float* amps_l,
                             const float* amps_m, const float* amps_r,
                             const float* loud, const float* w, float* out,
                             int n, int hop, int n_harm, int h_start, int fill,
                             void* stream) {
  return osc_hop_slots_shape(phase, amps_l, amps_m, amps_r, loud, w, out, n, hop, n_harm,
                             h_start, fill, osc::kFwdSamples, osc::kFwdMaxThreads, stream);
}
