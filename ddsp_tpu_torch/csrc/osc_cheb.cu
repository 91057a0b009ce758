// osc_cheb: the offline harmonic render by the Chebyshev three-term
// recurrence over harmonics (osc_cheb_fwd).
//
// Replaces ddsp_tpu/ops/pallas/oscillator.py:_kernel_cheb (K7), launched by
// _pallas_forward(impl='cheb') (:642-647).  For batch row b, frame t and
// sample j of the hop, with x = phase[b, t, j] and A = amps_pad
// (B, T+2, H), L = loud_pad (B, T+2):
//
//   s_1 = sin(2 pi x), two_c = 2 cos(2 pi x)        (the plain angle)
//   s_{h+1} = two_c * s_h - s_{h-1}                  s_0 = 0
//   re-seed: at h > 1 with (h - 1) % resync == 0, s_h and s_{h-1} are the
//            exact split-precision sines of harmonics h and h - 1
//   S_k = sum_h A[b, t+k, h-1] s_h                   k = 0, 1, 2
//   audio[b, t*hop + j] = (sum_k w[j,k] L[b,t+k]) * (sum_k w[j,k] S_k)
//
// Accumulator layout (:340-346): when hop % 256 == 0, samples j < hop/2
// take weight only from frames t-1 and t (w[j, 2] = 0) and samples
// j >= hop/2 only from t and t+1 (w[j, 0] = 0), so each thread keeps two
// window sums instead of three.  With 128-sample blocks a block lies in one
// half, so the choice is uniform per block.  No h_start: the TPU kernel has
// none (the wrapper raises NotImplementedError, as :638-641 does).
//
// What bounds it on an H100: arithmetic, ~8 FLOP a (sample, harmonic)
// point: the recurrence (one multiply, one subtract), two (three) window
// multiply-adds, and two exact sines every `resync` harmonics, against K1's
// exactly reduced sine per point.  One thread per sample keeps the three
// recurrence values in registers; the frame's three amplitude rows sit in
// shared memory and are read as warp-wide broadcasts.
//
// Accuracy: the recurrence rounds each multiply and subtract on its own
// (__fmul_rn / __fsub_rn), as the TPU kernel and the plain torch version
// do, so its Chebyshev error growth follows theirs; the window sums use
// fused multiply-adds.  Build without --use_fast_math.

#include <cuda_runtime.h>

#include "osc_phase.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float exact_sin(float hi, float lo, int h) {
  return sinf(osc::kTwoPi * osc::harmonic_frac(hi, lo, static_cast<float>(h)));
}

__global__ void __launch_bounds__(kThreads)
osc_cheb_fwd_kernel(const float* __restrict__ phase,  // (B, T, hop)
                    const float* __restrict__ amps,   // (B, T+2, H)
                    const float* __restrict__ loud,   // (B, T+2)
                    const float* __restrict__ w,      // (hop, 3)
                    float* __restrict__ out,          // (B, T, hop)
                    int n_frames, int hop, int n_harm, int resync,
                    int tiles_per_frame) {
  extern __shared__ float rows[];  // [3][n_harm]: amps rows t, t+1, t+2
  const int frame = blockIdx.x / tiles_per_frame;
  const int tile = blockIdx.x - frame * tiles_per_frame;
  const size_t b = blockIdx.y;
  const float* a0 = amps + (b * (n_frames + 2) + frame) * n_harm;
  for (int i = threadIdx.x; i < 3 * n_harm; i += blockDim.x) rows[i] = a0[i];
  __syncthreads();

  const int j = tile * kThreads + threadIdx.x;
  if (j >= hop) return;
  const size_t idx = (b * n_frames + frame) * hop + j;
  const float x = phase[idx];
  float hi, lo;
  osc::split_phase(x, &hi, &lo);
  float s_cur, c1;
  sincosf(osc::kTwoPi * x, &s_cur, &c1);
  const float two_c = 2.0f * c1;
  float s_prev = 0.0f;

  const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
  const bool split = hop % 256 == 0;
  float harm;
  if (split) {
    // two windows: (t-1, t) below hop/2, (t, t+1) from hop/2 on
    const bool low = j < hop / 2;
    const float* ra = low ? rows : rows + n_harm;
    const float* rb = low ? rows + n_harm : rows + 2 * n_harm;
    float acc_a = 0.0f, acc_b = 0.0f;
    for (int h = 1; h <= n_harm; ++h) {
      if (h > 1 && (h - 1) % resync == 0) {
        s_cur = exact_sin(hi, lo, h);
        s_prev = exact_sin(hi, lo, h - 1);
      }
      acc_a = fmaf(ra[h - 1], s_cur, acc_a);
      acc_b = fmaf(rb[h - 1], s_cur, acc_b);
      const float s_next = __fsub_rn(__fmul_rn(two_c, s_cur), s_prev);
      s_prev = s_cur;
      s_cur = s_next;
    }
    harm = low ? acc_a * w0 + acc_b * w1 : acc_a * w1 + acc_b * w2;
  } else {
    float acc_l = 0.0f, acc_m = 0.0f, acc_r = 0.0f;
    for (int h = 1; h <= n_harm; ++h) {
      if (h > 1 && (h - 1) % resync == 0) {
        s_cur = exact_sin(hi, lo, h);
        s_prev = exact_sin(hi, lo, h - 1);
      }
      acc_l = fmaf(rows[h - 1], s_cur, acc_l);
      acc_m = fmaf(rows[n_harm + h - 1], s_cur, acc_m);
      acc_r = fmaf(rows[2 * n_harm + h - 1], s_cur, acc_r);
      const float s_next = __fsub_rn(__fmul_rn(two_c, s_cur), s_prev);
      s_prev = s_cur;
      s_cur = s_next;
    }
    harm = acc_l * w0 + acc_m * w1 + acc_r * w2;
  }
  const float* ld = loud + b * (n_frames + 2) + frame;
  const float loud_up = w0 * ld[0] + w1 * ld[1] + w2 * ld[2];
  out[idx] = harm * loud_up;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes: b <= 65535 batch rows, 1 <= n_harm <= 2048,
// resync >= 1, t * ceil(hop / 128) < 2^31.
extern "C" int osc_cheb_fwd(const float* phase, const float* amps,
                            const float* loud, const float* w, float* out,
                            int b, int t, int hop, int n_harm, int resync,
                            void* stream) {
  if (b == 0 || t == 0 || hop == 0) return 0;
  const int tiles = (hop + kThreads - 1) / kThreads;
  const dim3 grid(t * tiles, b);
  const size_t smem = 3 * static_cast<size_t>(n_harm) * sizeof(float);
  osc_cheb_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      phase, amps, loud, w, out, t, hop, n_harm, resync, tiles);
  return static_cast<int>(cudaGetLastError());
}
