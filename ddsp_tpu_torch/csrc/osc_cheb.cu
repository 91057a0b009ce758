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
// j >= hop/2 only from t and t+1 (w[j, 0] = 0), so each sample keeps two
// window sums instead of three.  No h_start: the TPU kernel has none (the
// wrapper raises NotImplementedError, as :638-641 does).
//
// What bounds it on an H100: issue slots.  A (sample, harmonic) point
// costs the recurrence (one multiply, one subtract, rounded apart) and two
// (three) window FMAs, and every `resync` harmonics two exact sines (~45
// issue slots each).  The recurrence is one dependent chain a sample, so:
//
// * a thread interleaves kQ samples of a frame, strided by the block, and
//   their kQ chains issue side by side;
// * the harmonic loop runs in segments of `resync` harmonics: the exact
//   seeds of h and h - 1 at a segment's start, then the recurrence with no
//   test inside (no integer division a harmonic);
// * the frame's amplitudes sit in shared memory one vector a harmonic,
//   (A[t], A[t+1], A[t+2], 0) as a float4, or in the split layout the two
//   rows of the block's half as a float2, so one broadcast load a harmonic
//   serves the thread's kQ samples;
// * with the split, a block lies in one half of the hop (a half is a
//   multiple of 128 samples), so its rows and windows are uniform.
//
// Each sample keeps its operations in the order of the one-sample-a-thread
// kernel this replaced (window sums over harmonics in order, the
// recurrence's roundings, the same seeds), so the output keeps its bits at
// every resync.
//
// Accuracy: the recurrence rounds each multiply and subtract on its own
// (__fmul_rn / __fsub_rn), as the TPU kernel and the plain torch version
// do, so its Chebyshev error growth follows theirs; the window sums use
// fused multiply-adds.  Build without --use_fast_math.

#include <cuda_runtime.h>

#include <type_traits>

#include "osc_fwd.cuh"
#include "osc_phase.cuh"

namespace {

constexpr int kQ = 4;  // samples a thread, strided by the block

__device__ __forceinline__ float exact_sin(float hi, float lo, int h) {
  return sinf(osc::kTwoPi * osc::harmonic_frac(hi, lo, static_cast<float>(h)));
}

// The window amplitudes of one harmonic: float2 (the split's two rows) or
// float4 (three rows and a zero).
template <bool kSplit>
using Rows = std::conditional_t<kSplit, float2, float4>;

template <bool kSplit>
__global__ void __launch_bounds__(osc::kFwdMaxThreads)
osc_cheb_fwd_kernel(const float* __restrict__ phase,  // (B, T, hop)
                    const float* __restrict__ amps,   // (B, T+2, H)
                    const float* __restrict__ loud,   // (B, T+2)
                    const float* __restrict__ w,      // (hop, 3)
                    float* __restrict__ out,          // (B, T, hop)
                    int n_frames, int hop, int n_harm, int resync,
                    int tiles_per_span) {
  extern __shared__ float4 smem4[];
  Rows<kSplit>* rows = reinterpret_cast<Rows<kSplit>*>(smem4);  // [n_harm]
  const int spans = kSplit ? 2 : 1;           // halves of the hop (split) or the hop
  const int span = hop / spans;
  const int frame = blockIdx.x / (spans * tiles_per_span);
  const int rest = blockIdx.x - frame * spans * tiles_per_span;
  const int part = rest / tiles_per_span;     // 0: the low half (or the whole hop)
  const int tile = rest - part * tiles_per_span;
  const bool low = part == 0;
  const size_t b = blockIdx.y;
  const float* a0 = amps + (b * (n_frames + 2) + frame) * n_harm;
  for (int h = threadIdx.x; h < n_harm; h += blockDim.x) {
    if constexpr (kSplit) {
      // (t-1, t) below hop/2, (t, t+1) from hop/2 on
      const float* ra = low ? a0 : a0 + n_harm;
      rows[h] = make_float2(ra[h], ra[n_harm + h]);
    } else {
      rows[h] = make_float4(a0[h], a0[n_harm + h], a0[2 * n_harm + h], 0.0f);
    }
  }
  __syncthreads();

  const size_t base = (b * n_frames + frame) * hop + part * span;
  const int j0 = tile * kQ * blockDim.x + threadIdx.x;  // within the span
  float hi[kQ], lo[kQ], two_c[kQ], s_cur[kQ], s_prev[kQ];
  float acc_a[kQ], acc_b[kQ], acc_c[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = j0 + q * blockDim.x;
    const float x = j < span ? phase[base + j] : 0.0f;
    osc::split_phase(x, &hi[q], &lo[q]);
    float c1;
    sincosf(osc::kTwoPi * x, &s_cur[q], &c1);
    two_c[q] = 2.0f * c1;
    s_prev[q] = 0.0f;
    acc_a[q] = acc_b[q] = acc_c[q] = 0.0f;
  }

  // Segments [h0, h1) of `resync` harmonics (the host clamps resync to
  // n_harm), each after the first seeded exactly at h0.
  for (int h0 = 1;;) {
    const int h1 = min(h0 + resync, n_harm + 1);
#pragma unroll 4
    for (int h = h0; h < h1; ++h) {
      const Rows<kSplit> v = rows[h - 1];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        acc_a[q] = fmaf(v.x, s_cur[q], acc_a[q]);
        acc_b[q] = fmaf(v.y, s_cur[q], acc_b[q]);
        if constexpr (!kSplit) acc_c[q] = fmaf(v.z, s_cur[q], acc_c[q]);
        const float s_next = __fsub_rn(__fmul_rn(two_c[q], s_cur[q]), s_prev[q]);
        s_prev[q] = s_cur[q];
        s_cur[q] = s_next;
      }
    }
    if (h1 > n_harm) break;
    h0 = h1;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      s_cur[q] = exact_sin(hi[q], lo[q], h0);
      s_prev[q] = exact_sin(hi[q], lo[q], h0 - 1);
    }
  }

  const float* ld = loud + b * (n_frames + 2) + frame;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int jj = j0 + q * blockDim.x;
    if (jj < span) {
      const int j = part * span + jj;
      const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
      float harm;
      if constexpr (kSplit) {
        harm = low ? acc_a[q] * w0 + acc_b[q] * w1 : acc_a[q] * w1 + acc_b[q] * w2;
      } else {
        harm = acc_a[q] * w0 + acc_b[q] * w1 + acc_c[q] * w2;
      }
      const float loud_up = w0 * ld[0] + w1 * ld[1] + w2 * ld[2];
      out[base + jj] = harm * loud_up;
    }
  }
}

template <bool kSplit>
cudaError_t launch(const float* phase, const float* amps, const float* loud, const float* w,
                   float* out, int b, int t, int hop, int n_harm, int resync,
                   cudaStream_t stream) {
  // blocks covering a span (a half of the hop, or the hop) in kQ samples a thread
  const osc::FwdShape shape = osc::fwd_shape(kSplit ? hop / 2 : hop, kQ);
  const dim3 grid(t * (kSplit ? 2 : 1) * shape.tiles, b);
  const size_t smem = static_cast<size_t>(n_harm) * sizeof(Rows<kSplit>);
  osc_cheb_fwd_kernel<kSplit><<<grid, shape.threads, smem, stream>>>(
      phase, amps, loud, w, out, t, hop, n_harm, resync < n_harm ? resync : n_harm,
      shape.tiles);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hop % 256 == 0 ? launch<true>(phase, amps, loud, w, out, b, t, hop, n_harm, resync, s)
                     : launch<false>(phase, amps, loud, w, out, b, t, hop, n_harm, resync, s);
  return static_cast<int>(err);
}
