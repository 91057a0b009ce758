// osc_frames: the offline harmonic render over the frames of a batch,
// forward (osc_frames_fwd) and its one-pass backward (osc_frames_bwd).
//
// Replaces ddsp_tpu/ops/pallas/oscillator.py:_kernel_banked2 (forward, K1)
// and :_kernel_banked2_bwd (backward, K2), as reached through
// pallas_render_from_phase and its custom_vjp _render_h (the training
// step's oscillator).  For batch row b, frame t and sample j of the hop:
//
//   x     = phase[b, t, j]                      fundamental phase, cycles
//   S_k   = sum_h A[b, t+k, h] sin(2 pi (h0+h+1) x)        k = 0, 1, 2
//   harm  = sum_k w[j, k] S_k
//   loud  = sum_k w[j, k] L[b, t+k]
//   audio[b, t*hop + j] = loud * harm
//
// with A = amps_pad (B, T+2, H), L = loud_pad (B, T+2): rows t, t+1, t+2
// are frame t's (previous, current, next) interpolation context.  Given
// the audio gradient g and ql = g * loud, the backward is
//
//   dphase[b, t, j]     = ql * sum_k w[j,k] sum_h A[b,t+k,h] 2 pi (h0+h+1) cos(.)
//   da_win[b, t, k, h]  = sum_j ql w[j,k] sin(2 pi (h0+h+1) x_j)
//   dl_win[b, t, k]     = sum_j g harm w[j,k]
//
// and the caller overlap-adds the window gradients onto the padded frame
// axis (row t+k of A and L), as _pallas_backward does (:986-1000).
//
// What bounds them on an H100: arithmetic.  At the training shape
// (B=16, T=172, hop 512, H=180) there are 2.54e8 (sample, harmonic)
// points; each costs a sine (forward) or a sine and a cosine (backward) of
// an exactly reduced harmonic phase plus a few multiply-adds, while the
// operands are ~13 MB (forward) and ~21 MB (backward).  The TPU kernels
// exist to keep the (B, T, hop, H) sine tensor (1.01 GB here) out of HBM
// and to run the harmonic sums on the MXU.  Here:
//
// * forward: one block per (frame, 128-sample tile), one sample per
//   thread; the frame's three amplitude rows sit in shared memory (read as
//   warp-wide broadcasts); each sine lives in a register and is folded
//   into three running window sums at once, as in osc_hop_slots.cu.
// * backward: one block per frame.  The two reductions run over the same
//   (sample, harmonic) points in two directions: over harmonics per sample
//   (harm and the phase derivative) and over samples per harmonic (the
//   three window-amplitude gradients).  The block walks tiles of 32
//   harmonics; in each, every thread (a sample) evaluates its 32 sines and
//   cosines once, keeps the harmonic-direction sums in registers and
//   stores its sines in a shared (32 x 256) bank; then every lane (a
//   harmonic) reduces the bank's column over its warp's 32 samples, and
//   the 8 warps' partials are summed in a fixed order.  dloud is a fixed-
//   order block reduction.  No float atomics: the gradients are the same
//   from run to run.
//
// Accuracy: every harmonic's phase is formed as in harmonic_sines
// (osc_phase.cuh) with h = h0 + i + 1, and sines and cosines are the
// accurate sinf / sincosf (build without --use_fast_math).  Sums are
// float32 throughout; each sample's phase-derivative sum (factor
// 2 pi h, up to ~1.1e3 at H=180) stays in registers.  The TPU's backward
// contracts at DEFAULT precision (one bf16-grade pass, _BWD_CONTRACT_DTYPE
// None with f32 banks); this kernel computes in full float32, which is
// stricter.  The TPU's padding (T to its 16-frame block, H to 256 lanes,
// loudness repeated over 128 lanes, the (ft+2)-row amps_win copy) is
// dropped: the grid covers exactly B x T frames and masks ragged tiles.
//
// Options (K8: the fill and dtype options of _kernel_banked2 / _bwd,
// :507-520, :894-906), as compile-time template parameters, so the default
// instantiation <kExact, false> is the code above with no run-time branch:
//
// * kFill: kExact (every harmonic's own sine: the default), kRot, kCheb8
//   (osc_fill.cuh; rot4 is kRot with chunks of 4 tiles).  resync_tiles and
//   chunk_tiles (k_chunk / 8) are run-time ints read by the fills only.
// * kBf16: the contraction's operands rounded to bfloat16 (nearest even),
//   sums in float32: in the forward the sines and the amplitude rows
//   (bank_dtype='bfloat16', or precision DEFAULT: one bf16 MXU pass); in the
//   backward the JAX kernel's three operand pairs under contract_dtype or a
//   bf16 bank (:845-876): the sines and ql*w_k for the window-amplitude
//   gradient, the sines and the rounded amplitudes for harm, the cosines
//   and bf16(bf16(A) * 2 pi h) for the phase derivative.  The fill itself
//   stays float32.
//
// Left for later: tensor-core contractions for the backward's
// sample-direction sums, persistent blocks.

#include <cuda_runtime.h>

#include "osc_fill.cuh"
#include "osc_phase.cuh"

namespace {

constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kWarps = kBwdThreads / 32;
constexpr int kTile = 32;  // harmonics per backward tile: one per lane
constexpr int kBankStride = kBwdThreads + 1;  // padded: conflict-free columns

template <int kFill, bool kBf16>
__global__ void __launch_bounds__(kFwdThreads)
osc_frames_fwd_kernel(const float* __restrict__ phase,  // (B, T, hop)
                      const float* __restrict__ amps,   // (B, T+2, H)
                      const float* __restrict__ loud,   // (B, T+2)
                      const float* __restrict__ w,      // (hop, 3)
                      float* __restrict__ out,          // (B, T, hop)
                      int n_frames, int hop, int n_harm, int h_start,
                      int tiles_per_frame, int resync_tiles, int chunk_tiles) {
  extern __shared__ float rows[];  // [3][n_harm]: amps rows t, t+1, t+2
  const int frame = blockIdx.x / tiles_per_frame;
  const int tile = blockIdx.x - frame * tiles_per_frame;
  const size_t b = blockIdx.y;
  // rows t .. t+2 of one batch row are contiguous: 3 * n_harm floats
  const float* a0 = amps + (b * (n_frames + 2) + frame) * n_harm;
  for (int i = threadIdx.x; i < 3 * n_harm; i += blockDim.x) {
    rows[i] = kBf16 ? osc::round_bf16(a0[i]) : a0[i];
  }
  __syncthreads();

  const int j = tile * kFwdThreads + threadIdx.x;
  if (j >= hop) return;
  const size_t idx = (b * n_frames + frame) * hop + j;

  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  if constexpr (kFill == osc::kExact && !kBf16) {
    float hi, lo;
    osc::split_phase(phase[idx], &hi, &lo);
    for (int i = 0; i < n_harm; ++i) {
      const float h = static_cast<float>(h_start + i + 1);
      const float s = sinf(osc::kTwoPi * osc::harmonic_frac(hi, lo, h));
      s0 = fmaf(rows[i], s, s0);
      s1 = fmaf(rows[n_harm + i], s, s1);
      s2 = fmaf(rows[2 * n_harm + i], s, s2);
    }
  } else {
    osc::TileFill<kFill, false> f;
    f.init(phase[idx], h_start, resync_tiles, chunk_tiles);
    const int groups = (n_harm + 7) / 8;
    for (int g = 0; g < groups; ++g) {
      f.tile(g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int hh = 8 * g + i;
        if (hh < n_harm) {
          const float s = kBf16 ? osc::round_bf16(f.s[i]) : f.s[i];
          s0 = fmaf(rows[hh], s, s0);
          s1 = fmaf(rows[n_harm + hh], s, s1);
          s2 = fmaf(rows[2 * n_harm + hh], s, s2);
        }
      }
    }
  }

  const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
  const float* ld = loud + b * (n_frames + 2) + frame;
  const float harm = w0 * s0 + w1 * s1 + w2 * s2;
  const float loud_up = w0 * ld[0] + w1 * ld[1] + w2 * ld[2];
  out[idx] = loud_up * harm;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int kFill, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads)
osc_frames_bwd_kernel(const float* __restrict__ g,      // (B, T, hop)
                      const float* __restrict__ phase,  // (B, T, hop)
                      const float* __restrict__ amps,   // (B, T+2, H)
                      const float* __restrict__ loud,   // (B, T+2)
                      const float* __restrict__ w,      // (hop, 3)
                      float* __restrict__ dphase,       // (B, T, hop)
                      float* __restrict__ da_win,       // (B, T, 3, H)
                      float* __restrict__ dl_win,       // (B, T, 3)
                      int n_frames, int hop, int n_harm, int h_start,
                      int resync_tiles, int chunk_tiles) {
  extern __shared__ float smem[];
  float* rows = smem;                      // [3][n_harm] amps rows t..t+2
  float* da = rows + 3 * n_harm;           // [3][n_harm] window-amp grads
  float* bank = da + 3 * n_harm;           // [kTile][kBankStride] sines
  float* qw = bank + kTile * kBankStride;  // [3][kBwdThreads] ql * w_k
  float* part = qw + 3 * kBwdThreads;      // [kWarps][3][kTile] partials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.y;
  const size_t fr = b * n_frames + blockIdx.x;  // (b, t) frame index
  const float* a0 = amps + (b * (n_frames + 2) + blockIdx.x) * n_harm;
  for (int i = tid; i < 3 * n_harm; i += kBwdThreads) {
    rows[i] = kBf16 ? osc::round_bf16(a0[i]) : a0[i];
    da[i] = 0.0f;
  }
  const float* ld = loud + b * (n_frames + 2) + blockIdx.x;
  const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
  float dl0 = 0.0f, dl1 = 0.0f, dl2 = 0.0f;
  __syncthreads();

  for (int j0 = 0; j0 < hop; j0 += kBwdThreads) {  // uniform across the block
    const int j = j0 + tid;
    const bool live = j < hop;
    float hi = 0.0f, lo = 0.0f, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    float gj = 0.0f, ql = 0.0f;
    if (live) {
      osc::split_phase(phase[fr * hop + j], &hi, &lo);
      w0 = w[3 * j];
      w1 = w[3 * j + 1];
      w2 = w[3 * j + 2];
      gj = g[fr * hop + j];
      ql = gj * (w0 * l0 + w1 * l1 + w2 * l2);
    }
    if (kBf16) {
      qw[tid] = osc::round_bf16(ql * w0);
      qw[kBwdThreads + tid] = osc::round_bf16(ql * w1);
      qw[2 * kBwdThreads + tid] = osc::round_bf16(ql * w2);
    } else {
      qw[tid] = ql * w0;
      qw[kBwdThreads + tid] = ql * w1;
      qw[2 * kBwdThreads + tid] = ql * w2;
    }
    osc::TileFill<kFill, true> f;  // unused by the default <kExact, false>
    if (kFill != osc::kExact || kBf16) {
      f.init(live ? phase[fr * hop + j] : 0.0f, h_start, resync_tiles, chunk_tiles);
    }

    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;  // harmonic sums of the windows
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;  // and of their phase derivative
    for (int h0 = 0; h0 < n_harm; h0 += kTile) {
      // 1. this sample's sines and cosines of the tile
      if constexpr (kFill == osc::kExact && !kBf16) {
        for (int i = 0; i < kTile; ++i) {
          const int hh = h0 + i;
          float s = 0.0f;
          if (live && hh < n_harm) {
            const float h = static_cast<float>(h_start + hh + 1);
            float c;
            sincosf(osc::kTwoPi * osc::harmonic_frac(hi, lo, h), &s, &c);
            const float a_0 = rows[hh];
            const float a_1 = rows[n_harm + hh];
            const float a_2 = rows[2 * n_harm + hh];
            s0 = fmaf(a_0, s, s0);
            s1 = fmaf(a_1, s, s1);
            s2 = fmaf(a_2, s, s2);
            const float hc = (osc::kTwoPi * h) * c;
            p0 = fmaf(a_0, hc, p0);
            p1 = fmaf(a_1, hc, p1);
            p2 = fmaf(a_2, hc, p2);
          }
          bank[i * kBankStride + tid] = s;
        }
      } else {
        for (int q = 0; q < kTile / 8; ++q) {
          f.tile(h0 / 8 + q);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int ii = 8 * q + i;
            const int hh = h0 + ii;
            float s = 0.0f;
            if (live && hh < n_harm) {
              s = kBf16 ? osc::round_bf16(f.s[i]) : f.s[i];
              const float c = kBf16 ? osc::round_bf16(f.c[i]) : f.c[i];
              const float h2pi = osc::kTwoPi * static_cast<float>(h_start + hh + 1);
              const float a_0 = rows[hh];
              const float a_1 = rows[n_harm + hh];
              const float a_2 = rows[2 * n_harm + hh];
              s0 = fmaf(a_0, s, s0);
              s1 = fmaf(a_1, s, s1);
              s2 = fmaf(a_2, s, s2);
              if (kBf16) {
                p0 = fmaf(osc::round_bf16(a_0 * h2pi), c, p0);
                p1 = fmaf(osc::round_bf16(a_1 * h2pi), c, p1);
                p2 = fmaf(osc::round_bf16(a_2 * h2pi), c, p2);
              } else {
                const float hc = h2pi * c;
                p0 = fmaf(a_0, hc, p0);
                p1 = fmaf(a_1, hc, p1);
                p2 = fmaf(a_2, hc, p2);
              }
            }
            bank[ii * kBankStride + tid] = s;
          }
        }
      }
      __syncthreads();
      // 2. lane = harmonic: sum over this warp's 32 samples
      {
        const float* col = bank + lane * kBankStride + warp * 32;
        const float* q = qw + warp * 32;
        float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
        for (int i = 0; i < 32; ++i) {
          const float s = col[i];
          r0 = fmaf(q[i], s, r0);
          r1 = fmaf(q[kBwdThreads + i], s, r1);
          r2 = fmaf(q[2 * kBwdThreads + i], s, r2);
        }
        float* pw = part + warp * 3 * kTile;
        pw[lane] = r0;
        pw[kTile + lane] = r1;
        pw[2 * kTile + lane] = r2;
      }
      __syncthreads();
      // 3. the warps' partials, summed in warp order
      if (tid < 3 * kTile) {
        const int k = tid / kTile;
        const int hh = h0 + tid % kTile;
        if (hh < n_harm) {
          float r = 0.0f;
          for (int v = 0; v < kWarps; ++v) r += part[v * 3 * kTile + tid];
          da[k * n_harm + hh] += r;
        }
      }
      // the next tile's bank writes follow its step-1 loop, and its part
      // writes follow a barrier, so step 3 needs no barrier of its own
    }
    if (live) {
      dphase[fr * hop + j] = ql * (w0 * p0 + w1 * p1 + w2 * p2);
      const float gh = gj * (w0 * s0 + w1 * s1 + w2 * s2);
      dl0 = fmaf(gh, w0, dl0);
      dl1 = fmaf(gh, w1, dl1);
      dl2 = fmaf(gh, w2, dl2);
    }
    __syncthreads();  // qw is rewritten by the next sample chunk
  }

  float* out = da_win + fr * 3 * n_harm;
  for (int i = tid; i < 3 * n_harm; i += kBwdThreads) out[i] = da[i];

  dl0 = warp_sum(dl0);
  dl1 = warp_sum(dl1);
  dl2 = warp_sum(dl2);
  if (lane == 0) {
    part[warp * 3] = dl0;
    part[warp * 3 + 1] = dl1;
    part[warp * 3 + 2] = dl2;
  }
  __syncthreads();
  if (tid < 3) {
    float r = 0.0f;
    for (int v = 0; v < kWarps; ++v) r += part[v * 3 + tid];
    dl_win[fr * 3 + tid] = r;
  }
}

size_t bwd_smem_bytes(int n_harm) {
  return sizeof(float) * (6 * static_cast<size_t>(n_harm) +
                          kTile * kBankStride + 3 * kBwdThreads +
                          kWarps * 3 * kTile);
}

template <int kFill, bool kBf16>
int launch_fwd(const float* phase, const float* amps, const float* loud,
               const float* w, float* out, int b, int t, int hop, int n_harm,
               int h_start, int resync_tiles, int chunk_tiles,
               cudaStream_t stream) {
  const int tiles = (hop + kFwdThreads - 1) / kFwdThreads;
  const dim3 grid(t * tiles, b);
  const size_t smem = 3 * static_cast<size_t>(n_harm) * sizeof(float);
  osc_frames_fwd_kernel<kFill, kBf16><<<grid, kFwdThreads, smem, stream>>>(
      phase, amps, loud, w, out, t, hop, n_harm, h_start, tiles, resync_tiles,
      chunk_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kFill, bool kBf16>
int launch_bwd(const float* g, const float* phase, const float* amps,
               const float* loud, const float* w, float* dphase,
               float* da_win, float* dl_win, int b, int t, int hop,
               int n_harm, int h_start, int resync_tiles, int chunk_tiles,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(n_harm);  // <= 88 KB at n_harm 2048
  cudaError_t err = cudaFuncSetAttribute(
      osc_frames_bwd_kernel<kFill, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(t, b);
  osc_frames_bwd_kernel<kFill, kBf16><<<grid, kBwdThreads, smem, stream>>>(
      g, phase, amps, loud, w, dphase, da_win, dl_win, t, hop, n_harm,
      h_start, resync_tiles, chunk_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an option they were not built
// with.  The caller has checked shapes: b <= 65535 batch rows, 1 <= n_harm
// and h_start + n_harm <= 2048, t * ceil(hop / 128) < 2^31; fill is 0
// (exact), 1 (rotation) or 2 (Chebyshev), bf16 0 or 1, resync_tiles and
// chunk_tiles >= 1.

#define OSC_DISPATCH(fn, ...)                                           \
  switch (fill * 2 + (bf16 ? 1 : 0)) {                                  \
    case 0: return fn<osc::kExact, false>(__VA_ARGS__);                 \
    case 1: return fn<osc::kExact, true>(__VA_ARGS__);                  \
    case 2: return fn<osc::kRot, false>(__VA_ARGS__);                   \
    case 3: return fn<osc::kRot, true>(__VA_ARGS__);                    \
    case 4: return fn<osc::kCheb8, false>(__VA_ARGS__);                 \
    case 5: return fn<osc::kCheb8, true>(__VA_ARGS__);                  \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

extern "C" int osc_frames_fwd(const float* phase, const float* amps,
                              const float* loud, const float* w, float* out,
                              int b, int t, int hop, int n_harm, int h_start,
                              int fill, int bf16, int resync_tiles,
                              int chunk_tiles, void* stream) {
  if (b == 0 || t == 0 || hop == 0) return 0;
  OSC_DISPATCH(launch_fwd, phase, amps, loud, w, out, b, t, hop, n_harm,
               h_start, resync_tiles, chunk_tiles,
               static_cast<cudaStream_t>(stream))
}

extern "C" int osc_frames_bwd(const float* g, const float* phase,
                              const float* amps, const float* loud,
                              const float* w, float* dphase, float* da_win,
                              float* dl_win, int b, int t, int hop, int n_harm,
                              int h_start, int fill, int bf16,
                              int resync_tiles, int chunk_tiles,
                              void* stream) {
  if (b == 0 || t == 0 || hop == 0) return 0;
  OSC_DISPATCH(launch_bwd, g, phase, amps, loud, w, dphase, da_win, dl_win,
               b, t, hop, n_harm, h_start, resync_tiles, chunk_tiles,
               static_cast<cudaStream_t>(stream))
}
