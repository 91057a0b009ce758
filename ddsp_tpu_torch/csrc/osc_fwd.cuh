// The harmonic forward render of one row of samples, shared by K1
// (osc_frames.cu: osc_frames_fwd, a frame of a batch) and K5
// (osc_hop_slots.cu: osc_hop_slots, a serving slot, or a frame as an
// independent row).  For sample j of the row, with x = phase[j]:
//
//   S_k   = sum_h a_k[h] sin(2 pi (h0+h+1) x)          k = 0, 1, 2
//   harm  = sum_k w[j, k] S_k
//   loud  = sum_k w[j, k] ld[k]
//   out[j] = loud * harm
//
// The callers differ only in where the row's three amplitude rows a_0..a_2
// and loudness values ld[0..2] come from: K1 takes rows t, t+1 and t+2 of
// one (B, T+2, H) array, K5 one row of each of three (N, H) arrays.
// (K7, osc_cheb.cu, takes its block shape from fwd_shape as well.)
//
// What bounds it on an H100: issue slots.  The rotation fill (kRot, the TPU
// kernels' own) must round one IEEE operation at a time, as the JAX code and
// the plain version do: 6 unfused operations a (sample, harmonic) point,
// plus 3 window FMAs.  A thread renders kQ samples of the row, strided by
// the block (loads and stores coalesce), each with the 8 harmonic slots of
// a tile (osc::SlotFill: TileFill's arithmetic slot by slot, osc_fill.cuh),
// all seeded by one osc::SeedClock (one uniform branch a tile, no integer
// division).  The three amplitude rows sit in shared memory, zero-padded to
// a multiple of 8 harmonics (no test per point), and each tile's 8 x 3
// amplitudes are read once per thread as 16-byte broadcasts that serve all
// kQ samples.  The sums run over harmonics in order, tile by tile, the same
// for every kQ: the bits do not depend on it.
//
// kQ is the launch's choice (kFwdSamples below): fewer samples a thread
// put more warps on the card and use fewer registers, more share each
// amplitude load.

#pragma once

#include "osc_fill.cuh"
#include "osc_phase.cuh"

namespace osc {

constexpr int kFwdMaxThreads = 128;  // a block's threads at most: fewer for short rows
// Samples a thread of K1 and K5.  Measured on an H100 (utils/osc_kernel_ab.py:
// 1, 2 or 4, in blocks of 64 or 128, K5 at 256, 1024 and 2048 slots and
// the 2,752 frame rows of a training batch, K1 on the exact, rotation and
// Chebyshev fills), 2 in blocks of 128 is the fastest or within 2 % of it
// everywhere; 4 is up to 2.1x slower on the exact fill, 1 up to 15 %
// slower on the rotation fill.
constexpr int kFwdSamples = 2;

__host__ __device__ __forceinline__ int padded_harmonics(int n_harm) {
  return (n_harm + 7) / 8 * 8;
}

// A row's blocks: `threads` (a warp's multiple, at most max_threads <= 128)
// cover the row in kQ samples each, `tiles` blocks a row.
struct FwdShape {
  int threads, tiles;
};

inline FwdShape fwd_shape(int hop, int samples_per_thread, int max_threads = kFwdMaxThreads) {
  const int per_thread = (hop + samples_per_thread - 1) / samples_per_thread;
  const int threads = per_thread >= max_threads ? max_threads : (per_thread + 31) / 32 * 32;
  return {threads, (hop + threads * samples_per_thread - 1) / (threads * samples_per_thread)};
}

inline size_t fwd_smem_bytes(int n_harm) {
  return 3 * static_cast<size_t>(padded_harmonics(n_harm)) * sizeof(float);
}

// The block `tile` of one row.  a_l, a_m, a_r: the row's three amplitude
// rows (n_harm floats each); ld: its three loudness values; phase, out:
// its hop samples; w: the (hop, 3) interpolation weights.  Dynamic shared
// memory: fwd_smem_bytes(n_harm).
template <int kFill, bool kBf16, int kQ>
__device__ __forceinline__ void render_row(const float* __restrict__ a_l,
                                           const float* __restrict__ a_m,
                                           const float* __restrict__ a_r,
                                           const float* __restrict__ ld,
                                           const float* __restrict__ phase,
                                           const float* __restrict__ w,
                                           float* __restrict__ out, int tile, int hop,
                                           int n_harm, int h_start, int resync_tiles,
                                           int chunk_tiles) {
  extern __shared__ float4 rows4[];  // [3][hp / 4]: the three amplitude rows
  float* rows = reinterpret_cast<float*>(rows4);
  const int hp = padded_harmonics(n_harm);
  // The thread's phases and the loudness, loaded before the barrier so
  // that their latency overlaps the rows' (a serving hop is one wave of
  // blocks: each load's latency adds to it).  The weights wait for the
  // end: held through the loop they cost registers and blocks an SM.
  const int j0 = tile * kQ * blockDim.x + threadIdx.x;
  float x[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = j0 + q * blockDim.x;
    x[q] = j < hop ? phase[j] : 0.0f;
  }
  const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
  const float* src[3] = {a_l, a_m, a_r};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int h = threadIdx.x; h < hp; h += blockDim.x) {
      const float v = h < n_harm ? src[k][h] : 0.0f;
      rows[k * hp + h] = kBf16 ? round_bf16(v) : v;
    }
  }
  __syncthreads();

  SlotFill<kFill, false> f[kQ][8];
  float hi[kQ], lo[kQ], r0[kQ], r1[kQ];
  float acc[kQ][3];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    split_phase(x[q], &hi[q], &lo[q]);
    r0[q] = 0.0f;  // kRot: the rotor (s8, c8); kCheb8: (-, 2 cos 8x)
    r1[q] = 0.0f;
    if (kFill != kExact) {
      float s8, c8;
      sincosf(kTwoPi * harmonic_frac(hi[q], lo[q], 8.0f), &s8, &c8);
      r0[q] = s8;
      r1[q] = kFill == kRot ? c8 : 2.0f * c8;
    }
    acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
  }
  SeedClock clock(chunk_tiles, resync_tiles);
  float h = static_cast<float>(h_start + 1);  // slot 0's harmonic
  for (int g = 0; g < hp / 8; ++g, h += 8.0f) {
    if (clock.seeded<kFill>()) {  // uniform
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[q][i].seed(hi[q], lo[q], h + static_cast<float>(i));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[q][i].advance(r0[q], r1[q]);
      }
    }
    clock.next();
    float a[3][8];  // the tile's amplitudes, 16-byte broadcasts
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 lo4 = rows4[(k * hp + 8 * g) / 4];
      const float4 hi4 = rows4[(k * hp + 8 * g) / 4 + 1];
      a[k][0] = lo4.x, a[k][1] = lo4.y, a[k][2] = lo4.z, a[k][3] = lo4.w;
      a[k][4] = hi4.x, a[k][5] = hi4.y, a[k][6] = hi4.z, a[k][7] = hi4.w;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float s = kBf16 ? round_bf16(f[q][i].s) : f[q][i].s;
          acc[q][k] = fmaf(a[k][i], s, acc[q][k]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = j0 + q * blockDim.x;
    if (j < hop) {
      const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
      const float harm = w0 * acc[q][0] + w1 * acc[q][1] + w2 * acc[q][2];
      const float loud_up = w0 * l0 + w1 * l1 + w2 * l2;
      out[j] = loud_up * harm;
    }
  }
}

}  // namespace osc
