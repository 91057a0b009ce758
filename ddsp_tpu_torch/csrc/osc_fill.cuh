// Bank fills of the oscillator kernels, one sample per thread: the device
// counterpart of ddsp_tpu_torch/ops/osc_fill.py (and of the TPU fills
// ddsp_tpu/ops/pallas/oscillator.py:_fill_sine_banks_cat :58,
// _fill_sine_banks_cheb8 :104, _fill_sine_banks_cat_range :237 and
// _fill_sine_banks_rot_logdepth :266).
//
// TileFill: a thread holds one tile of 8 consecutive harmonics of its
// sample, harmonic h0 + 8g + i + 1 in slot i of tile g, and steps
// g = 0, 1, 2, ...:
//
//   kExact  every harmonic from its own split-precision phase;
//   kRot    the first tile of each chunk seeded exactly, later ones rotated
//           by the rotor e^{i 2 pi 8 x} (rot4 = chunks of 4 tiles);
//   kCheb8  s_g = 2 cos(8x) s_{g-1} - s_{g-2} (and the cosine alike), with
//           exact seeds wherever (g - g0) % resync < 2 in a chunk from g0.
//
// The rotation and the recurrence round one IEEE operation at a time
// (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never fuses), as the JAX
// code and the plain torch version do: along a 23-tile chain a fused
// multiply-add would round differently at every step.
//
// SlotFill is one slot i of that tile: the same arithmetic on the same
// values for harmonic h0 + 8g + i + 1, so its sines and cosines are
// TileFill's, bit for bit.  Its caller holds the sample's split phase and
// rotor (which all 8 slots of a sample share) and a SeedClock, which
// says which tiles are seeded exactly.

#pragma once

#include <cuda_bf16.h>

#include "osc_phase.cuh"

namespace osc {

enum Fill : int { kExact = 0, kRot = 1, kCheb8 = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kFill, bool kCos>
struct TileFill {
  float hi, lo, h0;
  float s8, c8, two_c8;  // rotor (kRot), 2 cos 8x (kCheb8)
  int resync, chunk;
  float s[8], c[8];      // tile g
  float sp[8], cp[8];    // kCheb8: tile g - 1
  float spp[8], cpp[8];  // kCheb8: tile g - 2

  __device__ __forceinline__ void init(float x, int h_start, int resync_tiles,
                                       int chunk_tiles) {
    split_phase(x, &hi, &lo);
    h0 = static_cast<float>(h_start);
    resync = resync_tiles;
    chunk = chunk_tiles;
    if (kFill != kExact) {
      sincosf(kTwoPi * harmonic_frac(hi, lo, 8.0f), &s8, &c8);
      two_c8 = 2.0f * c8;
    }
  }

  __device__ __forceinline__ void seed(int g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float h = h0 + static_cast<float>(8 * g + i + 1);
      const float a = kTwoPi * harmonic_frac(hi, lo, h);
      if (kCos || kFill == kRot) {
        sincosf(a, &s[i], &c[i]);
      } else {
        s[i] = sinf(a);
      }
    }
  }

  // Tile g, to be called for g = 0, 1, 2, ... in order.
  __device__ __forceinline__ void tile(int g) {
    if constexpr (kFill == kExact) {
      seed(g);
    } else if constexpr (kFill == kRot) {
      if (g % chunk == 0) {
        seed(g);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sn = __fadd_rn(__fmul_rn(s[i], c8), __fmul_rn(c[i], s8));
          const float cn = __fsub_rn(__fmul_rn(c[i], c8), __fmul_rn(s[i], s8));
          s[i] = sn;
          c[i] = cn;
        }
      }
    } else {
      if ((g % chunk) % resync < 2) {
        seed(g);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = __fsub_rn(__fmul_rn(two_c8, sp[i]), spp[i]);
          if (kCos) c[i] = __fsub_rn(__fmul_rn(two_c8, cp[i]), cpp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        spp[i] = sp[i];
        sp[i] = s[i];
        if (kCos) {
          cpp[i] = cp[i];
          cp[i] = c[i];
        }
      }
    }
  }
};

// TileFill::tile's seeding rule as a counter, stepped once a tile: tile g
// is seeded exactly if kExact, if g % chunk == 0 (kRot), or if
// (g % chunk) % resync < 2 (kCheb8).  No integer division in the loop.
struct SeedClock {
  int gc = 0, gr = 0, chunk, resync;  // gc = g % chunk, gr = gc % resync

  __device__ __forceinline__ SeedClock(int chunk_tiles, int resync_tiles)
      : chunk(chunk_tiles), resync(resync_tiles) {}

  template <int kFill>
  __device__ __forceinline__ bool seeded() const {
    return kFill == kExact || (kFill == kRot ? gc == 0 : gr < 2);
  }

  __device__ __forceinline__ void next() {
    if (++gc == chunk) {
      gc = 0;
      gr = 0;
    } else if (++gr == resync) {
      gr = 0;
    }
  }
};

template <int kFill, bool kCos>
struct SlotFill {
  float s, c;      // this tile's sine and cosine
  float sp, cp;    // kCheb8: tile g - 1
  float spp, cpp;  // kCheb8: tile g - 2

  // An exact seed: harmonic h (an integer as float) of the phase hi + lo.
  __device__ __forceinline__ void seed(float hi, float lo, float h) {
    const float a = kTwoPi * harmonic_frac(hi, lo, h);
    if (kCos || kFill == kRot) {
      sincosf(a, &s, &c);
    } else {
      s = sinf(a);
    }
    if (kFill == kCheb8) push();
  }

  // The next tile from the last: kRot rotates by the rotor (s8, c8);
  // kCheb8 recurs with two_c8 = 2 cos 8x (s8 unused).
  __device__ __forceinline__ void advance(float s8, float c8_or_two_c8) {
    if constexpr (kFill == kRot) {
      const float c8 = c8_or_two_c8;
      const float sn = __fadd_rn(__fmul_rn(s, c8), __fmul_rn(c, s8));
      const float cn = __fsub_rn(__fmul_rn(c, c8), __fmul_rn(s, s8));
      s = sn;
      c = cn;
    } else if constexpr (kFill == kCheb8) {
      const float two_c8 = c8_or_two_c8;
      s = __fsub_rn(__fmul_rn(two_c8, sp), spp);
      if (kCos) c = __fsub_rn(__fmul_rn(two_c8, cp), cpp);
      push();
    }
  }

 private:
  __device__ __forceinline__ void push() {
    spp = sp;
    sp = s;
    if (kCos) {
      cpp = cp;
      cp = c;
    }
  }
};

}  // namespace osc
