// Device arithmetic shared by the oscillator kernels (osc_hop_slots.cu,
// osc_frames.cu): the split-precision harmonic phase of
// ddsp_tpu_torch/ops/oscillator.py:harmonic_sines.
//
// The fundamental phase x (cycles, [0, 1)) is split as x = hi + lo with hi
// on the 1/4096 grid.  Then h * hi is exact in float32 for integer
// h <= 2048, so the frac of the harmonic's phase is exact in its coarse
// part and only h * lo (< h / 4096) is rounded: the phase error stays
// ~h * ulp(x) instead of ulp(h * x).

#pragma once

namespace osc {

constexpr float kQuant = 4096.0f;
constexpr float kInvQuant = 1.0f / 4096.0f;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ void split_phase(float x, float* hi, float* lo) {
  *hi = floorf(x * kQuant) * kInvQuant;
  *lo = x - *hi;
}

// frac(h * (hi + lo)) in [0, 1): harmonic h's phase in cycles.
__device__ __forceinline__ float harmonic_frac(float hi, float lo, float h) {
  float coarse = hi * h;  // exact: hi on the 1/4096 grid, h <= 2048
  coarse -= floorf(coarse);
  float frac = coarse + lo * h;
  return frac - floorf(frac);
}

}  // namespace osc
