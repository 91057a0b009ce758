// osc_frames: the offline harmonic render over the frames of a batch,
// forward (osc_frames_fwd) and its one-pass backward (osc_frames_bwd), and
// the overlap-add of the backward's window gradients (osc_frames_overlap_add).
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
//   dphase[b, t, j]     = ql * sum_k w[j,k] sum_h (2 pi (h0+h+1) A[b,t+k,h]) cos(.)
//   da_win[b, t, k, h]  = sum_j ql w[j,k] sin(2 pi (h0+h+1) x_j)
//   dl_win[b, t, k]     = sum_j g harm w[j,k]
//
// and osc_frames_overlap_add sums the window gradients onto the padded
// frame axis (row t+k of A and L), as _pallas_backward does (:1046-1052):
// row r = win0[r] + win1[r-1] + win2[r-2], added to 0 in that order, the
// float additions of the plain loop (ops/cuda/osc_frames.py:
// overlap_add_windows), so the two agree bit for bit.
//
// What bounds them on an H100: issue slots.  At the training shape (B=16,
// T=172, hop 512, H=180) there are 2.54e8 (sample, harmonic) points, and
// the card's fill (kRot, the TPU kernels' own) must round its rotation one
// IEEE operation at a time, as the JAX code and the plain version do: 6
// unfused operations a point.  The forward adds 3 window FMAs (~11 issue
// slots a point with the seeds, ~0.085 ms at 3.35e13 lane-operations a
// second), the backward 9 (harm, the phase derivative and the window-
// amplitude gradient: ~17 with the seeds, ~0.13 ms).  The operands are
// ~13 MB (forward) and ~21 MB (backward), far below that.  Tensor cores do
// not pay: every contraction here has 3 outputs (three windows per
// harmonic, or three per sample), and at the float32 grade of the contract
// a TF32 split takes 3 mma passes plus 2-3 split instructions per element,
// more issue slots than the 3 FMAs it replaces (K6, osc_banked_bwd.cu,
// covers the bf16 layout).  So both kernels keep every operand in
// registers and spend shared memory on nothing per point:
//
// * forward: one thread renders 4 samples of a frame, strided by the
//   block (stores coalesce), each with the 8 harmonic slots of a tile
//   (osc::SlotFill: TileFill's arithmetic slot by slot, osc_fill.cuh), all
//   seeded by one osc::SeedClock (one uniform branch a tile, no integer
//   division).  The frame's three amplitude rows sit in shared memory,
//   zero-padded to a multiple of 8 harmonics (no test per point), and each
//   tile's 8 x 3 amplitudes are read once per thread as 16-byte broadcasts
//   that serve all 4 samples (0.19 loads a point, from 3).  Blocks of up to
//   128 threads, fewer for short hops.  The sums run over harmonics in
//   order, as before: the forward's bits are unchanged.
// * backward: one block of 4 warps per frame.  A lane owns one harmonic
//   slot i of every 8-harmonic tile (harmonic h0 + 8g + i + 1) for 8
//   samples: a warp is 8 slots x 4 groups of 8 samples, and each lane loads
//   one sample (the group's lane q loads its sample q: coalesced).  The
//   group's 8 lanes share their samples' split phase, rotor e^{i 2 pi 8x}
//   and ql w_k by __shfl_sync, so each is computed once per sample; each
//   lane steps its slot's fill (osc::SlotFill, TileFill's arithmetic per
//   slot, bit for bit) over the tiles with 8 rotation chains in flight.
//   - Sums over harmonics (harm and the phase derivative, 6 a sample)
//     accumulate in registers across the tiles, then three __shfl_xor
//     steps reduce-scatter them over the 8 slot lanes, so each lane ends
//     with its own sample's sums and writes its dphase.  The phase
//     derivative is sum (A 2 pi h) cos, the JAX kernel's a_scaled.
//   - Sums over samples (the window-amplitude gradient, 3 a harmonic)
//     accumulate over a lane's 8 samples, and each tile adds them to the
//     lane's own partial row in shared memory (one per warp and group, a
//     float4 of the 3 windows a harmonic: one 16-byte load and store;
//     for H over 270, where those rows would not fit, the 4 groups are
//     first summed by two __shfl_xor steps and one row per warp is kept).
//     The partials and the next tile's amplitudes (float4 rows too) are
//     loaded a tile ahead.  After the warps' passes over the frame's
//     samples, one barrier, and the partials are summed in (warp, group)
//     order.
//   - dloud is a fixed-order block reduction of the lanes' sums.
//   No float atomics: the gradients are the same from run to run.  At 168
//   registers or fewer, 3 blocks (12 warps) run on an SM.
//
// Accuracy: every harmonic's phase is formed as in harmonic_sines
// (osc_phase.cuh) with h = h0 + i + 1, and sines and cosines are the
// accurate sinf / sincosf (build without --use_fast_math).  Sums are
// float32 throughout.  The TPU's backward contracts at DEFAULT precision
// (one bf16-grade pass, _BWD_CONTRACT_DTYPE None with f32 banks); these
// kernels compute in full float32, which is stricter.  The TPU's padding
// (T to its 16-frame block, H to 256 lanes, loudness repeated over 128
// lanes, the (ft+2)-row amps_win copy) is dropped: the grid covers exactly
// B x T frames and masks ragged hops.
//
// Options (K8: the fill and dtype options of _kernel_banked2 / _bwd,
// :507-520, :894-906), as compile-time template parameters, so each
// instantiation has no run-time branch on them:
//
// * kFill: kExact (every harmonic's own sine), kRot (the card's default),
//   kCheb8 (osc_fill.cuh; rot4 is kRot with chunks of 4 tiles).
//   resync_tiles and chunk_tiles (k_chunk / 8) are run-time ints read by
//   the fills' seeding rule only.
// * kBf16: the contraction's operands rounded to bfloat16 (nearest even),
//   sums in float32: in the forward the sines and the amplitude rows
//   (bank_dtype='bfloat16', or precision DEFAULT: one bf16 MXU pass); in the
//   backward the JAX kernel's three operand pairs under contract_dtype or a
//   bf16 bank (:845-876): the sines and ql*w_k for the window-amplitude
//   gradient, the sines and the rounded amplitudes for harm, the cosines
//   and bf16(bf16(A) * 2 pi h) for the phase derivative.  The fill itself
//   stays float32.
//
// Left for later: the forward on the backward's slot ownership (its
// harmonic sums would then be reduce-scattered, not sequential), a
// persistent schedule over frames (the backward runs ~7 waves of blocks at
// the training shape), and the overlap-add folded into the backward.

#include <cuda_runtime.h>

#include "osc_fill.cuh"
#include "osc_phase.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 128;   // at most: fewer for hops under 512
constexpr int kFwdSamples = 4;     // samples a forward thread, strided by the block
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdSamples = 8;     // samples a backward lane: one per lane of its group
constexpr int kBwdMinBlocks = 3;   // registers <= 168
constexpr int kGroups = 32 / kBwdSamples;  // sample groups of a warp
// Per-group partial rows while they fit 3 blocks on an SM.
constexpr size_t kGroupRowsSmemLimit = 72 * 1024;

__host__ __device__ __forceinline__ int padded_harmonics(int n_harm) {
  return (n_harm + 7) / 8 * 8;
}

size_t bwd_smem_bytes(int n_harm, int part_groups) {
  const size_t hp = padded_harmonics(n_harm);
  return sizeof(float4) * (hp + 8 + static_cast<size_t>(kBwdWarps) * part_groups * hp) +
         sizeof(float) * kBwdWarps * 3;
}

template <int kFill, bool kBf16>
__global__ void __launch_bounds__(kFwdThreads)
osc_frames_fwd_kernel(const float* __restrict__ phase,  // (B, T, hop)
                      const float* __restrict__ amps,   // (B, T+2, H)
                      const float* __restrict__ loud,   // (B, T+2)
                      const float* __restrict__ w,      // (hop, 3)
                      float* __restrict__ out,          // (B, T, hop)
                      int n_frames, int hop, int n_harm, int h_start,
                      int tiles_per_frame, int resync_tiles, int chunk_tiles) {
  extern __shared__ float4 rows4[];  // [3][hp / 4]: amps rows t .. t+2
  float* rows = reinterpret_cast<float*>(rows4);
  const int hp = padded_harmonics(n_harm);
  const int frame = blockIdx.x / tiles_per_frame;
  const int tile = blockIdx.x - frame * tiles_per_frame;
  const size_t b = blockIdx.y;
  // rows t .. t+2 of one batch row are contiguous: 3 * n_harm floats
  const float* a0 = amps + (b * (n_frames + 2) + frame) * n_harm;
  for (int i = threadIdx.x; i < 3 * hp; i += blockDim.x) {
    const int k = i / hp;
    const int h = i - k * hp;
    const float v = h < n_harm ? a0[k * n_harm + h] : 0.0f;
    rows[i] = kBf16 ? osc::round_bf16(v) : v;
  }
  __syncthreads();

  const int j0 = tile * kFwdSamples * blockDim.x + threadIdx.x;
  const size_t base = (b * n_frames + frame) * hop;
  // TileFill's arithmetic, slot by slot (osc::SlotFill), so that the
  // samples share one seeding rule (osc::SeedClock: no division a tile).
  osc::SlotFill<kFill, false> f[kFwdSamples][8];
  float hi[kFwdSamples], lo[kFwdSamples], r0[kFwdSamples], r1[kFwdSamples];
  float acc[kFwdSamples][3];
#pragma unroll
  for (int q = 0; q < kFwdSamples; ++q) {
    const int j = j0 + q * blockDim.x;
    osc::split_phase(j < hop ? phase[base + j] : 0.0f, &hi[q], &lo[q]);
    r0[q] = 0.0f;  // kRot: the rotor (s8, c8); kCheb8: (-, 2 cos 8x)
    r1[q] = 0.0f;
    if (kFill != osc::kExact) {
      float s8, c8;
      sincosf(osc::kTwoPi * osc::harmonic_frac(hi[q], lo[q], 8.0f), &s8, &c8);
      r0[q] = s8;
      r1[q] = kFill == osc::kRot ? c8 : 2.0f * c8;
    }
    acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
  }
  osc::SeedClock clock(chunk_tiles, resync_tiles);
  float h = static_cast<float>(h_start + 1);  // slot 0's harmonic
  for (int g = 0; g < hp / 8; ++g, h += 8.0f) {
    if (clock.seeded<kFill>()) {  // uniform
#pragma unroll
      for (int q = 0; q < kFwdSamples; ++q) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[q][i].seed(hi[q], lo[q], h + static_cast<float>(i));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kFwdSamples; ++q) {
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
        for (int q = 0; q < kFwdSamples; ++q) {
          const float s = kBf16 ? osc::round_bf16(f[q][i].s) : f[q][i].s;
          acc[q][k] = fmaf(a[k][i], s, acc[q][k]);
        }
      }
    }
  }

  const float* ld = loud + b * (n_frames + 2) + frame;
  const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
#pragma unroll
  for (int q = 0; q < kFwdSamples; ++q) {
    const int j = j0 + q * blockDim.x;
    if (j < hop) {
      const float w0 = w[3 * j], w1 = w[3 * j + 1], w2 = w[3 * j + 2];
      const float harm = w0 * acc[q][0] + w1 * acc[q][1] + w2 * acc[q][2];
      const float loud_up = w0 * l0 + w1 * l1 + w2 * l2;
      out[base + j] = loud_up * harm;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// c ? a : b as one selp: a select of two array elements written in C may
// become a load from a computed address, and so the array a local one.
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<unsigned>(c)));
  return r;
}

// x[n][q]: this lane's partial sums (over its slot's harmonics) for sample
// q of its group.  Three butterfly steps over the group's 8 slot lanes
// reduce-scatter them: the lane of slot i ends with out[n] = the sum over
// all 8 slots for sample q = i.  A fixed order: the same bits every run.
template <int kN>
__device__ __forceinline__ void slot_reduce_scatter(const float (&x)[kN][8], int slot,
                                                    float (&out)[kN]) {
  const bool b2 = slot & 4, b1 = slot & 2, b0 = slot & 1;
  float y[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float keep = select(b2, x[n][4 + m], x[n][m]);
      const float send = select(b2, x[n][m], x[n][4 + m]);
      y[n][m] = keep + __shfl_xor_sync(kFull, send, 4);
    }
  }
  float z[kN][2];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float keep = select(b1, y[n][2 + m], y[n][m]);
      const float send = select(b1, y[n][m], y[n][2 + m]);
      z[n][m] = keep + __shfl_xor_sync(kFull, send, 2);
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const float keep = select(b0, z[n][1], z[n][0]);
    const float send = select(b0, z[n][0], z[n][1]);
    out[n] = keep + __shfl_xor_sync(kFull, send, 1);
  }
}

template <int kFill, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
osc_frames_bwd_kernel(const float* __restrict__ g,      // (B, T, hop)
                      const float* __restrict__ phase,  // (B, T, hop)
                      const float* __restrict__ amps,   // (B, T+2, H)
                      const float* __restrict__ loud,   // (B, T+2)
                      const float* __restrict__ w,      // (hop, 3)
                      float* __restrict__ dphase,       // (B, T, hop)
                      float* __restrict__ da_win,       // (B, T, 3, H)
                      float* __restrict__ dl_win,       // (B, T, 3)
                      int n_frames, int hop, int n_harm, int h_start,
                      int resync_tiles, int chunk_tiles, int part_groups) {
  extern __shared__ float4 smem4[];
  const int hp = padded_harmonics(n_harm);
  const int n_parts = kBwdWarps * part_groups;
  float4* rows = smem4;                    // [hp + 8] (A[t], A[t+1], A[t+2], 0), zero-padded
  float4* part = rows + hp + 8;            // [n_parts][hp] window-amp partials (k = x, y, z)
  float* dlp = reinterpret_cast<float*>(part + n_parts * hp);  // [kBwdWarps][3] dloud partials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = lane & 7;   // harmonic slot of each tile
  const int grp = lane >> 3;   // group of 8 samples
  const size_t b = blockIdx.y;
  const size_t fr = b * n_frames + blockIdx.x;  // (b, t) frame index
  const float* a0 = amps + (b * (n_frames + 2) + blockIdx.x) * n_harm;
  for (int h = tid; h < hp + 8; h += kBwdThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (h < n_harm) {
      v.x = a0[h];
      v.y = a0[n_harm + h];
      v.z = a0[2 * n_harm + h];
      if (kBf16) {
        v.x = osc::round_bf16(v.x);
        v.y = osc::round_bf16(v.y);
        v.z = osc::round_bf16(v.z);
      }
    }
    rows[h] = v;
  }
  for (int i = tid; i < n_parts * hp; i += kBwdThreads) {
    part[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float* ld = loud + b * (n_frames + 2) + blockIdx.x;
  const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
  const float* gf = g + fr * hop;
  const float* pf = phase + fr * hop;
  float4* my_part = part + (warp * part_groups + (part_groups > 1 ? grp : 0)) * hp + slot;
  float dl0 = 0.0f, dl1 = 0.0f, dl2 = 0.0f;
  __syncthreads();

  // Each warp walks its own 32-sample passes: no barrier inside.
  for (int j0 = warp * 32; j0 < hop; j0 += kBwdThreads) {
    // 1. this lane's sample j: sample `slot` of group `grp`
    const int j = j0 + lane;
    const bool live = j < hop;
    float x = 0.0f, gj = 0.0f, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    if (live) {
      x = pf[j];
      gj = gf[j];
      w0 = w[3 * j];
      w1 = w[3 * j + 1];
      w2 = w[3 * j + 2];
    }
    const float ql = gj * (w0 * l0 + w1 * l1 + w2 * l2);
    float qw0 = ql * w0, qw1 = ql * w1, qw2 = ql * w2;
    if (kBf16) {
      qw0 = osc::round_bf16(qw0);
      qw1 = osc::round_bf16(qw1);
      qw2 = osc::round_bf16(qw2);
    }
    float hi, lo;
    osc::split_phase(x, &hi, &lo);
    float r0 = 0.0f, r1 = 0.0f;  // kRot: the rotor (s8, c8); kCheb8: (-, 2 cos 8x)
    if (kFill != osc::kExact) {
      float s8, c8;
      sincosf(osc::kTwoPi * osc::harmonic_frac(hi, lo, 8.0f), &s8, &c8);
      r0 = s8;
      r1 = kFill == osc::kRot ? c8 : 2.0f * c8;
    }

    // 2. the group's 8 samples, from the lanes that loaded them
    float qw[3][kBwdSamples], rs[kBwdSamples], rc[kBwdSamples];
#pragma unroll
    for (int q = 0; q < kBwdSamples; ++q) {
      qw[0][q] = __shfl_sync(kFull, qw0, q, kBwdSamples);
      qw[1][q] = __shfl_sync(kFull, qw1, q, kBwdSamples);
      qw[2][q] = __shfl_sync(kFull, qw2, q, kBwdSamples);
      rs[q] = __shfl_sync(kFull, r0, q, kBwdSamples);
      rc[q] = __shfl_sync(kFull, r1, q, kBwdSamples);
    }

    // 3. the tiles: this lane's slot for its group's 8 samples
    osc::SlotFill<kFill, true> f[kBwdSamples];
    float acc[6][kBwdSamples];  // harm sums (windows 0-2), phase-derivative sums (0-2)
#pragma unroll
    for (int n = 0; n < 6; ++n) {
#pragma unroll
      for (int q = 0; q < kBwdSamples; ++q) acc[n][q] = 0.0f;
    }
    osc::SeedClock clock(chunk_tiles, resync_tiles);
    float h = static_cast<float>(h_start + slot + 1);  // this slot's harmonic
    const float4* ar = rows + slot;
    float4* pr = my_part;
    float4 a = ar[0];
    for (int gt = 0; gt < hp / 8; ++gt, h += 8.0f, ar += 8, pr += 8) {
      // loaded a tile ahead of their use: this tile's partials and the next
      // tile's amplitudes (the rows' 8 entries of padding end the last)
      const float4 p = pr[0];
      const float4 next = ar[8];
      const float a_0 = a.x, a_1 = a.y, a_2 = a.z;
      if (clock.seeded<kFill>()) {  // warp-uniform
#pragma unroll
        for (int q = 0; q < kBwdSamples; ++q) {
          f[q].seed(__shfl_sync(kFull, hi, q, kBwdSamples),
                    __shfl_sync(kFull, lo, q, kBwdSamples), h);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kBwdSamples; ++q) f[q].advance(rs[q], rc[q]);
      }
      clock.next();
      const float h2pi = osc::kTwoPi * h;
      float as0 = a_0 * h2pi, as1 = a_1 * h2pi, as2 = a_2 * h2pi;
      if (kBf16) {
        as0 = osc::round_bf16(as0);
        as1 = osc::round_bf16(as1);
        as2 = osc::round_bf16(as2);
      }
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
#pragma unroll
      for (int q = 0; q < kBwdSamples; ++q) {
        const float s = kBf16 ? osc::round_bf16(f[q].s) : f[q].s;
        const float c = kBf16 ? osc::round_bf16(f[q].c) : f[q].c;
        acc[0][q] = fmaf(a_0, s, acc[0][q]);
        acc[1][q] = fmaf(a_1, s, acc[1][q]);
        acc[2][q] = fmaf(a_2, s, acc[2][q]);
        acc[3][q] = fmaf(as0, c, acc[3][q]);
        acc[4][q] = fmaf(as1, c, acc[4][q]);
        acc[5][q] = fmaf(as2, c, acc[5][q]);
        d0 = fmaf(qw[0][q], s, d0);
        d1 = fmaf(qw[1][q], s, d1);
        d2 = fmaf(qw[2][q], s, d2);
      }
      if (part_groups == 1) {  // one row per warp: sum the 4 groups first
        d0 += __shfl_xor_sync(kFull, d0, 8);
        d1 += __shfl_xor_sync(kFull, d1, 8);
        d2 += __shfl_xor_sync(kFull, d2, 8);
        d0 += __shfl_xor_sync(kFull, d0, 16);
        d1 += __shfl_xor_sync(kFull, d1, 16);
        d2 += __shfl_xor_sync(kFull, d2, 16);
      }
      if (part_groups > 1 || grp == 0) {
        pr[0] = make_float4(p.x + d0, p.y + d1, p.z + d2, 0.0f);
      }
      a = next;
    }

    // 4. this lane's own sample: its sums over all harmonics
    float y[6];
    slot_reduce_scatter<6>(acc, slot, y);
    if (live) dphase[fr * hop + j] = ql * (w0 * y[3] + w1 * y[4] + w2 * y[5]);
    const float gh = gj * (w0 * y[0] + w1 * y[1] + w2 * y[2]);
    dl0 = fmaf(gh, w0, dl0);
    dl1 = fmaf(gh, w1, dl1);
    dl2 = fmaf(gh, w2, dl2);
  }

  dl0 = warp_sum(dl0);
  dl1 = warp_sum(dl1);
  dl2 = warp_sum(dl2);
  if (lane == 0) {
    dlp[warp * 3] = dl0;
    dlp[warp * 3 + 1] = dl1;
    dlp[warp * 3 + 2] = dl2;
  }
  __syncthreads();
  // 5. the window-amplitude partials, summed in (warp, group) order
  float* out = da_win + fr * 3 * n_harm;
  for (int h = tid; h < n_harm; h += kBwdThreads) {
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    for (int v = 0; v < n_parts; ++v) {
      const float4 p = part[v * hp + h];
      r0 += p.x;
      r1 += p.y;
      r2 += p.z;
    }
    out[h] = r0;
    out[n_harm + h] = r1;
    out[2 * n_harm + h] = r2;
  }
  if (tid < 3) {
    float r = 0.0f;
    for (int v = 0; v < kBwdWarps; ++v) r += dlp[v * 3 + tid];
    dl_win[fr * 3 + tid] = r;
  }
}

// d_amps[b, r, h] = win0[r] + win1[r-1] + win2[r-2] (rows that exist),
// d_loud alike: one thread an output, added to 0 in k order as the plain
// loop adds (__fadd_rn: the compiler may not drop the 0 + x, which makes
// -0 into +0 as the plain version does).
__global__ void osc_frames_overlap_add_kernel(const float* __restrict__ da_win,  // (B, T, 3, H)
                                              const float* __restrict__ dl_win,  // (B, T, 3)
                                              float* __restrict__ d_amps,        // (B, T+2, H)
                                              float* __restrict__ d_loud,        // (B, T+2)
                                              int n_frames, int n_harm,
                                              long long n_amps, long long n_all) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_all) return;
  const bool is_amp = e < n_amps;
  const long long row = is_amp ? e / n_harm : e - n_amps;  // b * (T+2) + r
  const int h = is_amp ? static_cast<int>(e - row * n_harm) : 0;
  const long long bb = row / (n_frames + 2);
  const int r = static_cast<int>(row - bb * (n_frames + 2));
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int t = r - k;
    if (t >= 0 && t < n_frames) {
      const long long win = (bb * n_frames + t) * 3 + k;
      acc = __fadd_rn(acc, is_amp ? da_win[win * n_harm + h] : dl_win[win]);
    }
  }
  if (is_amp) {
    d_amps[e] = acc;
  } else {
    d_loud[row] = acc;
  }
}

template <int kFill, bool kBf16>
int launch_fwd(const float* phase, const float* amps, const float* loud,
               const float* w, float* out, int b, int t, int hop, int n_harm,
               int h_start, int resync_tiles, int chunk_tiles,
               cudaStream_t stream) {
  // a warp's multiple, at most 128 threads, covering the hop in 4 samples each
  const int per_thread = (hop + kFwdSamples - 1) / kFwdSamples;
  const int threads = per_thread >= kFwdThreads ? kFwdThreads : (per_thread + 31) / 32 * 32;
  const int per_block = threads * kFwdSamples;
  const int tiles = (hop + per_block - 1) / per_block;
  const dim3 grid(t * tiles, b);
  const size_t smem = 3 * static_cast<size_t>(padded_harmonics(n_harm)) * sizeof(float);
  osc_frames_fwd_kernel<kFill, kBf16><<<grid, threads, smem, stream>>>(
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
  const int part_groups = bwd_smem_bytes(n_harm, kGroups) <= kGroupRowsSmemLimit ? kGroups : 1;
  const size_t smem = bwd_smem_bytes(n_harm, part_groups);  // <= 161 KB at n_harm 2048
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        osc_frames_bwd_kernel<kFill, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(t, b);
  osc_frames_bwd_kernel<kFill, kBf16><<<grid, kBwdThreads, smem, stream>>>(
      g, phase, amps, loud, w, dphase, da_win, dl_win, t, hop, n_harm,
      h_start, resync_tiles, chunk_tiles, part_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points launch on `stream` and return cudaGetLastError() (0 on
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

// (B, T, 3, H), (B, T, 3) window gradients -> (B, T+2, H), (B, T+2).
extern "C" int osc_frames_overlap_add(const float* da_win, const float* dl_win,
                                      float* d_amps, float* d_loud, int b, int t,
                                      int n_harm, void* stream) {
  if (b == 0) return 0;
  const long long rows = static_cast<long long>(b) * (t + 2);
  const long long n_amps = rows * n_harm;
  const long long n_all = n_amps + rows;
  constexpr int kThreads = 256;
  osc_frames_overlap_add_kernel<<<static_cast<unsigned>((n_all + kThreads - 1) / kThreads),
                                  kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      da_win, dl_win, d_amps, d_loud, t, n_harm, n_amps, n_all);
  return static_cast<int>(cudaGetLastError());
}
