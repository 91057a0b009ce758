// stft_power: the power STFT of the MSS loss over hop blocks, forward
// (stft_power_fwd) and its backward (stft_power_bwd).
//
// Replaces ddsp_tpu/ops/pallas/stft.py:_fwd_kernel (forward, K3) and
// :_bwd_kernel (backward, K4), as reached through stft_power_blocked and
// its custom_vjp (ops/spectral.py with set_stft_impl('pallas'), power 2,
// bf16 matmul inputs).  The signal of batch row b is the centre-reflect-
// padded, zero-extended row xp = xb[b] viewed flat (n_blocks * hop
// samples); frame t is xp[t*hop : t*hop + n_fft].  With the Hann-windowed
// rDFT matrices Wc, Ws (n_fft, bins), bins = n_fft/2 + 1, stored in bf16:
//
//   re[t, k]  = sum_n bf16(xp[t*hop + n]) Wc[n, k]        (float32 sums)
//   im[t, k]  = sum_n bf16(xp[t*hop + n]) Ws[n, k]
//   out[t, k] = re^2 + im^2                               (forward)
//
// and, for the magnitude gradient dmag (B, T, bins), output hop block r
// and sample j of the hop (kb = n_fft / hop):
//
//   dm        = bf16(dmag[t, k])
//   dre[t, k] = bf16(2 re dm),   dim[t, k] = bf16(2 im dm)
//   dxb[r, j] = sum_{i<kb} sum_k dre[r-i, k] Wc[i*hop + j, k]
//                               + dim[r-i, k] Ws[i*hop + j, k]
//
// over frames 0 <= r-i < T: the TPU's zero-prepend formulation
// (stft.py:28-35, :317-321), in which each output block's frame sum is a
// sum over kb shifted rows, so a block of the grid owns disjoint output
// rows and needs no cross-block accumulation.
//
// What bounds them on an H100: at the training shape (B=16, 88,064
// samples, FFT sizes 2048 ... 64 at hop n_fft/4) a scale costs
// 4 B T n_fft bins flops forward (23.2 GFLOP at 2048, 0.7 at 64): the
// three largest sizes are bound by the bf16 tensor-core rate (989 TFLOP/s,
// 0.024 / 0.012 / 0.006 ms), the three smallest by their bytes (each reads
// the 5.7 MB signal and writes 11.4 MB of magnitudes, ~0.005 ms at
// 3.35 TB/s).  The backward recomputes re/im and runs the transposed
// products: twice the forward's flops, and it reads xb and dmag and
// writes dxb.
//
// The design, right before fast:
//
// * forward: one block of 4 warps per (b, 64 frames, 64 bins).  The block
//   walks n_fft in chunks of 32: it stages the implicit frame tile
//   (64 x 32, read straight from xp and rounded to bf16 on load with
//   __float2bfloat16_rn, the round-to-nearest-even of astype(bfloat16))
//   and the Wc / Ws chunks (32 x 64) in shared memory, and each warp
//   multiplies its 16 frames into 4 + 4 wmma bf16 16x16x16 accumulators
//   (float32).  re^2 + im^2 is formed in the accumulators and written
//   through shared memory with masks at the ragged edges.
// * backward: one block of 8 warps per (b, 48 output hop blocks, 256 hop
//   columns).  For each group of up to 16 shifts and each tile of 32 bins
//   the block recomputes re/im for the 64 frames the group needs (as the
//   forward), forms dre / dim in bf16 with the two casts above, then
//   accumulates dre[r-i] Wc_i^T + dim[r-i] Ws_i^T over the group's shifts
//   into per-warp wmma accumulators.  The partial sums over bin tiles
//   therefore add inside the block in a fixed order: no float atomics,
//   and the same inputs give bit-equal gradients from run to run.
//
// Accuracy: bf16 products are exact in float32, so both kernels differ
// from the plain versions (ops/cuda/stft.py) only in the order of their
// float32 sums.  The TPU's padding (hop blocks to 128 lanes, bins to 128,
// the 8/16-row aligned windows, _pick_tiles) is dropped: every index is
// masked instead.
//
// Left for later: wgmma with TMA-fed shared tiles, a pipelined K loop, a
// persistent schedule, and keeping re/im of the backward's overlapping
// frame rows instead of recomputing them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kKC = 32;  // n_fft chunk of both kernels' re/im products

// forward tiles
constexpr int kFwdThreads = 128;  // 4 warps, 16 frames each
constexpr int kFT = 64;           // frames per block
constexpr int kFB = 64;           // bins per block
constexpr int kLdA = kKC + 8;     // row strides in elements; a multiple of
constexpr int kLdB = kFB + 8;     // 8 (bf16) or 4 (float) as wmma requires
constexpr int kLdC = kFB + 4;

// backward tiles
constexpr int kBwdThreads = 256;  // 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kFR = 48;           // output hop blocks per block
constexpr int kIG = 16;           // shifts per group: kFR + kIG - 1 <= kGR
constexpr int kGR = 64;           // frames recomputed per (group, bin tile)
constexpr int kBB = 32;           // bins per tile
constexpr int kJC = 256;          // hop columns per block
constexpr int kOutFrags = (kFR / 16) * (kJC / 16);   // 48
constexpr int kFragsPerWarp = kOutFrags / kBwdWarps;  // 6
constexpr int kLdW = kBB + 8;     // recompute's Wc / Ws chunk (kKC x kBB)
constexpr int kLdR = kBB + 4;     // re / im staging, float (kGR x kBB)
constexpr int kLdD = kBB + 16;    // dre / dim: any row offset stays 32-byte aligned
constexpr int kLdT = kJC + 8;     // W_i^T tiles (kBB x kJC)

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.0f); }

__global__ void __launch_bounds__(kFwdThreads)
stft_power_fwd_kernel(const float* __restrict__ xb,  // (B, row_len)
                      const bf16* __restrict__ wc,   // (n_fft, bins)
                      const bf16* __restrict__ ws,   // (n_fft, bins)
                      float* __restrict__ out,       // (B, T, bins)
                      int row_len, int n_fft, int hop, int n_frames, int bins) {
  __shared__ __align__(32) bf16 a_s[kFT * kLdA];
  __shared__ __align__(32) bf16 bc_s[kKC * kLdB];
  __shared__ __align__(32) bf16 bs_s[kKC * kLdB];
  __shared__ __align__(32) float c_s[kFT * kLdC];

  const int t0 = blockIdx.x * kFT;
  const int n0 = blockIdx.y * kFB;
  const size_t b = blockIdx.z;
  const float* x = xb + b * row_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  FragC re[kFB / 16], im[kFB / 16];
#pragma unroll
  for (int j = 0; j < kFB / 16; ++j) {
    wmma::fill_fragment(re[j], 0.0f);
    wmma::fill_fragment(im[j], 0.0f);
  }

  for (int k0 = 0; k0 < n_fft; k0 += kKC) {
    for (int i = tid; i < kFT * kKC; i += kFwdThreads) {
      const int r = i / kKC, c = i % kKC;
      const int t = t0 + r, k = k0 + c;
      const float v = (t < n_frames && k < n_fft) ? x[static_cast<size_t>(t) * hop + k] : 0.0f;
      a_s[r * kLdA + c] = __float2bfloat16_rn(v);
    }
    for (int i = tid; i < kKC * kFB; i += kFwdThreads) {
      const int r = i / kFB, c = i % kFB;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < n_fft && n < bins;
      const size_t w = static_cast<size_t>(k) * bins + n;
      bc_s[r * kLdB + c] = in ? wc[w] : bf16_zero();
      bs_s[r * kLdB + c] = in ? ws[w] : bf16_zero();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, a_s + warp * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFB / 16; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, bc_s + kk * kLdB + j * 16, kLdB);
        wmma::mma_sync(re[j], fa, fb, re[j]);
        wmma::load_matrix_sync(fb, bs_s + kk * kLdB + j * 16, kLdB);
        wmma::mma_sync(im[j], fa, fb, im[j]);
      }
    }
    __syncthreads();
  }

  // re and im share one fragment layout, so |S|^2 is elementwise
#pragma unroll
  for (int j = 0; j < kFB / 16; ++j) {
    for (int e = 0; e < re[j].num_elements; ++e) {
      re[j].x[e] = re[j].x[e] * re[j].x[e] + im[j].x[e] * im[j].x[e];
    }
    wmma::store_matrix_sync(c_s + warp * 16 * kLdC + j * 16, re[j], kLdC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < kFT * kFB; i += kFwdThreads) {
    const int r = i / kFB, c = i % kFB;
    const int t = t0 + r, n = n0 + c;
    if (t < n_frames && n < bins) {
      out[(b * n_frames + t) * bins + n] = c_s[r * kLdC + c];
    }
  }
}

struct BwdSmem {
  bf16 a[kGR * kLdA];     // frame chunk (kGR x kKC)
  bf16 wc[kKC * kLdW];    // Wc / Ws chunk (kKC x kBB)
  bf16 ws[kKC * kLdW];
  float re[kGR * kLdR];   // recomputed re / im (kGR x kBB); re doubles as
  float im[kGR * kLdR];   // the epilogue's per-warp staging
  bf16 dre[kGR * kLdD];   // bf16(2 re dm), bf16(2 im dm)
  bf16 dim[kGR * kLdD];
  bf16 wct[kBB * kLdT];   // W_i^T tiles: [k][j] = W[i*hop + j0 + j, n0 + k]
  bf16 wst[kBB * kLdT];
};

__global__ void __launch_bounds__(kBwdThreads)
stft_power_bwd_kernel(const float* __restrict__ xb,    // (B, row_len)
                      const float* __restrict__ dmag,  // (B, T, bins)
                      const bf16* __restrict__ wc,     // (n_fft, bins)
                      const bf16* __restrict__ ws,
                      float* __restrict__ dxb,         // (B, n_blocks, hop)
                      int n_blocks, int n_fft, int hop, int n_frames, int bins) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);

  const int r0 = blockIdx.x * kFR;
  const int j0 = blockIdx.y * kJC;
  const int jc = min(kJC, hop - j0);
  const size_t b = blockIdx.z;
  const size_t row_len = static_cast<size_t>(n_blocks) * hop;
  const float* x = xb + b * row_len;
  const float* dm_row = dmag + b * static_cast<size_t>(n_frames) * bins;
  const int kb = n_fft / hop;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the recompute: warp -> (16-frame row, 16-bin column) of the kGR x kBB tile
  const int rc_row = warp >> 1, rc_col = warp & 1;

  FragC acc[kFragsPerWarp];
#pragma unroll
  for (int q = 0; q < kFragsPerWarp; ++q) wmma::fill_fragment(acc[q], 0.0f);

  for (int ig = 0; ig < kb; ig += kIG) {
    const int ng = min(kIG, kb - ig);
    const int gbase = r0 - ig - ng + 1;  // the frame of recomputed row 0
    for (int n0 = 0; n0 < bins; n0 += kBB) {
      // 1. re / im of frames gbase .. gbase + kGR - 1 at bins n0 .. n0 + kBB - 1
      FragC fre, fim;
      wmma::fill_fragment(fre, 0.0f);
      wmma::fill_fragment(fim, 0.0f);
      for (int k0 = 0; k0 < n_fft; k0 += kKC) {
        for (int i = tid; i < kGR * kKC; i += kBwdThreads) {
          const int r = i / kKC, c = i % kKC;
          const int g = gbase + r, k = k0 + c;
          const float v = (g >= 0 && g < n_frames && k < n_fft)
                              ? x[static_cast<size_t>(g) * hop + k] : 0.0f;
          s.a[r * kLdA + c] = __float2bfloat16_rn(v);
        }
        for (int i = tid; i < kKC * kBB; i += kBwdThreads) {
          const int r = i / kBB, c = i % kBB;
          const int k = k0 + r, n = n0 + c;
          const bool in = k < n_fft && n < bins;
          const size_t w = static_cast<size_t>(k) * bins + n;
          s.wc[r * kLdW + c] = in ? wc[w] : bf16_zero();
          s.ws[r * kLdW + c] = in ? ws[w] : bf16_zero();
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, s.a + rc_row * 16 * kLdA + kk, kLdA);
          wmma::load_matrix_sync(fb, s.wc + kk * kLdW + rc_col * 16, kLdW);
          wmma::mma_sync(fre, fa, fb, fre);
          wmma::load_matrix_sync(fb, s.ws + kk * kLdW + rc_col * 16, kLdW);
          wmma::mma_sync(fim, fa, fb, fim);
        }
        __syncthreads();
      }
      wmma::store_matrix_sync(s.re + rc_row * 16 * kLdR + rc_col * 16, fre, kLdR,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(s.im + rc_row * 16 * kLdR + rc_col * 16, fim, kLdR,
                              wmma::mem_row_major);
      __syncthreads();
      // 2. dre / dim with the two bf16 casts; zero outside the frames
      for (int i = tid; i < kGR * kBB; i += kBwdThreads) {
        const int r = i / kBB, c = i % kBB;
        const int g = gbase + r, n = n0 + c;
        float dm = 0.0f;
        if (g >= 0 && g < n_frames && n < bins) {
          dm = __bfloat162float(__float2bfloat16_rn(dm_row[static_cast<size_t>(g) * bins + n]));
        }
        s.dre[r * kLdD + c] = __float2bfloat16_rn(2.0f * s.re[r * kLdR + c] * dm);
        s.dim[r * kLdD + c] = __float2bfloat16_rn(2.0f * s.im[r * kLdR + c] * dm);
      }
      // 3. the group's shifts: out[rr, j] += dre[rr + ig + ng - 1 - i] W_i^T
      for (int i = ig; i < ig + ng; ++i) {
        __syncthreads();  // dre / dim written; the previous shift's tiles read
        for (int e = tid; e < kBB * kJC; e += kBwdThreads) {
          const int k = e % kBB, j = e / kBB;  // consecutive threads: consecutive bins
          const int n = n0 + k;
          const bool in = j < jc && n < bins;
          const size_t w = (static_cast<size_t>(i) * hop + j0 + j) * bins + n;
          s.wct[k * kLdT + j] = in ? wc[w] : bf16_zero();
          s.wst[k * kLdT + j] = in ? ws[w] : bf16_zero();
        }
        __syncthreads();
        const int shift = ig + ng - 1 - i;
#pragma unroll
        for (int q = 0; q < kFragsPerWarp; ++q) {
          const int f = warp + kBwdWarps * q;
          const int rf = f / (kJC / 16), cf = f % (kJC / 16);
          if (cf * 16 < jc) {  // warp-uniform
#pragma unroll
            for (int kk = 0; kk < kBB; kk += 16) {
              FragA fa;
              FragB fb;
              const int row = (shift + rf * 16) * kLdD + kk;
              wmma::load_matrix_sync(fa, s.dre + row, kLdD);
              wmma::load_matrix_sync(fb, s.wct + kk * kLdT + cf * 16, kLdT);
              wmma::mma_sync(acc[q], fa, fb, acc[q]);
              wmma::load_matrix_sync(fa, s.dim + row, kLdD);
              wmma::load_matrix_sync(fb, s.wst + kk * kLdT + cf * 16, kLdT);
              wmma::mma_sync(acc[q], fa, fb, acc[q]);
            }
          }
        }
      }
      __syncthreads();  // the next bin tile rewrites a, re, im, dre, dim
    }
  }

  // epilogue: each warp stages its fragments (16 x 16) and writes them masked
  float* stage = s.re + warp * 256;
#pragma unroll
  for (int q = 0; q < kFragsPerWarp; ++q) {
    const int f = warp + kBwdWarps * q;
    const int rf = f / (kJC / 16), cf = f % (kJC / 16);
    if (cf * 16 < jc) {
      wmma::store_matrix_sync(stage, acc[q], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = r0 + rf * 16 + e / 16;
        const int j = j0 + cf * 16 + e % 16;
        if (rr < n_blocks && j < hop) {
          dxb[(b * n_blocks + rr) * hop + j] = stage[e];
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  The caller has checked: b <= 65535 batch rows, hop divides
// n_fft, n_fft <= 4096, n_frames >= 1 and (n_frames - 1) * hop + n_fft
// <= n_blocks * hop.

extern "C" int stft_power_fwd(const float* xb, const bf16* wc, const bf16* ws,
                              float* out, int b, int n_blocks, int hop,
                              int n_fft, int n_frames, void* stream) {
  if (b == 0 || n_frames == 0) return 0;
  const int bins = n_fft / 2 + 1;
  const dim3 grid((n_frames + kFT - 1) / kFT, (bins + kFB - 1) / kFB, b);
  stft_power_fwd_kernel<<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xb, wc, ws, out, n_blocks * hop, n_fft, hop, n_frames, bins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stft_power_bwd(const float* xb, const float* dmag, const bf16* wc,
                              const bf16* ws, float* dxb, int b, int n_blocks,
                              int hop, int n_fft, int n_frames, void* stream) {
  if (b == 0 || n_blocks == 0) return 0;
  const int bins = n_fft / 2 + 1;
  const size_t smem = sizeof(BwdSmem);  // ~73 KB: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      stft_power_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_blocks + kFR - 1) / kFR, (hop + kJC - 1) / kJC, b);
  stft_power_bwd_kernel<<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xb, dmag, wc, ws, dxb, n_blocks, n_fft, hop, n_frames, bins);
  return static_cast<int>(cudaGetLastError());
}
