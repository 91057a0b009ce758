// stft_power: the power STFT of the MSS loss over hop blocks, forward
// (stft_power_fwd) and its backward (stft_power_bwd_recompute, then
// stft_power_bwd_shifted), on wgmma.
//
// Replaces ddsp_tpu/ops/pallas/stft.py:_fwd_kernel (forward, K3, launched
// at :197) and :_bwd_kernel (backward, K4, launched at :271), as reached
// through stft_power_blocked and its custom_vjp (ops/spectral.py with
// set_stft_impl('pallas'), power 2, bf16 matmul inputs).  The signal of
// batch row b is the centre-reflect-padded, zero-extended row xp = xq[b]
// viewed flat (n_blocks * hop samples), xq the bf16 copy of the hop blocks
// the wrapper makes with one cast; frame t is xp[t*hop : t*hop + n_fft].
// With the Hann-windowed rDFT matrices Wc, Ws (n_fft, bins), bins =
// n_fft/2 + 1, in bf16:
//
//   re[t, k]  = sum_n xp[t*hop + n] Wc[n, k]              (float32 sums)
//   im[t, k]  = sum_n xp[t*hop + n] Ws[n, k]
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
// over frames 0 <= r-i < T (the TPU's zero-prepend formulation,
// stft.py:28-35).
//
// What bounds them on an H100 (chip_smoke.stft_bounds_ms; B=16, 88,064
// samples, hop n_fft/4): the forward's 4 B T n_fft bins flops at the bf16
// tensor-core peak, 989 TFLOP/s, bind n_fft 2048 / 1024 / 512 (23.2 /
// 11.6 / 5.8 GFLOP: 0.0235 / 0.0117 / 0.0059 ms); its bytes at 3.35 TB/s
// bind 256 / 128 / 64 (the 2.8 MB bf16 signal in, 11.4-14.1 MB of
// magnitudes out: ~0.0043 ms each).  The backward does twice the flops
// (0.047 ms at 2048); at 64 its bytes bind (the bf16 signal and float32
// dmag in, the 5.6 MB float32 dxb out: 0.0060 ms).
//
// The design.  All three launches are one GEMM shape.  A CTA is four
// warpgroups; each owns an M tile of 64 rows (frames, or output hop
// blocks), taken in turn from the flattened (batch row, tile) list, so a
// tile never straddles batch rows, and all four share the B tile of N
// columns.  The CTA walks K in steps of 64 through a ring of kStages
// shared-memory stages: thread 0 starts a step's copies by TMA (tensor
// maps built in the C entry points, zeros outside every operand) on the
// stage's mbarrier kStages - 1 steps ahead, and each warpgroup multiplies
// with wgmma m64nNk16 (bf16 in, float32 sums) from the landed stage.  Both
// operands are K-major 128-byte swizzled tiles (csrc/hopper_mma.cuh).
// Why: with one warpgroup a CTA and per-thread cp.async copies, an SM took
// in ~19 bytes a clock of tiles whatever the number of SMs at work, and
// every launch waited on its tiles (PERF.md).  Sharing B across four
// M tiles halves the tile bytes a flop (12 against 24 KB a MFLOP at N =
// 128), and the TMA keeps more of them in flight an SM.
// The sums chain through the whole of K in the tensor cores' float32
// accumulators, in a fixed order: every output element is owned by one
// warpgroup of one CTA, no atomics, and reruns are bit-equal.
//
// * forward (K3): M = frames, N = 128 = one group of 64 bins, re in
//   columns 0-63 and im in 64-127, K = n_fft.  A is the frame matrix
//   itself: a 3D tensor map over xq (sample k < n_fft, frame t < T with a
//   stride of hop samples, batch row b), whose frames overlap.  When hop
//   % 8 != 0 a frame is not 16-byte aligned for the TMA; then every thread
//   loads its 16-byte chunk of each A tile element by element and stores
//   it (the same kernel).  B is the cached layout Wt (2 bins_pad, ru(n_fft,
//   8)): bins padded with zeros to a multiple of 64, each group's Wc^T rows
//   followed by its Ws^T rows.  A thread holding column c also holds c +
//   64, so |S|^2 forms in registers; it is staged in shared memory and
//   stored coalesced, masked to (B, T, bins).
//   Grid: ceil(B ceil(T / 64) / 4) x (bins_pad / 64): 12 x 17 CTAs at
//   n_fft 2048.
// * backward, launch (a) (recompute): the forward's GEMM with another
//   epilogue: it reads dmag (B, T, bins) through shared memory, applies
//   the TPU kernel's two bf16 casts and writes dre | dim as bf16 into the
//   scratch D (B, T, 2 bins_pad) in Wt's group order (zeros at padded
//   bins).  On the TPU recomputing re/im in the shifted product's kernel
//   beat writing them to HBM; here D costs 11.4-14.1 MB a size, ~0.008
//   ms to write and read back, against recomputing it for every column
//   tile of every shift.
// * backward, launch (b) (shifted GEMM): M = output hop blocks, N = hop
//   columns (wgmma n = 16, 32 or 64, the least power of two >= hop, up to
//   64; hop > 64 takes ceil(hop / 64) column tiles: 96 CTAs at n_fft 2048
//   against 48 with n = 128), K = kb x 2
//   bins_pad: the A tile of shift i is the box of D's tensor map at frame
//   rows r - i (the TMA fills zeros outside 0 <= r - i < T), B the cached
//   (n_fft, 2 bins_pad) Wcat = Wt^T, whose row i*hop + j is contiguous
//   along K.  The whole reduction runs in one CTA: no cross-block sum.
//
// Accuracy: bf16 products are exact in float32, so the kernels differ
// from the plain versions (ops/cuda/stft.py) only in the order and the
// rounding of their float32 sums (and, in the backward, the bf16 casts
// that this flips).  Hopper's tensor cores truncate their running sums;
// chained over n_fft 2048 K3 measures 108.6 dB against its plain version
// on an H100 (chip_smoke.py phase 8), above its 90 dB floor, which the
// card test also holds at 4096 (S1, whose bf16 intermediates amplify the
// error, runs short chains instead).
//
// Left for later: a persistent schedule (one CTA an SM walking tiles, the
// next tile's loads under this one's epilogue), warp specialisation (a
// producer warp, the consumers' waits asynchronous across steps), loading
// launch (b)'s D rows once for all kb shifts of a K step (each A tile is
// the previous shift's moved by one row), and fusing (a) into (b) (a CTA
// of (b) recomputing the D rows it needs once).

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 4;              // M tiles a CTA, one a warpgroup
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kM = 64;                      // rows of an M tile
constexpr int kK = 64;                      // K a step: one swizzled 128-byte row
constexpr int kStages = 4;                  // the TMA ring
constexpr int kATile = kM * kK * 2;         // 8 KB
constexpr int kATiles = kWarpgroups * kATile;
constexpr int kGroup = 64;                  // bins a group (re | im: N = 128)
constexpr int kGroupN = 2 * kGroup;
constexpr int kMaxShiftN = 64;              // launch (b)'s widest column tile
constexpr int kLdF = kGroup + 4;            // float staging rows (68 floats)
constexpr int kLdD = kGroupN + 8;           // bf16 staging rows of D (272 bytes)
static_assert(kM * 8 == kThreads, "a thread stores one 16-byte chunk of each A tile");

__host__ __device__ constexpr int stage_bytes(int n) { return kATiles + n * kK * 2; }
// the ring, its kStages mbarriers, 1 KB to align the tiles
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return static_cast<size_t>(kStages) * stage_bytes(n) + kStages * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A warpgroup's M tile: rows row0 .. row0 + valid - 1 (frames, or output
// hop blocks) of batch row b; tile p of the flattened (batch row, tile)
// list.  Past the list's end b = batch (out of every tensor map: the TMA
// fills zeros) and valid = 0.  Tiles never straddle batch rows.
struct Tile {
  int b, row0, valid;
};

__device__ __forceinline__ Tile tile_of(int p, int tiles, int batch, int rows) {
  if (p >= batch * tiles) return Tile{batch, 0, 0};
  const int b = p / tiles, row0 = (p - b * tiles) * kM;
  return Tile{b, row0, min(kM, rows - row0)};
}

__device__ __forceinline__ void tiles_of(Tile (&t)[kWarpgroups], int tiles, int batch,
                                         int rows) {
#pragma unroll
  for (int i = 0; i < kWarpgroups; ++i) {
    t[i] = tile_of(blockIdx.x * kWarpgroups + i, tiles, batch, rows);
  }
}

// acc (kN / 2 registers a thread) = A_w B over `steps` 64-deep steps of K,
// A_w the M tile of this thread's warpgroup w.  A stage holds the
// kWarpgroups A tiles (stage + w kATile) and the shared B tile (stage +
// kATiles).  load.tma(s, stage, bar), called by thread 0, starts step s's
// TMA copies on mbarrier `bar`; load.stores(s, stage), called by every
// thread, stores what the TMA does not copy.  Step s + kStages - 1 is
// loaded while step s multiplies.  On return the ring is free.
template <int kN, class Load>
__device__ __forceinline__ void gemm(float (&acc)[kN / 2], unsigned char* ring, int steps,
                                     const Load& load) {
  constexpr int kStage = stage_bytes(kN);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % kStages) * kStage;
    if (threadIdx.x == 0) load.tma(s, st, full + s % kStages);
    load.stores(s, st);
  };
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
  for (int p = 0; p < kStages - 1 && p < steps; ++p) issue(p);
  for (int s = 0; s < steps; ++s) {
    mbar_wait(full + s % kStages, (s / kStages) & 1);  // step s's copies have landed
    fence_async_smem();  // this thread's stores of step s, for wgmma
    __syncthreads();     // ... every thread's; step s - 1's products are done
    if (s + kStages - 1 < steps) issue(s + kStages - 1);  // into step s - 1's slot
    const unsigned char* st = ring + (s % kStages) * kStage;
    const uint64_t da = desc(st + wg * kATile), db = desc(st + kATiles);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_bf16<kN>(acc, da + 2 * k, db + 2 * k, (s | k) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  __syncthreads();
}

// The forward GEMM of K3 and of launch (a): each warpgroup's frames
// against bin group g.  With hop % 8 == 0 (every MSS size) the TMA copies
// the A tiles from the frame map (k, t, b), whose t stride is hop samples:
// frames overlap, and samples past n_fft and frames past n_frames are
// zeros.  Otherwise frame rows are not 16-byte aligned, and every thread
// loads its 16-byte chunk of each A tile element by element and stores it.
struct SpectrumLoad {
  const void* frames;  // tensor map of xq as frames (hop % 8 == 0)
  const void* wt;      // tensor map of Wt (2 bins_pad, ldk), box 128 x 64
  const bf16* x;       // xq (B, row_len), for the element loads
  Tile tiles[kWarpgroups];
  size_t row_len;
  int g, n_fft, hop;
  __device__ __forceinline__ bool by_tma() const { return (hop & 7) == 0; }
  __device__ __forceinline__ void tma(int s, unsigned char* st, uint64_t* bar) const {
    mbar_expect_tx(bar, (by_tma() ? kATiles : 0) + kGroupN * kK * 2);
    if (by_tma()) {
#pragma unroll
      for (int i = 0; i < kWarpgroups; ++i) {
        tma_load_3d(st + i * kATile, frames, bar, s * kK, tiles[i].row0, tiles[i].b);
      }
    }
    tma_load_2d(st + kATiles, wt, bar, s * kK, g * kGroupN);
  }
  __device__ __forceinline__ void stores(int s, unsigned char* st) const {
    if (by_tma()) return;
    const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7, k = s * kK + 8 * c8;
#pragma unroll
    for (int i = 0; i < kWarpgroups; ++i) {
      const Tile& tl = tiles[i];
      const bool row = r < tl.valid;
      const bf16* src = x + (row ? tl.b * row_len + static_cast<size_t>(tl.row0 + r) * hop + k : 0);
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k0 = k + 2 * e;
        const uint32_t lo = row && k0 < n_fft ? __bfloat16_as_ushort(src[2 * e]) : 0u;
        const uint32_t hi = row && k0 + 1 < n_fft ? __bfloat16_as_ushort(src[2 * e + 1]) : 0u;
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(st + i * kATile + swz_chunk(r, c8)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
};

__device__ __forceinline__ SpectrumLoad spectrum_load(const CUtensorMap& frames,
                                                      const CUtensorMap& wt, const bf16* xq,
                                                      int batch, int row_len, int n_fft, int hop,
                                                      int n_frames, int tiles) {
  SpectrumLoad ld;
  ld.frames = &frames;
  ld.wt = &wt;
  ld.x = xq;
  tiles_of(ld.tiles, tiles, batch, n_frames);
  ld.row_len = row_len;
  ld.g = blockIdx.y;
  ld.n_fft = n_fft;
  ld.hop = hop;
  return ld;
}

__global__ void __launch_bounds__(kThreads, 1)
stft_power_fwd_kernel(const __grid_constant__ CUtensorMap frames,
                      const __grid_constant__ CUtensorMap wt,
                      const bf16* __restrict__ xq,  // (B, row_len)
                      float* __restrict__ out,      // (B, T, bins)
                      int batch, int row_len, int n_fft, int hop, int n_frames, int bins,
                      int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int g = blockIdx.y, wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  float acc[kGroupN / 2];
  gemm<kGroupN>(acc, ring, (n_fft + kK - 1) / kK,
                spectrum_load(frames, wt, xq, batch, row_len, n_fft, hop, n_frames, tiles));

  // |S|^2 through this warpgroup's staging tile, stored coalesced
  float* stage = reinterpret_cast<float*>(ring) + wg * kM * kLdF;
#pragma unroll
  for (int v = 0; v < kGroup / 2; ++v) {
    const float re = acc[v], im = acc[v + kGroup / 2];
    stage[frag_row(t, v) * kLdF + frag_col(t, v)] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
  __syncthreads();
  const Tile me = tile_of(blockIdx.x * kWarpgroups + wg, tiles, batch, n_frames);
  const int nb = min(kGroup, bins - g * kGroup);
  float* o = out + (static_cast<size_t>(me.b) * n_frames + me.row0) * bins + g * kGroup;
  for (int idx = t; idx < me.valid * nb; idx += 128) {
    const int r = idx / nb, c = idx - r * nb;
    o[static_cast<size_t>(r) * bins + c] = stage[r * kLdF + c];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stft_power_recompute_kernel(const __grid_constant__ CUtensorMap frames,
                            const __grid_constant__ CUtensorMap wt,
                            const bf16* __restrict__ xq,     // (B, row_len)
                            const float* __restrict__ dmag,  // (B, T, bins)
                            bf16* __restrict__ d,            // (B, T, 2 bins_pad)
                            int batch, int row_len, int n_fft, int hop, int n_frames, int bins,
                            int bins_pad, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int g = blockIdx.y, wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  float acc[kGroupN / 2];
  gemm<kGroupN>(acc, ring, (n_fft + kK - 1) / kK,
                spectrum_load(frames, wt, xq, batch, row_len, n_fft, hop, n_frames, tiles));

  // dm = bf16(dmag) of this warpgroup's tile (zeros outside, so padded bins
  // give zero D), then dre | dim staged as bf16 and stored 16 bytes a thread
  constexpr int kDmBytes = kM * kLdF * sizeof(float);
  unsigned char* mine = ring + wg * (kDmBytes + kM * kLdD * sizeof(bf16));
  float* dm_s = reinterpret_cast<float*>(mine);          // kM x kLdF
  bf16* d_s = reinterpret_cast<bf16*>(mine + kDmBytes);  // kM x kLdD
  const Tile me = tile_of(blockIdx.x * kWarpgroups + wg, tiles, batch, n_frames);
  const int nb = min(kGroup, bins - g * kGroup);
  const float* dm_g = dmag + (static_cast<size_t>(me.b) * n_frames + me.row0) * bins + g * kGroup;
  for (int idx = t; idx < kM * kGroup; idx += 128) {
    const int r = idx >> 6, c = idx & 63;
    const float v = (r < me.valid && c < nb) ? dm_g[static_cast<size_t>(r) * bins + c] : 0.0f;
    dm_s[r * kLdF + c] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kGroup / 2; ++v) {
    const int r = frag_row(t, v), c = frag_col(t, v);
    const float dm = dm_s[r * kLdF + c];
    d_s[r * kLdD + c] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(2.0f, acc[v]), dm));
    d_s[r * kLdD + kGroup + c] =
        __float2bfloat16_rn(__fmul_rn(__fmul_rn(2.0f, acc[v + kGroup / 2]), dm));
  }
  __syncthreads();
  const size_t ldd = 2 * static_cast<size_t>(bins_pad);
  bf16* d_g = d + (static_cast<size_t>(me.b) * n_frames + me.row0) * ldd + g * kGroupN;
  for (int idx = t; idx < me.valid * (kGroupN / 8); idx += 128) {
    const int r = idx >> 4, q = idx & 15;
    *reinterpret_cast<uint4*>(d_g + r * ldd + 8 * q) =
        *reinterpret_cast<const uint4*>(d_s + r * kLdD + 8 * q);
  }
}

// Launch (b)'s loads, step s = (shift i, K columns k0 ...): the A tile of
// output blocks r is D[b, r - i] from the map of D (k, frame, b), zeros
// outside the frames; the B tile is Wcat rows i*hop + j0 ... (the rows
// past the hop, another shift's or zeros, meet columns that are not
// stored).
template <int kN>
struct ShiftLoad {
  const void* d;     // tensor map of D (2 bins_pad, T, B), box 1 x 64 x 64
  const void* wcat;  // tensor map of Wcat (n_fft, 2 bins_pad), box kN x 64
  Tile tiles[kWarpgroups];
  int chunks, hop, j0;
  __device__ __forceinline__ void tma(int s, unsigned char* st, uint64_t* bar) const {
    const int i = s / chunks, k0 = (s - i * chunks) * kK;
    mbar_expect_tx(bar, kATiles + kN * kK * 2);
#pragma unroll
    for (int w = 0; w < kWarpgroups; ++w) {
      tma_load_3d(st + w * kATile, d, bar, k0, tiles[w].row0 - i, tiles[w].b);
    }
    tma_load_2d(st + kATiles, wcat, bar, k0, i * hop + j0);
  }
  __device__ __forceinline__ void stores(int, unsigned char*) const {}
};

template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
stft_power_shifted_kernel(const __grid_constant__ CUtensorMap d,
                          const __grid_constant__ CUtensorMap wcat,
                          float* __restrict__ dxb,  // (B, n_blocks, hop)
                          int batch, int n_blocks, int hop, int kb, int bins_pad, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  ShiftLoad<kN> ld;
  ld.d = &d;
  ld.wcat = &wcat;
  tiles_of(ld.tiles, tiles, batch, n_blocks);
  ld.chunks = 2 * bins_pad / kK;
  ld.hop = hop;
  ld.j0 = blockIdx.y * kN;
  float acc[kN / 2];
  gemm<kN>(acc, ring, kb * ld.chunks, ld);

  constexpr int kLdO = kN + 4;
  float* stage = reinterpret_cast<float*>(ring) + wg * kM * kLdO;
#pragma unroll
  for (int v = 0; v < kN / 2; ++v) stage[frag_row(t, v) * kLdO + frag_col(t, v)] = acc[v];
  __syncthreads();
  const Tile me = tile_of(blockIdx.x * kWarpgroups + wg, tiles, batch, n_blocks);
  const int nj = min(kN, hop - ld.j0);
  float* o = dxb + (static_cast<size_t>(me.b) * n_blocks + me.row0) * hop + ld.j0;
  for (int idx = t; idx < me.valid * nj; idx += 128) {
    const int r = idx / nj, c = idx - r * nj;
    o[static_cast<size_t>(r) * hop + c] = stage[r * kLdO + c];
  }
}

// ------------------------------------------------------------------ host

constexpr int kEncodeError = 10000;  // + the CUresult of a refused tensor map

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map with the 128-byte swizzle (the tiles' layout) and zero
// fill: dims innermost first, strides in bytes of dims 1 .., box in
// elements.  Returns 0, a cudaError_t, or kEncodeError + a CUresult.
int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// The spectrum GEMM's maps: xq as frames (k < n_fft, t < n_frames, b) with
// frame stride hop (zeroed where hop % 8 != 0: the kernel stores A
// itself), and Wt (ldk, 2 bins_pad).
int spectrum_maps(CUtensorMap* frames, CUtensorMap* wt, const bf16* xq, const bf16* wt_ptr,
                  int b, int row_len, int hop, int n_fft, int n_frames, int ldk, int bins_pad) {
  *frames = CUtensorMap{};
  if (hop % 8 == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n_fft), static_cast<cuuint64_t>(n_frames),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[2] = {2ull * hop, 2ull * row_len};
    const cuuint32_t box[3] = {kK, kM, 1};
    const int err = encode(frames, xq, 3, dims, strides, box);
    if (err != 0) return err;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldk), 2ull * bins_pad};
  const cuuint64_t strides[1] = {2ull * ldk};
  const cuuint32_t box[2] = {kK, kGroupN};
  return encode(wt, wt_ptr, 2, dims, strides, box);
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int ctas(int b, int tiles) { return (b * tiles + kWarpgroups - 1) / kWarpgroups; }
int bins_pad_of(int n_fft) { return (n_fft / 2 + 1 + kGroup - 1) / kGroup * kGroup; }
int ldk_of(int n_fft) { return (n_fft + 7) / 8 * 8; }

template <int kN>
int launch_shifted(const bf16* d, const bf16* wcat, float* dxb, int b, int n_blocks, int hop,
                   int n_fft, int n_frames, cudaStream_t stream) {
  const int bins_pad = bins_pad_of(n_fft);
  CUtensorMap d_map, w_map;
  const cuuint64_t d_dims[3] = {2ull * bins_pad, static_cast<cuuint64_t>(n_frames),
                                static_cast<cuuint64_t>(b)};
  const cuuint64_t d_strides[2] = {4ull * bins_pad, 4ull * bins_pad * n_frames};
  const cuuint32_t d_box[3] = {kK, kM, 1};
  int err = encode(&d_map, d, 3, d_dims, d_strides, d_box);
  if (err != 0) return err;
  const cuuint64_t w_dims[2] = {2ull * bins_pad, static_cast<cuuint64_t>(n_fft)};
  const cuuint64_t w_strides[1] = {4ull * bins_pad};
  const cuuint32_t w_box[2] = {kK, kN};
  err = encode(&w_map, wcat, 2, w_dims, w_strides, w_box);
  if (err != 0) return err;
  auto kernel = stft_power_shifted_kernel<kN>;
  const size_t smem = smem_bytes(kN);
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n_blocks + kM - 1) / kM;
  const dim3 grid(ctas(b, tiles), (hop + kN - 1) / kN);
  kernel<<<grid, kThreads, smem, stream>>>(d_map, w_map, dxb, b, n_blocks, hop, n_fft / hop,
                                           bins_pad, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns 0, a cudaError_t, or
// 10000 + the CUresult of a tensor map the driver refused.  The caller has
// checked: hop divides n_fft, n_fft <= 4096, n_frames >= 1, (n_frames - 1)
// * hop + n_fft <= n_blocks * hop, b * ceil(max(n_frames, n_blocks) / 64)
// < 2^31; the operands are contiguous, xq, wt, wcat and d 16-byte aligned
// (torch allocations), wt and wcat the wrapper's cached layouts for n_fft.

extern "C" int stft_power_fwd(const bf16* xq, const bf16* wt, float* out, int b, int n_blocks,
                              int hop, int n_fft, int n_frames, void* stream) {
  if (b == 0) return 0;
  const int bins = n_fft / 2 + 1, bins_pad = bins_pad_of(n_fft), row_len = n_blocks * hop;
  CUtensorMap frames, wt_map;
  int err = spectrum_maps(&frames, &wt_map, xq, wt, b, row_len, hop, n_fft, n_frames,
                          ldk_of(n_fft), bins_pad);
  if (err != 0) return err;
  const size_t smem = smem_bytes(kGroupN);
  const cudaError_t e = set_smem(stft_power_fwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n_frames + kM - 1) / kM;
  const dim3 grid(ctas(b, tiles), bins_pad / kGroup);
  stft_power_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, wt_map, xq, out, b, row_len, n_fft, hop, n_frames, bins, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stft_power_bwd_recompute(const bf16* xq, const float* dmag, const bf16* wt,
                                        bf16* d, int b, int n_blocks, int hop, int n_fft,
                                        int n_frames, void* stream) {
  if (b == 0) return 0;
  const int bins = n_fft / 2 + 1, bins_pad = bins_pad_of(n_fft), row_len = n_blocks * hop;
  CUtensorMap frames, wt_map;
  int err = spectrum_maps(&frames, &wt_map, xq, wt, b, row_len, hop, n_fft, n_frames,
                          ldk_of(n_fft), bins_pad);
  if (err != 0) return err;
  const size_t smem = smem_bytes(kGroupN);
  const cudaError_t e = set_smem(stft_power_recompute_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n_frames + kM - 1) / kM;
  const dim3 grid(ctas(b, tiles), bins_pad / kGroup);
  stft_power_recompute_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, wt_map, xq, dmag, d, b, row_len, n_fft, hop, n_frames, bins, bins_pad, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stft_power_bwd_shifted(const bf16* d, const bf16* wcat, float* dxb, int b,
                                      int n_blocks, int hop, int n_fft, int n_frames,
                                      void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hop <= 16) return launch_shifted<16>(d, wcat, dxb, b, n_blocks, hop, n_fft, n_frames, s);
  if (hop <= 32) return launch_shifted<32>(d, wcat, dxb, b, n_blocks, hop, n_fft, n_frames, s);
  return launch_shifted<kMaxShiftN>(d, wcat, dxb, b, n_blocks, hop, n_fft, n_frames, s);
}
