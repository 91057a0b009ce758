// ct_conv: circular convolution of complex rows with one shared spectrum on
// the permuted Cooley-Tukey transform, bf16 operands and float32 sums.
//
// Replaces scripts/ab_ct_conv_kernel.py:_kernel (S1), the fused per-row
// pipeline of ddsp_tpu/ops/fft.py:_rfft_convolve_large_shared at
// matmul_dtype=bfloat16: the core of the reverb's bf16 backward (its
// d/dsignal correlation, 16 complex rows of (n1, n2) = (384, 256) at the
// training shape).  Each row A (n1, n2) = z.reshape(n1, n2), with the DFT
// matrices D1 (n1 x n1), D2 (n2 x n2), both symmetric, the twiddle
// T[k1, b] = W_n^{k1 b} and the shared permuted spectrum K (n1, n2):
//
//   C = bf16((D1 A) . T)                        stage 1  (ct_stage_kernel<false>)
//   W = bf16((C D2) . K)                        stage 2a \
//   R = bf16((W conj(D2)) . conj(T))            stage 2b /  (ct_middle_kernel)
//   y = (conj(D1) R) / (n1 n2)                  stage 3  (ct_stage_kernel<true>)
//
// with every matrix product's operands in bf16 (z rounded on load, D1 and
// D2 bf16 tables) and its sums in float32, the twiddles and the spectrum
// product in float32, and the output float32: the cast points of
// _kernel (:55-84) and of the plain version (ops/fft.py:ct_conv_permuted).
//
// What bounds it on an H100: each stage is 4 real products of 2 n1 n2 n1
// or 2 n1 n2 n2 flops, 8 n (n1 + n2) a transform and 16 n (n1 + n2) flops
// a row (the TPU kernel's CostEstimate, :111-112, counts half of that).
// At 16 rows of (384, 256) that is 16.1 GFLOP, 0.0163 ms at the 989
// TFLOP/s bf16 dense peak, against ~26 MB of inputs and outputs (0.0078
// ms at 3.35 TB/s): the tensor cores bound it.
//
// The design, right before fast.  S1 holds a whole row and both DFT
// matrices in VMEM; on the H100 a block has at most 227 KB of shared
// memory, and one row at (384, 256) is 384 KB as complex bf16, D1 576 KB.
// So the pipeline runs in three launches, its intermediates in bf16 in
// device memory (6.3 MB for 16 rows, resident in the 50 MB L2):
//
// * stages 1 and 3 (ct_stage_kernel): one block of 4 warps per (row, 64
//   output rows, 64 columns) walks the contraction in chunks of 32,
//   staging the D1 tile and the row tile (rounded to bf16 on load) in
//   shared memory; each warp keeps 4 + 4 wmma 16x16x16 bf16 accumulators
//   for the real and imaginary parts (the imaginary table's sign is flipped
//   in the fragment where the complex product subtracts).  The epilogue
//   stages the sums in shared memory and applies the twiddle and the bf16
//   cast (stage 1) or the 1/n scale (stage 3), masked at ragged edges.
// * stage 2 (ct_middle_kernel), the part S1 really fuses: one block of 8
//   warps per (row, 32 rows of k1) holds its C rows (32 x n2, bf16) in
//   shared memory and walks k2 in chunks of 32.  For each chunk it stages
//   D2[:, chunk] once (D2 is symmetric, so the same tile is the chunk's
//   rows of conj(D2) when read column-major), forms P[:, chunk] = C D2 (4
//   warps the real part, 4 the imaginary), multiplies by K into W (bf16,
//   shared memory), and adds W conj(D2)[chunk, :] into Q, whose n2 columns
//   stay in wmma accumulators across chunks.  Its epilogue applies the
//   conjugate twiddle and writes R over its own rows of C.
//
// Accuracy: bf16 products are exact in float32, but Hopper's mma adds
// them into its float32 accumulator with truncation, relative to the
// running sum; chained over a whole 384-deep contraction that error moves
// about one bf16 rounding of the intermediates in a thousand (a kernel
// that chains them measured 67.85 dB against the plain version at the
// training shape on an H100).  So each tensor-core
// sum runs at most 4 mma (64 products) deep from zero and is then added
// into a float32 accumulator with a round-to-nearest add: float32-grade
// sums, like the plain version's.  Every sum runs in a fixed order with
// no atomics, so reruns are bit-equal.  n1 and n2 must be multiples of 32 (every n > 4096 of the
// 2^k and 3 * 2^k families splits so) and n2 <= 512.
//
// Left for later: wgmma with TMA-fed tiles, a pipelined contraction,
// larger tiles, and the three stages in one cluster launch with a row
// held in distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// stages 1 and 3
constexpr int kStageThreads = 128;  // 4 warps, 16 output rows each
constexpr int kSM = 64;             // output rows per block
constexpr int kSN = 64;             // columns per block
constexpr int kKC = 32;             // contraction chunk
constexpr int kLdD = kKC + 8;       // bf16 row strides: multiples of 8
constexpr int kLdX = kSN + 8;
constexpr int kLdO = kSN + 4;       // float staging: a multiple of 4
constexpr int kStageOperandBytes = 2 * (kSM * kLdD + kKC * kLdX) * 2;
constexpr int kStageStagingBytes = 2 * kSM * kLdO * 4;
constexpr int kStageSmem =
    kStageOperandBytes > kStageStagingBytes ? kStageOperandBytes : kStageStagingBytes;

// stage 2
constexpr int kMidThreads = 256;  // 8 warps
constexpr int kMidWarps = kMidThreads / 32;
constexpr int kTM = 32;           // k1 rows per block
constexpr int kLdP = kKC + 4;     // P staging (float)
constexpr int kLdW = kKC + 8;     // W tile and D2 chunk (bf16)
constexpr int kMaxN2 = 512;

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.0f); }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// Flip the sign of every element of a bf16 operand fragment (exact).
template <typename Frag>
__device__ __forceinline__ void negate(Frag& f) {
  static_assert(sizeof(f.x[0]) == 2, "bf16 fragment elements");
#pragma unroll
  for (int e = 0; e < f.num_elements; ++e) {
    unsigned short bits = *reinterpret_cast<unsigned short*>(&f.x[e]);
    bits ^= 0x8000u;
    *reinterpret_cast<unsigned short*>(&f.x[e]) = bits;
  }
}

// acc += part, elementwise, round to nearest (fragments of one type share
// one layout).
__device__ __forceinline__ void add_into(FragC& acc, const FragC& part) {
#pragma unroll
  for (int e = 0; e < acc.num_elements; ++e) acc.x[e] = __fadd_rn(acc.x[e], part.x[e]);
}

// Stage 1 (kInverse false): out = (D1 X) . T -> bf16 C.
// Stage 3 (kInverse true):  out = conj(D1) X / (n1 n2) -> float y.
// X, out: (rows, n1, n2); D1: (n1, n1); T: (n1, n2).
template <bool kInverse, typename TIn, typename TOut>
__global__ void __launch_bounds__(kStageThreads)
ct_stage_kernel(const TIn* __restrict__ xr, const TIn* __restrict__ xi,
                const bf16* __restrict__ d1r, const bf16* __restrict__ d1i,
                const float* __restrict__ tr, const float* __restrict__ ti,
                TOut* __restrict__ outr, TOut* __restrict__ outi,
                int n1, int n2, float scale) {
  __shared__ __align__(128) unsigned char smem[kStageSmem];
  bf16* dr_s = reinterpret_cast<bf16*>(smem);           // (kSM, kLdD)
  bf16* di_s = dr_s + kSM * kLdD;
  bf16* xr_s = di_s + kSM * kLdD;                        // (kKC, kLdX)
  bf16* xi_s = xr_s + kKC * kLdX;
  float* or_s = reinterpret_cast<float*>(smem);          // epilogue: (kSM, kLdO)
  float* oi_s = or_s + kSM * kLdO;

  const int n0 = blockIdx.x * kSN;
  const int m0 = blockIdx.y * kSM;
  const size_t row = blockIdx.z;
  const size_t plane = static_cast<size_t>(n1) * n2;
  const TIn* xr_row = xr + row * plane;
  const TIn* xi_row = xi + row * plane;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  FragC accr[kSN / 16], acci[kSN / 16];
#pragma unroll
  for (int j = 0; j < kSN / 16; ++j) {
    wmma::fill_fragment(accr[j], 0.0f);
    wmma::fill_fragment(acci[j], 0.0f);
  }

  for (int k0 = 0; k0 < n1; k0 += kKC) {
    for (int i = tid; i < kSM * kKC; i += kStageThreads) {
      const int r = i / kKC, c = i % kKC;
      const int m = m0 + r;
      const size_t d = static_cast<size_t>(m) * n1 + k0 + c;
      dr_s[r * kLdD + c] = m < n1 ? d1r[d] : bf16_zero();
      di_s[r * kLdD + c] = m < n1 ? d1i[d] : bf16_zero();
    }
    for (int i = tid; i < kKC * kSN; i += kStageThreads) {
      const int r = i / kSN, c = i % kSN;
      const int col = n0 + c;
      const size_t x = static_cast<size_t>(k0 + r) * n2 + col;
      xr_s[r * kLdX + c] = col < n2 ? to_bf16(xr_row[x]) : bf16_zero();
      xi_s[r * kLdX + c] = col < n2 ? to_bf16(xi_row[x]) : bf16_zero();
    }
    __syncthreads();
    FragC partr[kSN / 16], parti[kSN / 16];  // this chunk's 4-mma sums
#pragma unroll
    for (int j = 0; j < kSN / 16; ++j) {
      wmma::fill_fragment(partr[j], 0.0f);
      wmma::fill_fragment(parti[j], 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      FragA fdr, fdi, fndi;
      wmma::load_matrix_sync(fdr, dr_s + warp * 16 * kLdD + kk, kLdD);
      wmma::load_matrix_sync(fdi, di_s + warp * 16 * kLdD + kk, kLdD);
      fndi = fdi;
      negate(fndi);
#pragma unroll
      for (int j = 0; j < kSN / 16; ++j) {
        FragB fxr, fxi;
        wmma::load_matrix_sync(fxr, xr_s + kk * kLdX + j * 16, kLdX);
        wmma::load_matrix_sync(fxi, xi_s + kk * kLdX + j * 16, kLdX);
        // forward: (dr + i di)(xr + i xi); inverse: (dr - i di)(xr + i xi)
        wmma::mma_sync(partr[j], fdr, fxr, partr[j]);
        wmma::mma_sync(partr[j], kInverse ? fdi : fndi, fxi, partr[j]);
        wmma::mma_sync(parti[j], fdr, fxi, parti[j]);
        wmma::mma_sync(parti[j], kInverse ? fndi : fdi, fxr, parti[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSN / 16; ++j) {
      add_into(accr[j], partr[j]);
      add_into(acci[j], parti[j]);
    }
    __syncthreads();  // the next chunk (or the staging) overwrites the tiles
  }

#pragma unroll
  for (int j = 0; j < kSN / 16; ++j) {
    wmma::store_matrix_sync(or_s + warp * 16 * kLdO + j * 16, accr[j], kLdO,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(oi_s + warp * 16 * kLdO + j * 16, acci[j], kLdO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < kSM * kSN; i += kStageThreads) {
    const int r = i / kSN, c = i % kSN;
    const int m = m0 + r, col = n0 + c;
    if (m >= n1 || col >= n2) continue;
    const float br = or_s[r * kLdO + c], bi = oi_s[r * kLdO + c];
    const size_t e = static_cast<size_t>(m) * n2 + col;
    if constexpr (kInverse) {
      outr[row * plane + e] = br * scale;
      outi[row * plane + e] = bi * scale;
    } else {
      const float wr = tr[e], wi = ti[e];
      outr[row * plane + e] = to_bf16(br * wr - bi * wi);
      outi[row * plane + e] = to_bf16(br * wi + bi * wr);
    }
  }
}

// Stage 2 for one (row, kTM rows of k1): reads C (bf16) and writes R (bf16)
// over the same rows.  kQT = the most Q tiles (16 x 16, complex) a warp
// keeps: 2 (n2 / 16) tiles over 8 warps.
template <int kQT>
__global__ void __launch_bounds__(kMidThreads)
ct_middle_kernel(bf16* __restrict__ cr, bf16* __restrict__ ci,
                 const float* __restrict__ kr, const float* __restrict__ ki,
                 const bf16* __restrict__ d2r, const bf16* __restrict__ d2i,
                 const float* __restrict__ tr, const float* __restrict__ ti,
                 int n1, int n2) {
  extern __shared__ __align__(128) unsigned char mid_smem[];
  const int ldc = n2 + 8;
  bf16* c_r = reinterpret_cast<bf16*>(mid_smem);  // (kTM, ldc): this block's C rows
  bf16* c_i = c_r + kTM * ldc;
  bf16* d_r = c_i + kTM * ldc;                // (n2, kLdW): D2[:, chunk]
  bf16* d_i = d_r + n2 * kLdW;
  float* p_s = reinterpret_cast<float*>(d_i + n2 * kLdW);  // (2, kTM, kLdP)
  bf16* w_r = reinterpret_cast<bf16*>(p_s + 2 * kTM * kLdP);  // (kTM, kLdW)
  bf16* w_i = w_r + kTM * kLdW;
  float* stage = reinterpret_cast<float*>(w_i + kTM * kLdW);  // 8 warps x 2 x 256

  const int m0 = blockIdx.x * kTM;
  const size_t row = blockIdx.y;
  const size_t base = (row * n1 + m0) * static_cast<size_t>(n2);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col_tiles = n2 / 16;
  const int q_tiles = (kTM / 16) * col_tiles;

  // this block's C rows, 8 bf16 (16 bytes) at a time
  const int vec_per_row = n2 / 8;
  for (int i = tid; i < kTM * vec_per_row; i += kMidThreads) {
    const int r = i / vec_per_row, v = i % vec_per_row;
    const size_t g = base + static_cast<size_t>(r) * n2 + v * 8;
    *reinterpret_cast<uint4*>(c_r + r * ldc + v * 8) = *reinterpret_cast<const uint4*>(cr + g);
    *reinterpret_cast<uint4*>(c_i + r * ldc + v * 8) = *reinterpret_cast<const uint4*>(ci + g);
  }

  FragC qr[kQT], qi[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) {
    wmma::fill_fragment(qr[q], 0.0f);
    wmma::fill_fragment(qi[q], 0.0f);
  }
  // P phase: warp -> (16 x 16 tile of the kTM x kKC chunk, real or imaginary)
  const int p_tile = warp & 3, p_imag = warp >> 2;
  const int p_rt = p_tile >> 1, p_ct = p_tile & 1;

  for (int k0 = 0; k0 < n2; k0 += kKC) {
    __syncthreads();  // the previous chunk's D2 and W tiles are read
    for (int i = tid; i < n2 * (kKC / 8); i += kMidThreads) {
      const int b = i / (kKC / 8), v = i % (kKC / 8);
      const size_t g = static_cast<size_t>(b) * n2 + k0 + v * 8;
      *reinterpret_cast<uint4*>(d_r + b * kLdW + v * 8) = *reinterpret_cast<const uint4*>(d2r + g);
      *reinterpret_cast<uint4*>(d_i + b * kLdW + v * 8) = *reinterpret_cast<const uint4*>(d2i + g);
    }
    __syncthreads();

    // P[:, chunk] = C D2[:, chunk]: pr = cr d2r - ci d2i, pi = cr d2i + ci d2r
    FragC p;
    wmma::fill_fragment(p, 0.0f);
    for (int kb = 0; kb < n2; kb += 32) {
      FragC part;  // 4-mma sums
      wmma::fill_fragment(part, 0.0f);
#pragma unroll
      for (int kk = kb; kk < kb + 32; kk += 16) {
        FragA fcr, fci;
        FragB fdr, fdi;
        wmma::load_matrix_sync(fcr, c_r + p_rt * 16 * ldc + kk, ldc);
        wmma::load_matrix_sync(fci, c_i + p_rt * 16 * ldc + kk, ldc);
        wmma::load_matrix_sync(fdr, d_r + kk * kLdW + p_ct * 16, kLdW);
        wmma::load_matrix_sync(fdi, d_i + kk * kLdW + p_ct * 16, kLdW);
        if (p_imag) {  // warp-uniform
          wmma::mma_sync(part, fcr, fdi, part);
          wmma::mma_sync(part, fci, fdr, part);
        } else {
          negate(fci);
          wmma::mma_sync(part, fcr, fdr, part);
          wmma::mma_sync(part, fci, fdi, part);
        }
      }
      add_into(p, part);
    }
    wmma::store_matrix_sync(p_s + p_imag * kTM * kLdP + p_rt * 16 * kLdP + p_ct * 16, p,
                            kLdP, wmma::mem_row_major);
    __syncthreads();

    // W = bf16(P . K), float32 product
    for (int i = tid; i < kTM * kKC; i += kMidThreads) {
      const int r = i / kKC, c = i % kKC;
      const size_t e = static_cast<size_t>(m0 + r) * n2 + k0 + c;
      const float pr = p_s[r * kLdP + c], pi = p_s[kTM * kLdP + r * kLdP + c];
      const float sr = kr[e], si = ki[e];
      w_r[r * kLdW + c] = to_bf16(pr * sr - pi * si);
      w_i[r * kLdW + c] = to_bf16(pr * si + pi * sr);
    }
    __syncthreads();

    // Q += W conj(D2)[chunk, :]: qr += wr d2r + wi d2i, qi += wi d2r - wr d2i;
    // conj(D2)[k2, b] = conj(D2[b, k2]), the staged tile read column-major
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      const int t = warp + kMidWarps * q;
      if (t < q_tiles) {  // warp-uniform
        const int rt = t / col_tiles, ct = t % col_tiles;
        FragC partr, parti;  // this chunk's 4-mma sums
        wmma::fill_fragment(partr, 0.0f);
        wmma::fill_fragment(parti, 0.0f);
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          FragA fwr, fwi, fnwr;
          FragBt fdr, fdi;
          wmma::load_matrix_sync(fwr, w_r + rt * 16 * kLdW + kk, kLdW);
          wmma::load_matrix_sync(fwi, w_i + rt * 16 * kLdW + kk, kLdW);
          fnwr = fwr;
          negate(fnwr);
          wmma::load_matrix_sync(fdr, d_r + ct * 16 * kLdW + kk, kLdW);
          wmma::load_matrix_sync(fdi, d_i + ct * 16 * kLdW + kk, kLdW);
          wmma::mma_sync(partr, fwr, fdr, partr);
          wmma::mma_sync(partr, fwi, fdi, partr);
          wmma::mma_sync(parti, fwi, fdr, parti);
          wmma::mma_sync(parti, fnwr, fdi, parti);
        }
        add_into(qr[q], partr);
        add_into(qi[q], parti);
      }
    }
  }

  // R = bf16(Q . conj(T)) over this block's rows of C; every read of C in
  // device memory happened before the first __syncthreads() above
  float* sr_w = stage + warp * 512;
  float* si_w = sr_w + 256;
#pragma unroll
  for (int q = 0; q < kQT; ++q) {
    const int t = warp + kMidWarps * q;
    if (t < q_tiles) {
      const int rt = t / col_tiles, ct = t % col_tiles;
      const size_t e0 = static_cast<size_t>(m0 + rt * 16) * n2 + ct * 16;
      FragC ftr, fti;
      wmma::load_matrix_sync(ftr, tr + e0, n2, wmma::mem_row_major);
      wmma::load_matrix_sync(fti, ti + e0, n2, wmma::mem_row_major);
      // the fragments share one layout, so elementwise is safe
      for (int e = 0; e < ftr.num_elements; ++e) {
        const float a = qr[q].x[e], b = qi[q].x[e], c = ftr.x[e], d = fti.x[e];
        ftr.x[e] = a * c + b * d;
        fti.x[e] = b * c - a * d;
      }
      wmma::store_matrix_sync(sr_w, ftr, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(si_w, fti, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const size_t g = base + static_cast<size_t>(rt * 16 + e / 16) * n2 + ct * 16 + e % 16;
        cr[g] = to_bf16(sr_w[e]);
        ci[g] = to_bf16(si_w[e]);
      }
      __syncwarp();
    }
  }
}

size_t middle_smem(int n2) {
  return (2 * kTM * (n2 + 8) + 2 * n2 * kLdW + 2 * kTM * kLdW) * sizeof(bf16)
         + (2 * kTM * kLdP + kMidWarps * 512) * sizeof(float);
}

template <int kQT>
cudaError_t launch_middle(bf16* cr, bf16* ci, const float* kr, const float* ki,
                          const bf16* d2r, const bf16* d2i, const float* tr,
                          const float* ti, int rows, int n1, int n2, cudaStream_t stream) {
  const size_t smem = middle_smem(n2);
  cudaError_t err = cudaFuncSetAttribute(
      ct_middle_kernel<kQT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ct_middle_kernel<kQT><<<dim3(n1 / kTM, rows), kMidThreads, smem, stream>>>(
      cr, ci, kr, ki, d2r, d2i, tr, ti, n1, n2);
  return cudaGetLastError();
}

}  // namespace

// Launches the three stages on `stream` and returns the first CUDA error (0
// on success).  The caller has checked: 1 <= rows <= 65535; n1, n2
// multiples of 32, n2 <= 512, n1 <= 4096 (grid.y of the stages); every
// pointer on one device; zr, zi, yr, yi (rows, n1, n2) float32; kr, ki
// (n1, n2) float32; d1r, d1i (n1, n1) and d2r, d2i (n2, n2) bf16; tr, ti
// (n1, n2) float32; cr, ci (rows, n1, n2) bf16 scratch, all contiguous
// and 16-byte aligned.
extern "C" int ct_conv(const float* zr, const float* zi, const float* kr, const float* ki,
                       const bf16* d1r, const bf16* d1i, const bf16* d2r, const bf16* d2i,
                       const float* tr, const float* ti, bf16* cr, bf16* ci,
                       float* yr, float* yi, int rows, int n1, int n2, void* stream) {
  if (rows == 0) return 0;
  if (n1 % 32 || n2 % 32 || n2 > kMaxN2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n2 + kSN - 1) / kSN, (n1 + kSM - 1) / kSM, rows);
  ct_stage_kernel<false, float, bf16><<<grid, kStageThreads, 0, s>>>(
      zr, zi, d1r, d1i, tr, ti, cr, ci, n1, n2, 1.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = n2 <= 256 ? launch_middle<4>(cr, ci, kr, ki, d2r, d2i, tr, ti, rows, n1, n2, s)
                  : launch_middle<8>(cr, ci, kr, ki, d2r, d2i, tr, ti, rows, n1, n2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ct_stage_kernel<true, bf16, float><<<grid, kStageThreads, 0, s>>>(
      cr, ci, d1r, d1i, tr, ti, yr, yi, n1, n2, 1.0f / (static_cast<float>(n1) * n2));
  return static_cast<int>(cudaGetLastError());
}
