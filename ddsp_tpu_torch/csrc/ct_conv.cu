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
//   C = bf16((D1 A) . T)                        stage 1
//   W = bf16((C D2) . K)                        middle stage, part 1
//   R = bf16((W conj(D2)) . conj(T))            middle stage, part 2
//   y = (conj(D1) R) / (n1 n2)                  stage 3
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
// The design (ct_cluster_kernel, rows with n1 <= 512 and n2 <= 256, the
// reverb's shapes).  S1 holds a row and both DFT matrices in VMEM; an
// H100 block has at most 227 KB of shared memory and a row at (384, 256)
// is 384 KB as complex bf16.  So one launch runs a thread-block cluster of
// ceil(n1 / 64) CTAs per row (6 at the training shape: 16 x 6 = 96 CTAs,
// one wave), and CTA j owns rows 64 j .. 64 j + 63 of a (the signal's
// first index) and of k1 (the spectrum's); C, W and R never leave the
// cluster's shared memory:
//
// * the own A slice is loaded once from device memory, rounded to bf16, in
//   the layout of a wgmma B operand (row b, 64 a deep, 128-byte swizzle);
// * stage 1 contracts over a slice by slice: the own one in place, a
//   peer's copied from its shared memory (distributed shared memory) into
//   a local staging tile, since wgmma reads only the CTA's own shared
//   memory: that copy is the cluster's cost, (n1 - 64) n2 complex values a
//   CTA (320 KB at the training shape), against the A slice's 64 n2 loaded
//   once; C (64 x n2) stays in the CTA;
// * the middle stage is local: P = C D2 in 64-column chunks of k2, W =
//   bf16(P . K) into the buffer A held, then Q = W conj(D2) in 64-column
//   chunks of b and R = bf16(Q . conj(T)) over C.  D2 is symmetric, so
//   every D2 tile, as row-major rows of D2, is the K-major B operand of
//   both products; its 64 x 64 tiles stream from L2;
// * after a cluster barrier stage 3 reads R slice by slice as stage 1 read
//   A, scales by 1/n and stores y (or, in the fused d/dsignal entry,
//   writes dsignal itself, see below); a last barrier keeps every R alive
//   until its peers have read it.
//
// Every product is wgmma m64n64k16 (bf16 in, float32 out) from shared
// memory, both operands K-major with the 128-byte swizzle (the kernel
// writes its tiles swizzled itself).  Warpgroup 0 forms the real part of
// each complex product and warpgroup 1 the imaginary part, each as one
// real product of doubled depth, e.g. Cr = [D1r, -D1i] [Ar; Ai]; the
// minus is a subtraction of the second half's sum, so no negated table is
// staged.  At the end of each 64-column chunk both warpgroups post their
// sums to shared memory and each finishes half of the chunk's elements
// (twiddle or spectrum product, bf16 cast), its float32 operands loaded
// before the exchange; stage 3 stages its output tile and stores it row by
// row.  Each phase runs as steps of one 64-deep block of K into 64 output
// columns, over two slots: while step i multiplies, step i + 1's D tiles
// stream in by cp.async (zero-filled outside the matrix); a peer's tiles
// are read into registers two steps ahead and stored into their slot
// after the products of the step before.
//
// Accuracy: bf16 products are exact in float32, but Hopper's tensor cores
// add them into their float32 accumulator with truncation, relative to the
// running sum; chained over a whole 384-deep contraction that error moves
// about one bf16 rounding of the intermediates in a thousand (a kernel
// that chains them measured 67.85 dB against the plain version at the
// training shape on an H100).  So each tensor-core sum runs 4 k16 steps
// (64 products) from zero and is then added into a float32 accumulator
// with a round-to-nearest add; the two halves of the doubled depth go to
// two such partial sums started back to back (ping-pong), so one wait
// covers both.  Every sum runs in a fixed order with no atomics, so reruns
// are bit-equal.  Ragged tiles (n1 or n2 not a multiple of 64) are masked
// to zeros on load.
//
// The fused d/dsignal entry (ct_conv_dsignal) is the same kernel with
// other load and store functions (DsignalIO): it reads the reverb's
// cotangent g (B, L) directly, with the flip, the overlap-save blocks
// (halo zeros, chunking) and the packing of two real rows a complex row in
// stage 1's index math, and stage 3 writes the valid window of each block,
// flipped, straight into dsignal (B, L).
//
// Rows too large for a cluster's shared memory (n1 > 512 or n2 > 256) take
// the three-launch path (ct_stage_kernel, ct_middle_kernel; wmma
// 16x16x16, intermediates C and R in bf16 in device memory).
//
// Where its time goes (a build that stamped the global timer at each
// phase boundary, not kept): stages 1 and 3, the two that read the peers'
// tiles over distributed shared memory, take most of it, the middle
// stage's two parts most of the rest.  Left for later: peers pushing
// their tiles (cp.async.bulk between CTAs, mbarriers) or a deeper
// register prefetch, 128 columns a step, TMA feeding a ring of D tiles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ cluster

constexpr int kClusterThreads = 256;  // two warpgroups: real, imaginary
constexpr int kTile = 64;             // rows a CTA owns; wgmma M, N and a K atom
constexpr int kTileBytes = kTile * kTile * 2;  // one 64 x 64 bf16 tile: 8 KB
constexpr int kMaxClusterN1 = 8 * kTile;       // 8 CTAs, the portable cluster size
constexpr int kMaxClusterN2 = 4 * kTile;

// The epilogues' float exchange: a half per warpgroup, each a 64 x 68
// staging tile (rows 68 floats apart: at most 2-way bank conflicts for the
// accumulator layout) or 32 x 128 posted sums.
constexpr int kStageLd = kTile + 4;
constexpr int kXfHalf = kTile * kStageLd;

// Shared memory of a CTA, kNB = ceil(n2 / 64): X and Y, 2 planes (real,
// imaginary) of kNB tiles each; 2 slots of D tiles (real, imaginary) and 2
// of a peer's tiles; the float exchange; 1 KB to align the tiles (227 KB
// in all at kNB = 4, the most a block may take).
constexpr size_t cluster_smem(int nb) {
  return static_cast<size_t>(4 * nb + 8) * kTileBytes + 2 * kXfHalf * sizeof(float) + 1024;
}

// acc = (acc + a0 b0) +- a1 b1, each product over 64 of K (4 k16 steps
// from zero into its own partial sum; the two started back to back), added
// in with round-to-nearest: the sign of the second is the complex
// product's, so no negated table is staged.
template <bool kSub>
__device__ __forceinline__ void mma_pair(float (&acc)[32], const unsigned char* a0,
                                         const unsigned char* b0, const unsigned char* a1,
                                         const unsigned char* b1) {
  float p0[32], p1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p0[i] = p1[i] = 0.0f;
  const uint64_t da0 = desc(a0), db0 = desc(b0), da1 = desc(a1), db1 = desc(b1);
  fence_regs(p0);
  fence_regs(p1);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16<64>(p0, da0 + 2 * s, db0 + 2 * s, s);
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16<64>(p1, da1 + 2 * s, db1 + 2 * s, s);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(p0);
  fence_regs(p1);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = __fadd_rn(acc[i], p0[i]);
    acc[i] = kSub ? __fsub_rn(x, p1[i]) : __fadd_rn(x, p1[i]);
  }
}

// Starts the asynchronous copy of D[row0 + r, col0 + k] (r, k < 64) of a
// (nrows, ncols) bf16 pair with row stride ld into two swizzled tiles,
// real then imaginary, zero-filled outside.  ncols and col0 are multiples
// of 8.
__device__ __forceinline__ void load_d_tiles(unsigned char* dt, const bf16* dr, const bf16* di,
                                              int ld, int row0, int nrows, int col0,
                                              int ncols) {
  for (int idx = threadIdx.x; idx < kTile * 8; idx += kClusterThreads) {
    const int r = idx >> 3, c8 = idx & 7;
    const int gr = row0 + r, gc = col0 + 8 * c8;
    const bool in = gr < nrows && gc < ncols;
    const size_t g = in ? static_cast<size_t>(gr) * ld + gc : 0;
    const int off = r * 128 + (((c8 ^ r) & 7) << 4);
    cp_async16(dt + off, dr + g, in ? 16 : 0);
    cp_async16(dt + kTileBytes + off, di + g, in ? 16 : 0);
  }
}

// A peer's tile pair (the same bytes as its swizzled tiles), 4 x 16 bytes
// a thread: read into registers from distributed shared memory while the
// current products run, stored into a local staging slot after.
struct PeerTiles {
  uint4 v[4];
  __device__ __forceinline__ void load(cg::cluster_group& cluster, unsigned char* buf, int plane,
                                       int tile, int rank) {
    const uint4* src_r = cluster.map_shared_rank(
        reinterpret_cast<uint4*>(buf + tile * kTileBytes), rank);
    const uint4* src_i = cluster.map_shared_rank(
        reinterpret_cast<uint4*>(buf + plane + tile * kTileBytes), rank);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[k] = src_r[threadIdx.x + k * kClusterThreads];
      v[2 + k] = src_i[threadIdx.x + k * kClusterThreads];
    }
  }
  __device__ __forceinline__ void store(unsigned char* bt) const {
    uint4* dst = reinterpret_cast<uint4*>(bt);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      dst[threadIdx.x + k * kClusterThreads] = v[k];
      dst[kTileBytes / 16 + threadIdx.x + k * kClusterThreads] = v[2 + k];
    }
  }
};

// ct_conv's rows: z (rows, n) in, y (rows, n) out, real and imaginary apart.
struct RowsIO {
  const float* zr;
  const float* zi;
  float* yr;
  float* yi;
  int n;
  __device__ __forceinline__ float load(int row, int part, int e) const {
    return (part ? zi : zr)[static_cast<size_t>(row) * n + e];
  }
  __device__ __forceinline__ void store(int row, int part, int e, float v) const {
    (part ? yi : yr)[static_cast<size_t>(row) * n + e] = v;
  }
};

// The reverb's d/dsignal: complex row r packs real block rows 2r and
// 2r + 1; block q = (bi, ci) = (q / chunks, q % chunks) reads flip(g[bi])
// at samples ci c + e - lead (zero outside [0, L)) and keeps its outputs
// e in [lead, lead + c), written flipped into dsig[bi].
struct DsignalIO {
  const float* g;
  float* dsig;
  int blocks, chunks, c, lead, length;
  __device__ __forceinline__ float load(int row, int part, int e) const {
    const int q = 2 * row + part;
    if (q >= blocks) return 0.0f;
    const int pos = (q % chunks) * c + e - lead;
    if (pos < 0 || pos >= length) return 0.0f;
    return g[static_cast<size_t>(q / chunks) * length + (length - 1 - pos)];
  }
  __device__ __forceinline__ void store(int row, int part, int e, float v) const {
    const int q = 2 * row + part;
    if (q >= blocks || e < lead || e >= lead + c) return;
    const int pos = (q % chunks) * c + e - lead;
    if (pos >= length) return;
    dsig[static_cast<size_t>(q / chunks) * length + (length - 1 - pos)] = v;
  }
};

enum Phase : int { kStage1 = 0, kMiddle1 = 1, kMiddle2 = 2, kStage3 = 3 };

// The CTA's buffers and coordinates.
struct Cta {
  unsigned char* xb;  // 2 planes: the A slice (B operand), then W (A operand)
  unsigned char* yb;  // 2 planes: C (A operand), then R (B operand)
  unsigned char* dt;  // 2 slots x (real, imaginary) D tiles
  unsigned char* bt;  // 2 slots x (real, imaginary) tiles of a peer
  float* xf;          // 2 x kXfHalf: the epilogues' exchange and staging
  int plane, j, cs, own0, n1, n2, wg, t;
};

// One phase: kNB chunks of 64 output columns, each a sum over `steps`
// 64-deep blocks of K.  Step i + 1's D tiles (cp.async) are fetched into
// the other slot while step i's products run; a chunk's sums go to `epi`
// (called by every thread).
template <int kNB, int kPhase, class Epi>
__device__ __forceinline__ void run_phase(cg::cluster_group& cluster, const Cta& c,
                                          const bf16* dr, const bf16* di, Epi epi) {
  constexpr bool kPeers = kPhase == kStage1 || kPhase == kStage3;
  const int steps = kPeers ? c.cs : kNB;
  const int total = kNB * steps;
  unsigned char* src = kPhase == kStage1 ? c.xb : c.yb;  // peers' B operands
  // Step i's D tiles into `slot` (cp.async, one group).
  auto fetch_d = [&](int i, int slot) {
    const int chunk = i / steps, s = i % steps;
    unsigned char* dt = c.dt + slot * 2 * kTileBytes;
    if (kPeers) {
      load_d_tiles(dt, dr, di, c.n1, c.own0, c.n1, s * kTile, c.n1);
    } else {
      load_d_tiles(dt, dr, di, c.n2, chunk * kTile, c.n2, s * kTile, c.n2);
    }
    cp_async_commit();
  };
  // Whether step i multiplies a peer's tiles (read into `peer`).
  auto fetch_peer = [&](int i, PeerTiles& peer) -> bool {
    if (!kPeers || i >= total || i % steps == c.j) return false;
    peer.load(cluster, src, c.plane, i / steps, i % steps);
    return true;
  };
  // Peer tiles run two steps ahead: step i + 1's are stored into its slot
  // after step i's products, and step i + 2's reads start right after, so
  // a whole step covers their latency.
  PeerTiles peer;
  fetch_d(0, 0);
  if (fetch_peer(0, peer)) peer.store(c.bt);
  bool peer_next = fetch_peer(1, peer);
  float acc[32];
  for (int i = 0; i < total; ++i) {
    const int chunk = i / steps, s = i % steps, slot = i & 1;
    if (s == 0) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    }
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // step i's tiles in place; step i - 1's products done
    if (i + 1 < total) fetch_d(i + 1, slot ^ 1);
    const unsigned char* d = c.dt + slot * 2 * kTileBytes;
    const unsigned char* dre = d;
    const unsigned char* dim = d + kTileBytes;
    if (kPhase == kStage1 || kPhase == kStage3) {
      const unsigned char* b = s == c.j ? src + chunk * kTileBytes : c.bt + slot * 2 * kTileBytes;
      const unsigned char* bre = b;
      const unsigned char* bim = s == c.j ? src + c.plane + chunk * kTileBytes : b + kTileBytes;
      if (kPhase == kStage1) {  // Cr = D1r Ar - D1i Ai, Ci = D1i Ar + D1r Ai
        if (c.wg == 0) {
          mma_pair<true>(acc, dre, bre, dim, bim);
        } else {
          mma_pair<false>(acc, dim, bre, dre, bim);
        }
      } else {  // yr = D1r Rr + D1i Ri, yi = D1r Ri - D1i Rr
        if (c.wg == 0) {
          mma_pair<false>(acc, dre, bre, dim, bim);
        } else {
          mma_pair<true>(acc, dre, bim, dim, bre);
        }
      }
    } else {
      unsigned char* abuf = kPhase == kMiddle1 ? c.yb : c.xb;  // C, or W
      const unsigned char* are = abuf + s * kTileBytes;
      const unsigned char* aim = abuf + c.plane + s * kTileBytes;
      if (kPhase == kMiddle1) {  // Pr = Cr D2r - Ci D2i, Pi = Cr D2i + Ci D2r
        if (c.wg == 0) {
          mma_pair<true>(acc, are, dre, aim, dim);
        } else {
          mma_pair<false>(acc, are, dim, aim, dre);
        }
      } else {  // Qr = Wr D2r + Wi D2i, Qi = Wi D2r - Wr D2i
        if (c.wg == 0) {
          mma_pair<false>(acc, are, dre, aim, dim);
        } else {
          mma_pair<true>(acc, aim, dre, are, dim);
        }
      }
    }
    if (peer_next) peer.store(c.bt + (slot ^ 1) * 2 * kTileBytes);
    peer_next = fetch_peer(i + 2, peer);
    if (s == steps - 1) epi(chunk, acc);
  }
}

template <int kNB, class IO>
__global__ void __launch_bounds__(kClusterThreads, 1)
ct_cluster_kernel(IO io, const float* __restrict__ kr, const float* __restrict__ ki,
                  const bf16* __restrict__ d1r, const bf16* __restrict__ d1i,
                  const bf16* __restrict__ d2r, const bf16* __restrict__ d2i,
                  const float* __restrict__ tr, const float* __restrict__ ti, int n1, int n2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kPlane = kNB * kTileBytes;
  constexpr int kN2P = kNB * kTile;
  cg::cluster_group cluster = cg::this_cluster();
  Cta c;
  c.xb = base;
  c.yb = c.xb + 2 * kPlane;
  c.dt = c.yb + 2 * kPlane;
  c.bt = c.dt + 4 * kTileBytes;
  c.xf = reinterpret_cast<float*>(c.bt + 4 * kTileBytes);
  c.plane = kPlane;
  c.j = static_cast<int>(cluster.block_rank());
  c.cs = static_cast<int>(cluster.num_blocks());
  c.own0 = c.j * kTile;  // first a / k1 of this CTA
  c.n1 = n1;
  c.n2 = n2;
  c.wg = threadIdx.x >> 7;  // 0: real part, 1: imaginary part
  c.t = threadIdx.x & 127;
  const int row = blockIdx.y;
  const int t = c.t, own0 = c.own0;
  float* xf = c.xf;

  // The own A slice, A[own0 + a][b], as tiles (row b, depth a), bf16.
  for (int idx = threadIdx.x; idx < 2 * kN2P * 8; idx += kClusterThreads) {
    const int part = idx / (kN2P * 8);
    const int rem = idx % (kN2P * 8);
    const int c8 = rem / kN2P, b = rem % kN2P;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a0 = own0 + 8 * c8 + 2 * i;
      const float v0 = (a0 < n1 && b < n2) ? io.load(row, part, a0 * n2 + b) : 0.0f;
      const float v1 = (a0 + 1 < n1 && b < n2) ? io.load(row, part, (a0 + 1) * n2 + b) : 0.0f;
      w[i] = pack_bf16(v0, v1);
    }
    *reinterpret_cast<uint4*>(c.xb + part * kPlane + b * 128 + (((c8 ^ b) & 7) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  cluster.sync();  // every slice in place

  // Both warpgroups post their sums; then each finishes half the chunk's
  // elements (accumulator registers 16 wg .. 16 wg + 15) with both parts at
  // hand, its float32 operands (twiddle or spectrum pairs) loaded first.
  auto exchange = [&](const float (&acc)[32]) {
#pragma unroll
    for (int v = 0; v < 32; ++v) xf[c.wg * kXfHalf + v * 128 + t] = acc[v];
    __syncthreads();
  };
  const int v0 = 16 * c.wg;
  // re, im of the pairs (v, v + 1) of this half at (own0 + row, col0 + col)
  // of a (n1, n2) float pair; zeros outside.
  auto load_pairs = [&](const float* __restrict__ gr, const float* __restrict__ gi, int col0,
                        float2 (&re)[8], float2 (&im)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = v0 + 2 * q;
      const int k1 = own0 + frag_row(t, v), col = col0 + frag_col(t, v);
      re[q] = im[q] = make_float2(0.0f, 0.0f);
      if (k1 < n1 && col < n2) {
        const size_t e = static_cast<size_t>(k1) * n2 + col;
        re[q] = *reinterpret_cast<const float2*>(gr + e);
        im[q] = *reinterpret_cast<const float2*>(gi + e);
      }
    }
  };
  auto sum_re = [&](int v) { return xf[v * 128 + t]; };
  auto sum_im = [&](int v) { return xf[kXfHalf + v * 128 + t]; };

  // ---- stage 1: C = bf16((D1 A) . T) into Y, the middle stage's A operand
  run_phase<kNB, kStage1>(cluster, c, d1r, d1i, [&](int nc, float (&acc)[32]) {
    float2 twr[8], twi[8];
    load_pairs(tr, ti, nc * kTile, twr, twi);
    exchange(acc);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = v0 + 2 * q;
      const int m = frag_row(t, v), col = frag_col(t, v);
      const float br0 = sum_re(v), br1 = sum_re(v + 1), bi0 = sum_im(v), bi1 = sum_im(v + 1);
      const uint32_t cr =
          pack_bf16(__fsub_rn(__fmul_rn(br0, twr[q].x), __fmul_rn(bi0, twi[q].x)),
                    __fsub_rn(__fmul_rn(br1, twr[q].y), __fmul_rn(bi1, twi[q].y)));
      const uint32_t ci =
          pack_bf16(__fadd_rn(__fmul_rn(br0, twi[q].x), __fmul_rn(bi0, twr[q].x)),
                    __fadd_rn(__fmul_rn(br1, twi[q].y), __fmul_rn(bi1, twr[q].y)));
      const int off = nc * kTileBytes + swz(m, col);
      *reinterpret_cast<uint32_t*>(c.yb + off) = cr;  // zeros outside: zero twiddles
      *reinterpret_cast<uint32_t*>(c.yb + kPlane + off) = ci;
    }
  });
  cluster.sync();  // every peer has read this CTA's A slice: X is free

  // ---- middle, part 1: W = bf16((C D2) . K) into X, 64 columns of k2 at a
  // time; D2 is symmetric, so D2 tile (k2 rows, b deep) is row-major D2
  run_phase<kNB, kMiddle1>(cluster, c, d2r, d2i, [&](int kc, float (&acc)[32]) {
    float2 sr[8], si[8];
    load_pairs(kr, ki, kc * kTile, sr, si);
    exchange(acc);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = v0 + 2 * q;
      const int m = frag_row(t, v), col = frag_col(t, v);
      const float pr0 = sum_re(v), pr1 = sum_re(v + 1), pi0 = sum_im(v), pi1 = sum_im(v + 1);
      const uint32_t wr =
          pack_bf16(__fsub_rn(__fmul_rn(pr0, sr[q].x), __fmul_rn(pi0, si[q].x)),
                    __fsub_rn(__fmul_rn(pr1, sr[q].y), __fmul_rn(pi1, si[q].y)));
      const uint32_t wi =
          pack_bf16(__fadd_rn(__fmul_rn(pr0, si[q].x), __fmul_rn(pi0, sr[q].x)),
                    __fadd_rn(__fmul_rn(pr1, si[q].y), __fmul_rn(pi1, sr[q].y)));
      const int off = kc * kTileBytes + swz(m, col);
      *reinterpret_cast<uint32_t*>(c.xb + off) = wr;  // zeros outside: zero spectrum
      *reinterpret_cast<uint32_t*>(c.xb + kPlane + off) = wi;
    }
  });

  // ---- middle, part 2: R = bf16((W conj(D2)) . conj(T)) over C, as stage
  // 3's B operand (row b, depth k1), 64 columns of b at a time
  run_phase<kNB, kMiddle2>(cluster, c, d2r, d2i, [&](int bc, float (&acc)[32]) {
    float2 twr[8], twi[8];
    load_pairs(tr, ti, bc * kTile, twr, twi);
    exchange(acc);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int v = v0 + q;
      const int m = frag_row(t, v), b = bc * kTile + frag_col(t, v);
      const float tc = (q & 1) ? twr[q >> 1].y : twr[q >> 1].x;
      const float td = (q & 1) ? twi[q >> 1].y : twi[q >> 1].x;
      const float qr = sum_re(v), qi = sum_im(v);
      const bf16 rr = __float2bfloat16_rn(__fadd_rn(__fmul_rn(qr, tc), __fmul_rn(qi, td)));
      const bf16 ri = __float2bfloat16_rn(__fsub_rn(__fmul_rn(qi, tc), __fmul_rn(qr, td)));
      const int off = swz(b, m);
      *reinterpret_cast<bf16*>(c.yb + off) = rr;  // zeros outside: zero twiddles
      *reinterpret_cast<bf16*>(c.yb + kPlane + off) = ri;
    }
  });
  cluster.sync();  // every R in place

  // ---- stage 3: y = conj(D1) R / n; each warpgroup stages its part's
  // 64 x 64 chunk in shared memory and stores it row by row
  const float scale = 1.0f / (static_cast<float>(n1) * static_cast<float>(n2));
  run_phase<kNB, kStage3>(cluster, c, d1r, d1i, [&](int nc, float (&acc)[32]) {
    float* stage = xf + c.wg * kXfHalf;
#pragma unroll
    for (int v = 0; v < 32; ++v) stage[frag_row(t, v) * kStageLd + frag_col(t, v)] = acc[v] * scale;
    __syncthreads();
    for (int idx = t; idx < kTile * kTile; idx += 128) {
      const int a = own0 + (idx >> 6), b = nc * kTile + (idx & 63);
      if (a < n1 && b < n2) io.store(row, c.wg, a * n2 + b, stage[(idx >> 6) * kStageLd + (idx & 63)]);
    }
  });
  cluster.sync();  // the peers have read this CTA's R
}

template <int kNB, class IO>
cudaError_t launch_cluster(IO io, const float* kr, const float* ki, const bf16* d1r,
                           const bf16* d1i, const bf16* d2r, const bf16* d2i, const float* tr,
                           const float* ti, int rows, int n1, int n2, cudaStream_t stream) {
  auto kernel = ct_cluster_kernel<kNB, IO>;
  const size_t smem = cluster_smem(kNB);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int cs = (n1 + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, n1, n2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class IO>
cudaError_t dispatch_cluster(IO io, const float* kr, const float* ki, const bf16* d1r,
                             const bf16* d1i, const bf16* d2r, const bf16* d2i, const float* tr,
                             const float* ti, int rows, int n1, int n2, cudaStream_t s) {
  switch ((n2 + kTile - 1) / kTile) {
    case 1: return launch_cluster<1>(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1, n2, s);
    case 2: return launch_cluster<2>(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1, n2, s);
    case 3: return launch_cluster<3>(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1, n2, s);
    case 4: return launch_cluster<4>(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1, n2, s);
    default: return cudaErrorInvalidValue;
  }
}

bool fits_cluster(int n1, int n2) { return n1 <= kMaxClusterN1 && n2 <= kMaxClusterN2; }

// -------------------------------------------------- large rows: three launches

using namespace nvcuda;

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

// Launches S1 on `stream` and returns the first CUDA error (0 on success):
// one cluster launch for rows with n1 <= 512 and n2 <= 256, else the three
// launches (cr, ci: (rows, n1, n2) bf16 scratch, unused by the cluster
// path).  The caller has checked: 1 <= rows <= 65535; n1, n2 multiples of
// 32, n2 <= 512, n1 <= 4096; every pointer on one device; zr, zi, yr, yi
// (rows, n1, n2) float32; kr, ki (n1, n2) float32; d1r, d1i (n1, n1) and
// d2r, d2i (n2, n2) bf16; tr, ti (n1, n2) float32, all contiguous and
// 16-byte aligned.
extern "C" int ct_conv(const float* zr, const float* zi, const float* kr, const float* ki,
                       const bf16* d1r, const bf16* d1i, const bf16* d2r, const bf16* d2i,
                       const float* tr, const float* ti, bf16* cr, bf16* ci,
                       float* yr, float* yi, int rows, int n1, int n2, void* stream) {
  if (rows == 0) return 0;
  if (n1 % 32 || n2 % 32 || n2 > kMaxN2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits_cluster(n1, n2)) {
    const RowsIO io{zr, zi, yr, yi, n1 * n2};
    return static_cast<int>(dispatch_cluster(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1,
                                             n2, s));
  }
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

// The fused d/dsignal: S1 over the packed overlap-save blocks of flip(g)
// (g (B, L) float32), writing flip of each block's valid window into dsig
// (B, L): blocks = B * chunks real block rows, rows = ceil(blocks / 2)
// complex rows, each block kept for c outputs after `lead`.  Rows of the
// cluster path only (n1 <= 512, n2 <= 256); the other checks as ct_conv.
extern "C" int ct_conv_dsignal(const float* g, float* dsig, const float* kr, const float* ki,
                               const bf16* d1r, const bf16* d1i, const bf16* d2r,
                               const bf16* d2i, const float* tr, const float* ti, int rows,
                               int n1, int n2, int blocks, int chunks, int c, int lead,
                               int length, void* stream) {
  if (rows == 0) return 0;
  if (n1 % 32 || n2 % 32 || !fits_cluster(n1, n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DsignalIO io{g, dsig, blocks, chunks, c, lead, length};
  return static_cast<int>(dispatch_cluster(io, kr, ki, d1r, d1i, d2r, d2i, tr, ti, rows, n1, n2,
                                           static_cast<cudaStream_t>(stream)));
}
