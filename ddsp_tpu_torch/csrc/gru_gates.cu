// gru_gates: the GRU's gate arithmetic for one time step, forward
// (gru_gates_fwd) and backward (gru_gates_bwd), with torch's gate order
// (reset, update, new).
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as
// ddsp_tpu/models/nn.py:gru_apply's lax.scan (:120-153), whose step XLA
// fuses.  In PyTorch the same step is ~13 launches forward and ~25-30
// autograd nodes backward, and the per-step slice of the input projection
// under autograd turns each step's gradient into a zero-fill and an add of
// the whole (B, T, 3H) projection.  ops/cuda/gru.py runs the recurrence as
// one autograd Function over the whole sequence: a step is one fp32 GEMM
// (gh = h W_hh^T + b_hh, or the carried gradient's dgh W_hh) and one
// launch of these kernels; the gradients that do not depend on time order
// (W_hh, b_hh, and through autograd W_ih, b_ih and x) are whole-sequence
// products after the loop.
//
// For batch row b, hidden unit j and step t, with gi (B, T, 3H), gh (B, 3H):
//
//   r = sigmoid(gi_r + gh_r)   z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r gh_n)    h_t = (1 - z) n + z h_{t-1}
//
// gru_gates_fwd writes h_t into out[:, t] and, when asked, r, z, n and
// gh_n into the (4, B, T, H) plane stack the backward reads.  gru_gates_bwd
// takes dh = carry + dy[:, t] and writes the pre-activation gradients
// (dgi[:, t] = (da_r, da_z, da_n), dgh[:, t] = (da_r, da_z, r da_n)) and
// the direct path dh z into the carry, to which the caller adds
// dgh[:, t] W_hh.  h_{t-1} is h0 at t = 0 and out[:, t-1] after, so the
// caller passes base pointers and t and makes no view a step.
//
// Accuracy: every operation rounds on its own, in the order the plain
// version's torch ops take (__fadd_rn / __fmul_rn keep nvcc from fusing a
// multiply and an add), with the accurate expf and tanhf torch's CUDA
// sigmoid and tanh call: 1 / (1 + exp(-x)).  Build without --use_fast_math.
//
// What bounds it on an H100: a step's bytes.  Forward: gi_t and gh (3H
// each), h_{t-1} in, h_t and four saved planes out, 12 floats a (b, j):
// 9.4 MB at (384, 512), 2.8 us at 3.35 TB/s (3.4 us measured in a CUDA
// graph).  Backward: dy, carry, four planes, h_{t-1} in, dgi, dgh (3H
// each) and the carry out, 14 floats a (b, j): 3.3 us (3.3 measured).
// Both are as long as a launch's own latency.  One thread a (b, j),
// consecutive j on consecutive threads, so every row of every operand is
// read and written coalesced; nothing is reused, so nothing is staged in
// shared memory.  The step's fp32 GEMM (cuBLAS, TF32 off; 22-28 us at
// (384, 512)) bounds the step, not these kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch's CUDA sigmoid: 1 / (1 + exp(-x)), each operation rounded
__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads)
gru_gates_fwd_kernel(const float* __restrict__ gi,  // (B, T, 3H)
                     const float* __restrict__ gh,  // (B, 3H)
                     const float* __restrict__ h0,  // (B, H)
                     float* out,                    // (B, T, H): reads t - 1, writes t
                     float* __restrict__ gates,     // (4, B, T, H) or null
                     int n_b, int n_t, int n_h, int t) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_b) * n_h) return;
  const int b = static_cast<int>(idx / n_h);
  const int j = static_cast<int>(idx - static_cast<long long>(b) * n_h);
  const size_t row = static_cast<size_t>(b) * n_t + t;  // (b, t) in the (B, T, .) layouts
  const float* g = gi + row * 3 * n_h;
  const float* q = gh + static_cast<size_t>(b) * 3 * n_h;
  const float hp = t == 0 ? h0[static_cast<size_t>(b) * n_h + j] : out[(row - 1) * n_h + j];
  const float r = sigmoid_rn(__fadd_rn(g[j], q[j]));
  const float z = sigmoid_rn(__fadd_rn(g[n_h + j], q[n_h + j]));
  const float hn = q[2 * n_h + j];
  const float n = tanhf(__fadd_rn(g[2 * n_h + j], __fmul_rn(r, hn)));
  out[row * n_h + j] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, hp));
  if (gates != nullptr) {
    const size_t plane = static_cast<size_t>(n_b) * n_t * n_h;
    float* s = gates + row * n_h + j;
    s[0] = r;
    s[plane] = z;
    s[2 * plane] = n;
    s[3 * plane] = hn;
  }
}

__global__ void __launch_bounds__(kThreads)
gru_gates_bwd_kernel(const float* __restrict__ dy,  // (B, T, H) by strides, or null
                     long long dy_sb, long long dy_st,
                     float* __restrict__ carry,        // (B, H): dh_t in, dh_t z out
                     const float* __restrict__ gates,  // (4, B, T, H): r, z, n, gh_n
                     const float* __restrict__ h0,     // (B, H)
                     const float* __restrict__ out,    // (B, T, H)
                     float* __restrict__ dgi,          // (B, T, 3H)
                     float* __restrict__ dgh,          // (B, T, 3H)
                     int n_b, int n_t, int n_h, int t) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_b) * n_h) return;
  const int b = static_cast<int>(idx / n_h);
  const int j = static_cast<int>(idx - static_cast<long long>(b) * n_h);
  const size_t row = static_cast<size_t>(b) * n_t + t;
  const size_t plane = static_cast<size_t>(n_b) * n_t * n_h;
  float* c = carry + static_cast<size_t>(b) * n_h + j;
  float dh = *c;
  if (dy != nullptr) dh = __fadd_rn(dh, dy[b * dy_sb + t * dy_st + j]);
  const float* s = gates + row * n_h + j;
  const float r = s[0], z = s[plane], n = s[2 * plane], hn = s[3 * plane];
  const float hp = t == 0 ? h0[static_cast<size_t>(b) * n_h + j] : out[(row - 1) * n_h + j];
  const float omz = __fsub_rn(1.0f, z);
  const float dn = __fmul_rn(dh, omz);
  const float dz = __fmul_rn(dh, __fsub_rn(hp, n));
  // tanh' = 1 - n^2, sigmoid' = (1 - y) y, in the plain version's order
  const float da_n = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(n, n)));
  const float da_r = __fmul_rn(__fmul_rn(__fmul_rn(da_n, hn), __fsub_rn(1.0f, r)), r);
  const float da_z = __fmul_rn(__fmul_rn(dz, omz), z);
  float* gi_row = dgi + row * 3 * n_h;
  float* gh_row = dgh + row * 3 * n_h;
  gi_row[j] = da_r;
  gi_row[n_h + j] = da_z;
  gi_row[2 * n_h + j] = da_n;
  gh_row[j] = da_r;
  gh_row[n_h + j] = da_z;
  gh_row[2 * n_h + j] = __fmul_rn(da_n, r);
  *c = __fmul_rn(dh, z);
}

unsigned blocks(int n_b, int n_h) {
  return static_cast<unsigned>((static_cast<long long>(n_b) * n_h + kThreads - 1) / kThreads);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller has checked shapes and contiguity: float32, 0 <= t < n_t,
// B * H / 256 blocks within the grid's 2^31 - 1.

extern "C" int gru_gates_fwd(const float* gi, const float* gh, const float* h0, float* out,
                             float* gates, int n_b, int n_t, int n_h, int t, void* stream) {
  if (n_b == 0 || n_h == 0) return 0;
  gru_gates_fwd_kernel<<<blocks(n_b, n_h), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gi, gh, h0, out, gates, n_b, n_t, n_h, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gru_gates_bwd(const float* dy, long long dy_sb, long long dy_st, float* carry,
                             const float* gates, const float* h0, const float* out, float* dgi,
                             float* dgh, int n_b, int n_t, int n_h, int t, void* stream) {
  if (n_b == 0 || n_h == 0) return 0;
  gru_gates_bwd_kernel<<<blocks(n_b, n_h), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, dy_sb, dy_st, carry, gates, h0, out, dgi, dgh, n_b, n_t, n_h, t);
  return static_cast<int>(cudaGetLastError());
}
