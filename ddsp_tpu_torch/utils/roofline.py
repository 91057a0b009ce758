"""Roofline accounting for the port on one NVIDIA H100.

The counterpart of ``ddsp_tpu/utils/roofline.py``: "the least time the card
could take" as a computed number.  Every function takes shapes or a
``Config`` and never the name of an implementation, so a share of a bound
reads the same work whatever implements it.  Each bound is the larger of
two times: the operations over the card's peak rate for their type, and
the bytes the function must move (each input read once, each output
written once) over the memory rate.

Peaks of the H100 SXM at its 700 W limit (NVIDIA's data sheet, dense): 67
TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 on them, 3.35
TB/s of HBM3.  The port runs float32 matmuls at full float32 (TF32 off,
``device.resolve_device``), so they count at the float32 peak.

Not carried over from the JAX module: its v5e ceilings (``MXU_*``,
``VPU_OPS``, ``HBM_BYTES_PER_S``; the H100's are the ``PEAK_*`` below),
the Pallas kernels' frame blocking (``OSC_*_FRAMES_PER_BLOCK``) and
``OSC_FILL_STORE_ISSUE_FACTOR`` with ``osc_speed_of_light_s``'s
``achievable``: that factor was a measured v5e store cost.  The JAX
module's ``_fft_row_macs`` and ``_overlap_save_plan`` model a matmul DFT
that the port replaced with cuFFT: each ``torch.fft`` transform here is
charged its bytes at the HBM rate and 2.5 N log2 N FLOP a real N-point
transform at the float32 peak (:func:`fft_cost`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ddsp_tpu_torch.models.crepe import CAPACITIES, KERNEL_SIZES, PADS, PITCH_BINS, STRIDES
from ddsp_tpu_torch.ops.fft import _split_factors, next_fft_size, overlap_save_plan

PEAK_FP32_FLOPS = 67e12  # H100 SXM, 700 W (NVIDIA data sheet): fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # the same card's bf16 tensor-core dense peak
PEAK_BYTES_PER_S = 3.35e12  # its HBM3 bandwidth
# Cheapest known evaluation of one (sample, harmonic) point, counted from
# K7 (csrc/osc_cheb.cu), which holds > 90 dB against float64 at full width:
# the recurrence (one multiply, one subtract), two window multiply-adds
# (hop % 256 == 0), and two exact sines every 32 harmonics, each ~24 FLOP
# (the split phase's 7 operations, sinf's reduction and polynomial):
# 2 + 4 + 48/32 = 7.5 FLOP.  The bound of K1, K5 and K7.
FLOP_PER_POINT = 7.5
# The frame backward per point: the (sin, cos) rotation, the seed
# amortised, and three window sums each for harm, the phase derivative
# and the window-amplitude gradient: 14 FMAs, 28 FLOP.
FLOP_PER_POINT_BWD = 28
# K6 and S2 per point: the rotation of a (sine, cosine) pair (4 multiplies,
# 2 adds) and its exact seeds amortised (~1.5 FLOP) at the fp32 peak; K6's
# three contractions, 2 FLOP x 3 windows each, at the bf16 dense peak.
FILL_FLOP_PER_POINT = 7.5
K6_MMA_FLOP_PER_POINT = 18
# K1's rot issue-slot floor at the training shape (16 x 172 x 512 =
# 1,409,024 samples, PERF.md section 6), scaled by samples in
# k1_rot_floor_ms: an estimate from its SASS, not a measurement.
K1_ROT_FLOOR_MS, K1_ROT_FLOOR_SAMPLES = 0.0991, 1409024
# The device time of one recurrence step of models/nn.GRU at batch 16
# (512 units; one addmm and one gru_gates_fwd launch), replayed from a
# CUDA graph of 172 steps: 8.1926 us by chip_smoke.py phase 19 on an
# NVIDIA H100 80GB HBM3 at 700.00 W.  The serial floor of the
# controller's recurrence, forward and backward.
GRU_STEP_LATENCY_S = 8.1926e-6


def bound_ms(flops: float, n_bytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(ms, "operations" | "bytes"): the larger of ``flops`` at
    ``peak_flops`` and ``n_bytes`` at the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- the kernels


def kernel_bound_ms(n: int, hop: int, h: int):
    """K5 (``osc_hop_slots``): one hop of ``n`` slots, ``h`` harmonics."""
    n_bytes = 4 * (n * hop + 3 * n * h + 3 * n + 3 * hop + n * hop)
    return bound_ms(FLOP_PER_POINT * n * hop * h, n_bytes)


def frame_bounds_ms(b: int, t: int, hop: int, h: int):
    """(forward, backward, overlap-add) bounds of K1, K2 and K2's
    overlap-add at (B, T, hop, H): each a (ms, "operations" | "bytes")."""
    points = b * t * hop * h
    samples, rows = b * t * hop, b * (t + 2)
    fwd_bytes = 4 * (samples + rows * h + rows + 3 * hop + samples)
    # in: g, phase, amps_pad, loud_pad, w; out: dphase, d amps_pad, d loud_pad
    bwd_bytes = 4 * (2 * samples + rows * h + rows + 3 * hop + samples + rows * h + rows)
    # in: da_win, dl_win; out: d amps_pad, d loud_pad (two adds an output)
    oa_bytes, oa_flop = 4 * (b * t * 3 * (h + 1) + rows * (h + 1)), 2 * rows * (h + 1)
    return [bound_ms(FLOP_PER_POINT * points, fwd_bytes),
            bound_ms(FLOP_PER_POINT_BWD * points, bwd_bytes), bound_ms(oa_flop, oa_bytes)]


def k1_rot_floor_ms(samples: int) -> float:
    """K1's rot issue-slot floor (an estimate) scaled to ``samples``."""
    return K1_ROT_FLOOR_MS * samples / K1_ROT_FLOOR_SAMPLES


def variant_bound_ms(kernel: str, b: int, t: int, hop: int, h: int):
    """(ms, "operations" | "bytes") of an oscillator kernel by its launch
    counter's name: K8 variants their base kernel's bound, K7 the
    forward's, K5 over B*T rows its own, K6 the larger of its fill at the
    fp32 peak and its contractions at the bf16 peak (or its bytes), S2 its
    fill (or its bytes)."""
    (fwd_ms, fwd_by), (bwd_ms, bwd_by), _ = frame_bounds_ms(b, t, hop, h)
    if kernel.startswith("osc_frames_fwd") or kernel == "osc_cheb_fwd":
        return fwd_ms, fwd_by
    if kernel.startswith("osc_frames_bwd"):
        return bwd_ms, bwd_by
    if kernel == "osc_hop_slots":
        return kernel_bound_ms(b * t, hop, h)
    points, samples, rows = b * t * hop * h, b * t * hop, b * (t + 2)
    if kernel == "osc_banked_bwd":
        n_bytes = 4 * (2 * samples + rows * h + rows + 3 * hop + samples + rows * h + rows)
        times = {"operations": max(FILL_FLOP_PER_POINT * points / PEAK_FP32_FLOPS,
                                   K6_MMA_FLOP_PER_POINT * points / PEAK_BF16_FLOPS)}
    else:  # osc_fill_only: phase, amps in; dphase, the windows' copies, zeros out
        n_bytes = 4 * (samples + rows * h + samples + 3 * b * t * h + 3 * b * t)
        times = {"operations": FILL_FLOP_PER_POINT * points / PEAK_FP32_FLOPS}
    times["bytes"] = n_bytes / PEAK_BYTES_PER_S
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def _frame_macs(n_frames: int, n_fft: int) -> int:
    """Hann-rDFT MACs of ``n_frames`` frames: the (n_fft, bins) cos and sin
    products."""
    return n_frames * n_fft * (n_fft // 2 + 1) * 2


def stft_bounds_ms(b: int, n_blocks: int, hop: int, n_frames: int, n_fft: int,
                   dtype: str = "bfloat16"):
    """(forward, backward) bounds of K3 and K4 on the bf16 copy of the hop
    blocks, each (ms, "operations" | "bytes"): the forward's 2 MACs a
    (frame, sample, bin) (:func:`stft_macs`' rDFT products, re and im) at
    ``dtype``'s peak, or its bytes (bf16 xb and matrices in, float32 |S|^2
    out); the backward twice the flops (the re/im recompute and the
    transposed products), reading bf16 xb and matrices and float32 dmag,
    writing float32 dxb."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    bins = n_fft // 2 + 1
    flops = 2 * b * _frame_macs(n_frames, n_fft)
    samples, mag_bytes, w_bytes = b * n_blocks * hop, 4 * b * n_frames * bins, 2 * 2 * n_fft * bins
    return [bound_ms(flops, 2 * samples + w_bytes + mag_bytes, peak),
            bound_ms(2 * flops, (2 + 4) * samples + w_bytes + mag_bytes, peak)]


def ct_conv_bound_ms(rows: int, n: int):
    """S1 (``ct_conv``): 16 n (n1 + n2) FLOP a complex row at the bf16
    peak, or its bytes (the rows in and out, the spectrum in)."""
    n1, n2 = _split_factors(n)
    return bound_ms(rows * 16 * n * (n1 + n2), 4 * (4 * rows * n + 2 * n), PEAK_BF16_FLOPS)


def dsignal_bound_ms(rows: int, n: int, batch: int, length: int):
    """The fused d/dsignal (``ct_conv_dsignal``): S1's operations on
    ``rows`` complex rows at the bf16 peak, or its bytes (g in, dsignal
    out, the spectrum in) at the HBM rate."""
    n1, n2 = _split_factors(n)
    return bound_ms(rows * 16 * n * (n1 + n2), 4 * (2 * batch * length + 2 * n),
                    PEAK_BF16_FLOPS)


def style_eval_flops(n_features: int, c_in: int, k: int, frames: int) -> float:
    """FLOP of one style-transfer loss evaluation with its gradient: the
    conv forward and d/dspec (4 F C k T'), the Gram forward and backward
    (6 F^2 T')."""
    return 4.0 * n_features * c_in * k * frames + 6.0 * n_features * n_features * frames


# --------------------------------------------------- the JAX module's counts


def osc_counts(b: int, t: int, hop: int, n_h: int):
    """(points, forward FLOP, backward FLOP) of a frame render: the
    (sample, harmonic) points the hand kernels evaluate (no padded bank,
    no frame blocks) and the FLOP they charge them."""
    points = b * t * hop * n_h
    return points, FLOP_PER_POINT * points, FLOP_PER_POINT_BWD * points


def osc_speed_of_light_s(b: int, t: int, hop: int, n_h: int, backward: bool = False) -> float:
    """Least seconds of the frame oscillator: K1's bound, plus K2's and its
    overlap-add's with ``backward``.  The JAX module's ``achievable``
    (its fill charged at a measured v5e store cost) has no counterpart."""
    fwd, bwd, oa = frame_bounds_ms(b, t, hop, n_h)
    ms = fwd[0] + (bwd[0] + oa[0] if backward else 0.0)
    return 1e-3 * ms


def crepe_window_macs(capacity: str = "tiny", window: int = 1024) -> int:
    """MACs for ONE CREPE window through the 6-conv stack + classifier
    (``models/crepe.py``): per stage a stride-s conv over the padded input
    (c_in c_out k out_len), then maxpool(2); the (in_features, 360)
    classifier.  BN, ReLU and pool work is not counted."""
    spec = CAPACITIES[capacity]
    length = window
    macs = 0
    for i in range(6):
        padded = length + PADS[i][0] + PADS[i][1]
        out_len = (padded - KERNEL_SIZES[i]) // STRIDES[i] + 1
        macs += spec["in_channels"][i] * spec["out_channels"][i] * KERNEL_SIZES[i] * out_len
        length = out_len // 2
    return macs + spec["in_features"] * PITCH_BINS


def encode_flops(b: int, frames: int, conf) -> int:
    """FLOP of one batched feature extraction: CREPE over ``frames``
    windows an example plus the loudness rDFT (an n_fft x (n_fft/2+1) cos
    and sin product a frame).  The resample and the pitch decode are not
    counted."""
    crepe = frames * crepe_window_macs(conf.crepe_capacity, conf.crepe_window)
    loud = _frame_macs(frames, conf.n_fft)
    return 2 * b * (crepe + loud)


def stft_macs(length: int, ffts, overlap: float) -> int:
    """Hann-rDFT MACs for one signal across all MSS scales: per scale n,
    hop n (1 - overlap), 1 + length // hop centre-padded frames, the cos and
    sin products of (n, n/2+1) a frame.  These are K3's products."""
    total = 0
    for n in ffts:
        hop = int(n * (1 - overlap))
        total += _frame_macs(1 + length // hop, n)
    return total


def mss_flops(b: int, length: int, ffts, overlap: float, backward: bool = False):
    """Hann-rDFT FLOP of one MSS loss evaluation over a batch: prediction
    and target forward; the backward adds about the prediction's
    transposed products (the target has no gradient)."""
    return 2 * (3 if backward else 2) * b * stft_macs(length, ffts, overlap)


def controller_macs(b: int, t: int, conf) -> int:
    """Matmul MACs of one controller forward (``models/controller.py``):
    two input MLPs, the GRU (input projection and recurrence), the
    post-GRU MLP and the three heads.  LayerNorm and activations are not
    counted."""
    u, layers, g = conf.decoder_mlp_units, conf.decoder_mlp_layers, conf.decoder_gru_units
    heads = conf.n_harmonics + 1 + conf.n_noise_filters

    def mlp(n_in):
        return n_in * u + (layers - 1) * u * u

    per_frame = (mlp(1) + mlp(1) + 2 * u * 3 * g + g * 3 * g + mlp(g + 2 * u) + u * heads)
    return b * t * per_frame


def decoder_param_count(conf) -> int:
    """Trainable parameters of the decoder (controller + reverb)."""
    u, layers, g = conf.decoder_mlp_units, conf.decoder_mlp_layers, conf.decoder_gru_units
    heads = conf.n_harmonics + 1 + conf.n_noise_filters

    def mlp(n_in):
        return n_in * u + u + 2 * u + (layers - 1) * (u * u + u + 2 * u)

    gru = conf.decoder_gru_layers * (3 * g * 2 * u + 3 * g * g + 6 * g)
    dense = u * heads + heads
    return mlp(1) * 2 + gru + mlp(g + 2 * u) + dense + conf.ir_length + 2


# ------------------------------------------------------------- the transforms


def fft_cost(rows: int, n: int) -> Tuple[float, float]:
    """(FLOP, bytes) of ``rows`` real ``n``-point ``torch.fft`` transforms:
    2.5 n log2 n FLOP each, n float32 samples one way and n/2+1 complex64
    bins the other."""
    return rows * 2.5 * n * math.log2(n), rows * (4 * n + 8 * (n // 2 + 1))


def _stage_s(flops: float, n_bytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> float:
    return 1e-3 * bound_ms(flops, n_bytes, peak_flops)[0]


def noise_fir_macs(b: int, t: int, conf, backward: bool = True) -> int:
    """Matmul MACs of the filtered-noise stage (``ops/fir.
    convolve_designed_fir``): per frame the design-spectrum pair (n_filters
    x bins, twice) and, with ``backward``, its transpose for the filter
    magnitudes.  Its rfft and irfft are cuFFT's: :func:`noise_fir_bound_s`
    charges them."""
    n = next_fft_size(2 * conf.hop_length - 1)
    design = 2 * conf.n_noise_filters * (n // 2 + 1)
    return b * t * design * (2 if backward else 1)


def noise_fir_bound_s(conf, b: int, t: int) -> float:
    """Least seconds of the filtered noise forward and backward: the design
    products at the float32 peak with three n-point transforms a frame (the
    noise frames' rfft and the irfft forward, the irfft's adjoint
    backward; the noise takes no gradient), or the transforms' and the
    magnitudes' bytes."""
    n = next_fft_size(2 * conf.hop_length - 1)
    flops, n_bytes = fft_cost(3 * b * t, n)
    n_bytes += 4 * 2 * b * t * conf.n_noise_filters  # magnitudes in, their gradient out
    return _stage_s(2 * noise_fir_macs(b, t, conf) + flops, n_bytes)


def _reverb_transforms(b: int, length: int, ir_len: int, grad_matmul_dtype) -> List[tuple]:
    """[(rows, n)] of the reverb's float32 transforms, forward and backward
    (``ops/fir.fft_convolve``)."""
    n = next_fft_size(length + ir_len - 1)
    fwd = [(2 * b + 1, n)]  # rfft of the signal rows and of the IR, irfft
    if grad_matmul_dtype == "bfloat16" and overlap_save_plan(b, length, ir_len):
        return fwd + [(b + 1, n)]  # d/dkernel: rfft(g), one irfft of the batch sum
    return fwd + [(2 * b + 1, n)]  # autograd of the float32 convolution


def reverb_conv_macs(b: int, length: int, ir_len: int, backward: bool = True,
                     grad_matmul_dtype: str = "bfloat16") -> int:
    """Matmul MACs of the reverb convolution: its forward is cuFFT's (no
    matmul); with ``backward`` at bf16 the d/dsignal's permuted-CT rows
    (S1, 8 n (n1 + n2) real MACs a complex row of the overlap-save plan)."""
    plan = overlap_save_plan(b, length, ir_len)
    if not backward or grad_matmul_dtype != "bfloat16" or plan is None:
        return 0
    n1, n2 = _split_factors(plan.n)
    return plan.rows * 8 * plan.n * (n1 + n2)


def reverb_bound_s(conf, b: int, length: int) -> float:
    """Least seconds of the reverb forward and backward at the routes
    ``conf.reverb_grad_matmul_dtype`` selects: the float32 transforms
    (:func:`fft_cost`) and, on the bf16 route, S1's d/dsignal
    (:func:`dsignal_bound_ms`)."""
    dtype = conf.reverb_grad_matmul_dtype
    total = 0.0
    for rows, n in _reverb_transforms(b, length, conf.ir_length, dtype):
        total += _stage_s(*fft_cost(rows, n))
    plan = overlap_save_plan(b, length, conf.ir_length)
    if dtype == "bfloat16" and plan is not None:
        total += 1e-3 * dsignal_bound_ms(plan.rows, plan.n, b, length)[0]
    return total


def mss_bound_s(conf, b: int, length: int) -> float:
    """Least seconds of the MSS loss forward and backward: at each scale
    K3's bound over prediction and target and K4's over the prediction
    (:func:`stft_bounds_ms` at ``conf.loss_matmul_dtype``'s peak)."""
    total = 0.0
    for n in conf.mss_ffts:
        hop = int(n * (1 - conf.mss_overlap))
        n_frames, n_blocks = 1 + length // hop, -(-(length + n) // hop)
        fwd, _ = stft_bounds_ms(2 * b, n_blocks, hop, n_frames, n, conf.loss_matmul_dtype)
        _, bwd = stft_bounds_ms(b, n_blocks, hop, n_frames, n, conf.loss_matmul_dtype)
        total += 1e-3 * (fwd[0] + bwd[0])
    return total


def train_step_bound_s(conf, b: int) -> Tuple[float, Dict[str, float]]:
    """(bound seconds, breakdown): the least time of one train step at
    batch ``b`` (decoder forward, MSS loss, the whole backward, Adam).

    Each stage is bound by its own limiting resource; the stages depend on
    each other (controller -> synths -> loss -> backward -> update), so
    their bounds add.  The controller's matmuls count at the float32 peak,
    their backward as twice the forward; the GRU's recurrence as its
    measured serial step, forward and backward; Adam as 7 parameter-sized
    float32 arrays moved (parameters, gradients, m and v read; parameters,
    m and v written)."""
    t, length = conf.frames_per_example, conf.example_length
    breakdown = {
        "controller": 3 * 2 * controller_macs(b, t, conf) / PEAK_FP32_FLOPS,
        "gru_serial_latency": 2 * t * GRU_STEP_LATENCY_S,
        "oscillator": osc_speed_of_light_s(b, t, conf.hop_length, conf.n_harmonics,
                                           backward=True),
        "noise_fir": noise_fir_bound_s(conf, b, t),
        "reverb_fft": reverb_bound_s(conf, b, length),
        "mss_loss": mss_bound_s(conf, b, length),
        "adam_hbm": 7 * 4 * decoder_param_count(conf) / PEAK_BYTES_PER_S,
    }
    return sum(breakdown.values()), breakdown
