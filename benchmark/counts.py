"""The benchmark's yardstick of work: operations and bytes counted from
shapes and the configuration, never from the code that computes them,
and the H100's published peaks they are charged at.

A frozen copy of the arithmetic of ``ddsp_tpu_torch/utils/roofline.py``
as it stood when the benchmark was defined, so that no later change to
the program moves the yardstick.  Left out: ``GRU_STEP_LATENCY_S`` and
``K1_ROT_FLOOR_MS`` (measurements and estimates of today's code, not
bounds) and everything built on them.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# FLOP of one (sample, harmonic) point of the oscillator: the cheapest
# known evaluation (a recurrence step, two window multiply-adds and two
# exact sines every 32 harmonics)
FLOP_PER_POINT = 7.5

# CREPE (Kim et al. 2018): six conv stages over 1024-sample windows
CREPE_CHANNELS = {"tiny": [1, 128, 16, 16, 16, 32, 64],
                  "full": [1, 1024, 128, 128, 128, 256, 512]}
CREPE_KERNELS = [512] + 5 * [64]
CREPE_STRIDES = [4] + 5 * [1]
CREPE_PADS = [(254, 254)] + 5 * [(31, 32)]
PITCH_BINS = 360


def bound_s(flops: float, n_bytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least seconds: operations at the peak or bytes at the HBM rate."""
    return max(flops / peak_flops, n_bytes / PEAK_BYTES_PER_S)


def next_fft_size(n: int) -> int:
    """Smallest power of two or 3 * 2^k at least n (the program's FFT sizes)."""
    p2 = 1 << max(0, (n - 1).bit_length())
    p3 = 3 * (1 << max(0, ((n + 2) // 3 - 1).bit_length()))
    return min(x for x in (p2, p3) if x >= n)


def fft_flops(rows: int, n: int) -> float:
    """2.5 n log2 n FLOP a real n-point transform."""
    return rows * 2.5 * n * math.log2(n)


def crepe_window_macs(capacity: str, window: int = 1024) -> int:
    """MACs of one CREPE window: each stage's convolution over its padded
    input, then the (features, 360) classifier."""
    ch = CREPE_CHANNELS[capacity]
    length, macs = window, 0
    for i in range(6):
        out_len = (length + sum(CREPE_PADS[i]) - CREPE_KERNELS[i]) // CREPE_STRIDES[i] + 1
        macs += ch[i] * ch[i + 1] * CREPE_KERNELS[i] * out_len
        length = out_len // 2
    return macs + ch[6] * length * PITCH_BINS


def crepe_weight_bytes(capacity: str) -> int:
    ch = CREPE_CHANNELS[capacity]
    w = sum(ch[i] * ch[i + 1] * CREPE_KERNELS[i] + 5 * ch[i + 1] for i in range(6))
    return 4 * (w + ch[6] * 4 * PITCH_BINS + PITCH_BINS)


def frame_dft_macs(n_frames: int, n_fft: int) -> int:
    """MACs of the rDFT of ``n_frames`` frames as (n_fft, bins) products."""
    return n_frames * n_fft * (n_fft // 2 + 1) * 2


def encode_flops(b: int, frames: int, conf: dict) -> int:
    """CREPE over ``frames`` windows of ``b`` signals, and the loudness
    rDFT of as many frames (resampling and decoding not counted)."""
    crepe = frames * crepe_window_macs(conf["crepe_capacity"], conf["crepe_window"])
    return 2 * b * (crepe + frame_dft_macs(frames, conf["n_fft"]))


def controller_macs(b: int, t: int, conf: dict) -> int:
    """Matmul MACs of the controller over (b, t) frames."""
    u, layers, g = conf["decoder_mlp_units"], conf["decoder_mlp_layers"], conf["decoder_gru_units"]
    heads = conf["n_harmonics"] + 1 + conf["n_noise_filters"]

    def mlp(n_in):
        return n_in * u + (layers - 1) * u * u

    return b * t * (2 * mlp(1) + 2 * u * 3 * g + g * 3 * g + mlp(g + 2 * u) + u * heads)


def osc_forward_bytes(b: int, t: int, hop: int, h: int) -> int:
    samples, rows = b * t * hop, b * (t + 2)
    return 4 * (samples + rows * h + rows + 3 * hop + samples)


def osc_forward_bound_s(b: int, t: int, hop: int, h: int) -> float:
    return bound_s(FLOP_PER_POINT * b * t * hop * h, osc_forward_bytes(b, t, hop, h))


def noise_flops(b: int, t: int, conf: dict) -> float:
    """The filtered noise forward: each frame's FIR spectrum from its
    magnitudes (two n_filters x bins products) and the frame's rfft and
    irfft at the convolution's size."""
    n = next_fft_size(2 * conf["hop_length"] - 1)
    return 2 * b * t * 2 * conf["n_noise_filters"] * (n // 2 + 1) + fft_flops(2 * b * t, n)


def reverb_flops(b: int, length: int, ir_len: int) -> float:
    """The reverb forward as one linear convolution by transforms: the
    rows' and the impulse's rfft and the rows' irfft."""
    return fft_flops(2 * b + 1, next_fft_size(length + ir_len - 1))


def reverb_hop_flops(n: int, block: int, ir_len: int) -> float:
    """One hop of the partitioned reverb for ``n`` streams: the window's
    rfft and irfft at 2 block points and a complex multiply-add (8 FLOP)
    per bin of each of the impulse's partitions."""
    parts = -(-ir_len // block)
    return fft_flops(2 * n, 2 * block) + 8 * n * parts * (block + 1)


def mss_forward_flops(b: int, length: int, ffts, overlap: float) -> float:
    """The MSS loss forward's least work: the prediction's and the target's
    centred frames at every scale as real FFTs (2.5 n log2 n FLOP a frame).
    Not the rDFT-as-matmul products of ``stft_macs``, which a transform
    computes with far fewer operations: that count could put a fast
    implementation above 100 % of its bound."""
    total = 0.0
    for n in ffts:
        hop = int(n * (1 - overlap))
        total += fft_flops(1 + length // hop, n)
    return 2 * b * total


def mss_forward_bound_s(conf: dict, b: int, length: int) -> float:
    """The least seconds of the loss forward: its transforms at the float32
    peak, or reading the prediction and the target once."""
    flops = mss_forward_flops(b, length, conf["mss_ffts"], conf["mss_overlap"])
    return bound_s(flops, 2 * 4 * b * length)


def decoder_forward_flops(conf: dict, b: int) -> float:
    """One decoder forward at batch ``b`` and its loss: controller,
    oscillator, noise, reverb, MSS."""
    t, hop = conf["frames"], conf["hop_length"]
    length = t * hop
    ir = conf["reverb_length"] or conf["sample_rate"]
    return (2 * controller_macs(b, t, conf)
            + FLOP_PER_POINT * b * length * conf["n_harmonics"]
            + noise_flops(b, t, conf)
            + reverb_flops(b, length, ir)
            + mss_forward_flops(b, length, conf["mss_ffts"], conf["mss_overlap"]))


def train_step_flops(conf: dict, b: int, finetune: bool) -> float:
    """A training step's model FLOP: the forward and the backward as twice
    the forward; finetuning adds the encoder (CREPE and loudness) the
    same way.  No recomputation is counted."""
    fwd = decoder_forward_flops(conf, b)
    if finetune:
        fwd += encode_flops(b, conf["frames"], conf)
    return 3 * fwd


def serve_hop_flops(conf: dict, n: int) -> float:
    """One serving hop of ``n`` slots: one feature frame each (CREPE and
    the loudness rDFT), the controller at one frame, the oscillator's hop,
    the noise frame and the partitioned reverb."""
    hop = conf["hop_length"]
    ir = conf["reverb_length"] or conf["sample_rate"]
    return (encode_flops(n, 1, conf) + 2 * controller_macs(n, 1, conf)
            + FLOP_PER_POINT * n * hop * conf["n_harmonics"]
            + noise_flops(n, 1, conf) + reverb_hop_flops(n, hop, ir))


def features_bound_s(conf: dict, n: int, tail: int) -> float:
    """The least seconds of one hop's features for ``n`` slots: CREPE and
    the loudness rDFT at the float32 peak, or the bytes of the input tails,
    CREPE's weights and the features out."""
    flops = encode_flops(n, 1, conf)
    n_bytes = 4 * n * (tail + 3) + crepe_weight_bytes(conf["crepe_capacity"])
    return bound_s(flops, n_bytes)
