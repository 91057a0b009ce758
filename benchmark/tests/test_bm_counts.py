"""The benchmark's frozen counts against ``ddsp_tpu_torch.utils.roofline``
as it counts today, at the shapes of the cells."""

import json
import math
from pathlib import Path

import pytest

from benchmark import counts
from benchmark.models import ddsp_decoder as model
from ddsp_tpu_torch.utils import roofline

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["ddsp44k_tiny", "ddsp44k_full"]
# (batch or slots, frames) of each cell's unit of work
SHAPES = [(384, 172), (16, 172), (128, 1), (2048, 1)]


def _conf(name):
    fields = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    conf = model.config(fields)
    return conf, model.as_dict(conf)


@pytest.mark.parametrize("name", CONFIGS)
def test_crepe_and_encoder_counts(name):
    conf, cd = _conf(name)
    assert counts.crepe_window_macs(conf.crepe_capacity) == roofline.crepe_window_macs(
        conf.crepe_capacity)
    for b, t in SHAPES:
        assert counts.encode_flops(b, t, cd) == roofline.encode_flops(b, t, conf)


@pytest.mark.parametrize("name", CONFIGS)
def test_controller_counts(name):
    conf, cd = _conf(name)
    for b, t in SHAPES:
        assert counts.controller_macs(b, t, cd) == roofline.controller_macs(b, t, conf)


@pytest.mark.parametrize("b,t", SHAPES)
def test_oscillator_and_noise_counts(b, t):
    conf, cd = _conf("ddsp44k_tiny")
    fwd, _, _ = roofline.frame_bounds_ms(b, t, conf.hop_length, conf.n_harmonics)
    assert math.isclose(1e3 * counts.osc_forward_bound_s(b, t, conf.hop_length, conf.n_harmonics),
                        fwd[0], rel_tol=1e-12)
    n = counts.next_fft_size(2 * conf.hop_length - 1)
    assert n == roofline.next_fft_size(2 * conf.hop_length - 1)
    design = roofline.noise_fir_macs(b, t, conf, backward=False)
    assert counts.noise_flops(b, t, cd) == 2 * design + roofline.fft_cost(2 * b * t, n)[0]
    assert counts.FLOP_PER_POINT == roofline.FLOP_PER_POINT
    assert counts.serve_hop_flops(cd, b) > 0


def test_peaks_and_fft_sizes():
    assert (counts.PEAK_FP32_FLOPS, counts.PEAK_BF16_FLOPS, counts.PEAK_BYTES_PER_S) == (
        roofline.PEAK_FP32_FLOPS, roofline.PEAK_BF16_FLOPS, roofline.PEAK_BYTES_PER_S)
    for n in [1, 2, 3, 5, 1023, 1024, 1025, 132163, 176127, 200000]:
        assert counts.next_fft_size(n) == roofline.next_fft_size(n)
        assert counts.fft_flops(3, n) == roofline.fft_cost(3, n)[0]


def test_reverb_counts():
    conf, cd = _conf("ddsp44k_tiny")
    length = cd["frames"] * conf.hop_length
    n = roofline.next_fft_size(length + conf.ir_length - 1)
    assert counts.reverb_flops(128, length, conf.ir_length) == roofline.fft_cost(2 * 128 + 1, n)[0]


def test_copies_leave_out_measured_latencies():
    assert not hasattr(counts, "GRU_STEP_LATENCY_S")
    assert not hasattr(counts, "K1_ROT_FLOOR_MS")
