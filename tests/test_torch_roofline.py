"""The port's roofline model (``ddsp_tpu_torch/utils/roofline.py``) on CPU.

* The work counted alike in both packages (CREPE's window MACs at every
  capacity, the controller's MACs, the CREPE term of ``encode_flops``, the
  rDFT MACs of the MSS loss, the decoder's parameters) equals
  ``ddsp_tpu/utils/roofline.py``'s exactly, at the suite's tiny config and
  at ``Config()``; the parameter count also equals the port's own decoder.
* Every kernel bound equals, to 5 significant digits, what PERF.md's
  kernel table prints (the values ``chip_smoke.py`` computed before the
  bounds moved here).
* ``train_step_bound_s``'s stages are positive and add up to its total.
* No roofline function takes the name of an implementation.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import inspect

import pytest
import torch

from ddsp_tpu.config import Config as JaxConfig
from ddsp_tpu.utils import roofline as jax_roofline
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import decoder_init
from ddsp_tpu_torch.models.crepe import CAPACITIES
from ddsp_tpu_torch.ops.fft import overlap_save_plan
from ddsp_tpu_torch.ops.spectral import hop_blocks
from ddsp_tpu_torch.utils import roofline

SMALL = dict(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16, reverb_length=300,
    crepe_window=1024, crepe_sample_rate=16000, example_duration=0.5, batch_size=2,
    mss_ffts=(256, 128, 64),
)
CONFIGS = {"tiny": SMALL, "default": {}}


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
def test_crepe_window_macs_equal_jax(capacity):
    assert roofline.crepe_window_macs(capacity) == jax_roofline.crepe_window_macs(capacity)
    assert (roofline.crepe_window_macs(capacity, 2048)
            == jax_roofline.crepe_window_macs(capacity, 2048))


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_shared_counts_equal_jax(which):
    conf, jconf = Config(**CONFIGS[which]), JaxConfig(**CONFIGS[which])
    b, t, length = conf.batch_size, conf.frames_per_example, conf.example_length
    assert roofline.controller_macs(b, t, conf) == jax_roofline.controller_macs(b, t, jconf)
    # encode_flops' CREPE term: the whole count less the loudness rDFT's
    crepe = 2 * b * t * roofline.crepe_window_macs(conf.crepe_capacity, conf.crepe_window)
    jcrepe = 2 * b * t * jax_roofline.crepe_window_macs(jconf.crepe_capacity, jconf.crepe_window)
    assert crepe == jcrepe
    assert roofline.encode_flops(b, t, conf) == jax_roofline.encode_flops(b, t, jconf)
    assert (roofline.stft_macs(length, conf.mss_ffts, conf.mss_overlap)
            == jax_roofline.stft_macs(length, jconf.mss_ffts, jconf.mss_overlap))
    for backward in (False, True):
        assert (roofline.mss_flops(b, length, conf.mss_ffts, conf.mss_overlap, backward)
                == jax_roofline.mss_flops(b, length, jconf.mss_ffts, jconf.mss_overlap,
                                          backward))
    assert roofline.decoder_param_count(conf) == jax_roofline.decoder_param_count(jconf)
    assert roofline.decoder_param_count(conf) == sum(
        p.numel() for p in decoder_init(conf).parameters())


def test_default_decoder_param_count():
    assert roofline.decoder_param_count(Config()) == 4_973_502


def test_mss_flops_are_the_stft_kernels_products():
    """K3's FLOP at each MSS size (its bound's operations) are the rDFT
    products that stft_macs counts: 4 B T n_fft bins."""
    conf, b = Config(), 16
    length = conf.example_length
    total = 0.0
    for n in conf.mss_ffts:
        hop = n // 4
        _, n_frames = hop_blocks(torch.zeros(1, length), n, hop)
        total += 4 * b * n_frames * n * (n // 2 + 1)
    assert total == b * 2 * roofline.stft_macs(length, conf.mss_ffts, conf.mss_overlap)
    assert roofline.mss_flops(b, length, conf.mss_ffts, conf.mss_overlap) == 2 * total


# (bound, its arguments, the ms PERF.md's kernel table prints, to 5
# significant digits)
BOUNDS = [
    ("K5 256 slots", lambda: roofline.kernel_bound_ms(256, 512, 180), 0.0026410, "operations"),
    ("K5 1024 slots", lambda: roofline.kernel_bound_ms(1024, 512, 180), 0.010564, "operations"),
    ("K5 2048 slots", lambda: roofline.kernel_bound_ms(2048, 512, 180), 0.021128, "operations"),
    ("K5 one slot", lambda: roofline.kernel_bound_ms(1, 512, 180), 1.0316e-05, "operations"),
    ("K1", lambda: roofline.frame_bounds_ms(16, 172, 512, 180)[0], 0.028391, "operations"),
    ("K2", lambda: roofline.frame_bounds_ms(16, 172, 512, 180)[1], 0.10599, "operations"),
    ("K2 overlap-add", lambda: roofline.frame_bounds_ms(16, 172, 512, 180)[2], 0.0023860,
     "bytes"),
    ("K1 60 s file", lambda: roofline.frame_bounds_ms(1, 5168, 512, 180)[0], 0.053315,
     "operations"),
    ("K1 TP shard", lambda: roofline.frame_bounds_ms(16, 172, 512, 45)[0], 0.0070977,
     "operations"),
    ("K5 rows", lambda: roofline.variant_bound_ms("osc_hop_slots", 16, 172, 512, 180), 0.028391,
     "operations"),
    ("K7", lambda: roofline.variant_bound_ms("osc_cheb_fwd", 16, 172, 512, 180), 0.028391,
     "operations"),
    ("K6", lambda: roofline.variant_bound_ms("osc_banked_bwd", 16, 172, 512, 180), 0.028391,
     "operations"),
    ("S2", lambda: roofline.variant_bound_ms("osc_fill_only", 16, 172, 512, 180), 0.028391,
     "operations"),
    ("K8 bwd", lambda: roofline.variant_bound_ms("osc_frames_bwd[fill=rot,bf16]", 16, 172, 512,
                                                 180), 0.10599, "operations"),
    ("S1", lambda: roofline.ct_conv_bound_ms(16, 98304), 0.016285, "operations"),
    ("S1 d/dsignal", lambda: roofline.dsignal_bound_ms(
        overlap_save_plan(16, 88064, 44100).rows, overlap_save_plan(16, 88064, 44100).n, 16,
        88064), 0.016285, "operations"),
]


def _stft_sum(which: int) -> float:
    total = 0.0
    for n in (2048, 1024, 512, 256, 128, 64):
        xb, n_frames = hop_blocks(torch.zeros(16, 88064), n, n // 4)
        total += roofline.stft_bounds_ms(16, xb.shape[1], n // 4, n_frames, n)[which][0]
    return total


@pytest.mark.parametrize("name,bound,want,by", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_kernel_bounds_are_perf_tables(name, bound, want, by):
    ms, got_by = bound()
    assert f"{ms:.5g}" == f"{want:.5g}" and got_by == by


@pytest.mark.parametrize("which,want", [(0, 0.053958), (1, 0.10011)], ids=["K3", "K4"])
def test_stft_bounds_over_six_sizes_are_perf_tables(which, want):
    assert f"{_stft_sum(which):.5g}" == f"{want:.5g}"


@pytest.mark.parametrize("reverb", ["bfloat16", "float32"])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_train_step_bound_stages_sum_to_total(which, reverb):
    conf = Config(**CONFIGS[which], reverb_grad_matmul_dtype=reverb)
    total, stages = roofline.train_step_bound_s(conf, conf.batch_size)
    assert set(stages) == {"controller", "gru_serial_latency", "oscillator", "noise_fir",
                           "reverb_fft", "mss_loss", "adam_hbm"}
    assert all(v > 0 for v in stages.values()), stages
    assert total == pytest.approx(sum(stages.values()), rel=1e-12)
    assert stages["gru_serial_latency"] == 2 * conf.frames_per_example * (
        roofline.GRU_STEP_LATENCY_S)
    assert stages["oscillator"] == roofline.osc_speed_of_light_s(
        conf.batch_size, conf.frames_per_example, conf.hop_length, conf.n_harmonics, True)


def test_reverb_counts_follow_the_gradient_route():
    """The bf16 backward's d/dsignal is S1's matmul work; the float32 route
    has none and runs more transforms instead."""
    bf16, f32 = Config(), Config(reverb_grad_matmul_dtype="float32")
    plan = overlap_save_plan(16, bf16.example_length, bf16.ir_length)
    s1_ms = roofline.dsignal_bound_ms(plan.rows, plan.n, 16, bf16.example_length)[0]
    assert roofline.reverb_conv_macs(16, bf16.example_length, bf16.ir_length) > 0
    assert roofline.reverb_conv_macs(16, bf16.example_length, bf16.ir_length,
                                     grad_matmul_dtype="float32") == 0
    assert roofline.reverb_conv_macs(16, bf16.example_length, bf16.ir_length,
                                     backward=False) == 0
    assert roofline.reverb_bound_s(bf16, 16, bf16.example_length) > 1e-3 * s1_ms
    assert roofline.reverb_bound_s(f32, 16, f32.example_length) > 0


def test_osc_speed_of_light_is_the_frame_bounds():
    fwd, bwd, oa = roofline.frame_bounds_ms(16, 172, 512, 180)
    assert roofline.osc_speed_of_light_s(16, 172, 512, 180) == 1e-3 * fwd[0]
    assert roofline.osc_speed_of_light_s(16, 172, 512, 180, backward=True) == pytest.approx(
        1e-3 * (fwd[0] + bwd[0] + oa[0]), rel=1e-15)
    points, fwd_flop, bwd_flop = roofline.osc_counts(16, 172, 512, 180)
    assert points == 16 * 172 * 512 * 180
    assert (fwd_flop, bwd_flop) == (roofline.FLOP_PER_POINT * points,
                                    roofline.FLOP_PER_POINT_BWD * points)


IMPLEMENTATION_NAMES = {"impl", "implementation", "stft_impl", "osc_impl", "route", "backend",
                        "kernel_impl"}
IMPLEMENTATION_VALUES = {"pallas", "xla", "auto", "cuda", "triton", "cufft", "torch", "plain"}


def test_no_roofline_function_takes_an_implementation():
    public = [f for name, f in inspect.getmembers(roofline, inspect.isfunction)
              if f.__module__ == roofline.__name__ and not name.startswith("_")]
    assert len(public) >= 20
    for f in public:
        for p in inspect.signature(f).parameters.values():
            assert p.name not in IMPLEMENTATION_NAMES, (f.__name__, p.name)
            assert p.default not in IMPLEMENTATION_VALUES, (f.__name__, p.name, p.default)


def test_carries_the_jax_modules_public_functions():
    """Every public function of the JAX module has its counterpart, and
    ``osc_speed_of_light_s`` takes no ``achievable``."""
    jax_public = {name for name, f in inspect.getmembers(jax_roofline, inspect.isfunction)
                  if f.__module__ == jax_roofline.__name__ and not name.startswith("_")}
    assert jax_public <= set(dir(roofline))
    assert "achievable" not in inspect.signature(roofline.osc_speed_of_light_s).parameters
