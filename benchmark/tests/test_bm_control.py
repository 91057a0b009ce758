"""The control on the card at a small size: the plain reference computed
on TF32 in the program's place must come out not correct against the
float32 reference, held to the cells' limits (on the card at the cells'
own sizes: ``benchmark/controls/readings.py --mode tf32``)."""

from pathlib import Path

import pytest
import torch

from benchmark import judge, serve_cell, train_cell
from benchmark.registry import Registry
from benchmark.tests import tiny

REG = Registry(Path(__file__).resolve().parents[2])
WIDE = dict(n_harmonics=180, n_noise_filters=195, decoder_mlp_units=512, decoder_gru_units=512,
            reverb_length=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_tf32_control_fails_serving(card):
    ctx = tiny.cpu_context(dict(tiny.SERVE_MIX, slots=16, check_slots=4), seed=11, **WIDE)
    ctx.device = card
    nums = serve_cell.control(ctx, 200)
    assert not judge.verdict(nums, REG.limits("serve_tiny_n2048"))[0], nums


@pytest.mark.cuda
def test_tf32_control_fails_training(card):
    ctx = tiny.cpu_context(dict(tiny.TRAIN_MIX, batch=8, reference_rows=8), seed=11,
                           **dict(WIDE, example_duration=2.0, mss_ffts=[2048, 1024, 512, 256,
                                                                        128, 64]))
    ctx.device = card
    nums = train_cell.control(ctx, 0)
    nums.pop("worst")
    assert not judge.verdict(nums, REG.limits("train_tiny_b384"))[0], nums
