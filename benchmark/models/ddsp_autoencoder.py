"""The DDSP autoencoder with a learned z(t) (Engel et al. 2020; magenta/ddsp
``ae.gin``) as the port runs it: a decoder built with ``z_dims`` above 0,
whose z encoder (MFCCs, instance norm, a GRU, a dense layer) runs inside
the train step on the batch's audio, under the gradient.  The interface is
in ``benchmark/models/__init__.py``; it is trained, not served.

Training: ``trainer.make_train_step`` on that decoder, from Adam's first
state, on the mix's seeded batches of tones and their features; the plain
reference (``reference/autoencoder.py``) takes the same first steps
(``reference/train.steps``).  The program's counter of the GRU's gate
launches (``ops/cuda/gru.FWD_LAUNCHES``) is read over every step the
program took, for ``gru_steps_per_step.train``.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List

import torch

from benchmark import counts, traffic, weights
from benchmark.models import ddsp_decoder as base
from benchmark.models.ddsp_decoder import (  # noqa: F401  (this model's interface)
    device, train_change, train_grad, train_release)
from benchmark.reference import autoencoder as rae
from benchmark.reference import threefry
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder

STAGES = {"train": ("z_encoder", "controller", "oscillator_bank", "filtered_noise", "reverb",
                    "loss", "backward", "optimizer")}

# the seeded draw of the z encoder's leaves (weights.SALTS and traffic.py
# hold 1 to 4)
Z_SALT = 5
OWN_KEYS = ("model", "assumed", "published")


def config(fields: dict) -> Config:
    """Every field but the benchmark's own goes to ``Config.from_dict``,
    which refuses a key the program does not know."""
    return Config.from_dict({k: v for k, v in fields.items() if k not in OWN_KEYS})


def as_dict(conf: Config) -> dict:
    d = dataclasses.asdict(conf)
    d["frames"] = conf.frames_per_example
    return d


# --- weights -----------------------------------------------------------------

def decoder_layout(conf: dict) -> List[weights.Leaf]:
    """The controller's leaves (three input MLPs, the GRU over the three,
    its MLP, the heads) and the reverb's, as ``Decoder.state_dict`` names
    them."""
    u, layers, g = conf["decoder_mlp_units"], conf["decoder_mlp_layers"], conf["decoder_gru_units"]
    ir = conf["reverb_length"] or conf["sample_rate"]
    out = (weights.mlp("controller.mlp_f0", 1, u, layers)
           + weights.mlp("controller.mlp_loudness", 1, u, layers)
           + weights.mlp("controller.mlp_z", conf["z_dims"], u, layers)
           + gru_layout("controller.gru", 3 * u, g)
           + weights.mlp("controller.mlp_gru", g + 3 * u, u, layers)
           + weights.linear("controller.dense_harmonic", u, conf["n_harmonics"])
           + weights.linear("controller.dense_loudness", u, 1)
           + weights.linear("controller.dense_filter", u, conf["n_noise_filters"]))
    return out + [("reverb.noise", (ir,), 1.0), ("reverb.decay", (), None, 5.0),
                  ("reverb.wet", (), None, 0.0)]


def gru_layout(name: str, n_in: int, n_hidden: int) -> List[weights.Leaf]:
    b = 1.0 / math.sqrt(n_hidden)
    return [(f"{name}.weight_ih_l0", (3 * n_hidden, n_in), b),
            (f"{name}.weight_hh_l0", (3 * n_hidden, n_hidden), b),
            (f"{name}.bias_ih_l0", (3 * n_hidden,), b),
            (f"{name}.bias_hh_l0", (3 * n_hidden,), b)]


def z_layout(conf: dict) -> List[weights.Leaf]:
    """The z encoder's leaves: the norm's scale 1 and shift 0, the GRU, the
    dense layer to z."""
    m, h = rae.MFCC_BINS, conf["z_rnn_units"]
    return ([("z_encoder.norm_scale", (m,), None, 1.0), ("z_encoder.norm_shift", (m,), None, 0.0)]
            + gru_layout("z_encoder.gru", m, h)
            + weights.linear("z_encoder.dense_z", h, conf["z_dims"]))


def start_weights(conf: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return {**weights.make(decoder_layout(conf), seed, dev, salt=weights.SALTS["decoder"]),
            **weights.make(z_layout(conf), seed, dev, salt=Z_SALT)}


# --- training ----------------------------------------------------------------

def train_inputs(ctx) -> SimpleNamespace:
    cd, dev = ctx.cd, ctx.device
    return SimpleNamespace(start=start_weights(cd, ctx.seed, dev),
                           batches=traffic.training_batches(ctx.mix, cd, ctx.seed, dev),
                           key=threefry.seed_key(ctx.seed, dev))


def train_program(ctx, inputs) -> SimpleNamespace:
    """The autoencoder's step of ``trainer.make_train_step`` with its Adam,
    on the mix's loss STFT route; the step's calls counted beside the
    program's GRU launch counter."""
    from ddsp_tpu_torch.ops.cuda import gru
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    set_stft_impl(ctx.mix["stft_impl"])
    with torch.device("meta"):
        params = Decoder(ctx.conf)
    params = params.to_empty(device=ctx.device)
    params.load_state_dict(inputs.start)
    step = trainer.make_train_step(ctx.conf)
    opt = trainer.make_optimizer(ctx.conf)
    state = trainer.TrainState(0, params, opt.init(list(params.parameters())), inputs.key.clone())
    ctx.gru_count = SimpleNamespace(steps=0, launches=gru.FWD_LAUNCHES)

    def counted(state, batch):
        ctx.gru_count.steps += 1
        return step(state, batch)

    return SimpleNamespace(step=counted, state=state, params=params)


def controller_macs(b: int, t: int, conf: dict) -> int:
    """Matmul MACs of the three-stack controller over (b, t) frames."""
    u, layers, g = conf["decoder_mlp_units"], conf["decoder_mlp_layers"], conf["decoder_gru_units"]
    heads = conf["n_harmonics"] + 1 + conf["n_noise_filters"]

    def mlp(n_in):
        return n_in * u + (layers - 1) * u * u

    return b * t * (2 * mlp(1) + mlp(conf["z_dims"]) + 3 * u * 3 * g + g * 3 * g
                    + mlp(g + 3 * u) + u * heads)


def z_encoder_flops(b: int, conf: dict) -> float:
    """The z encoder's forward over ``b`` examples: the MFCC frames' real
    FFTs, the mel and DCT products, the GRU's products, the dense layer
    and the upsampling's two multiply-adds an output."""
    steps = conf["z_time_steps"]
    n = 2 * (conf["frames"] * conf["hop_length"] // steps)
    m, h, mels, z = rae.MFCC_BINS, conf["z_rnn_units"], rae.MEL_BINS, conf["z_dims"]
    macs = b * steps * ((n // 2 + 1) * mels + mels * m + (m + h) * 3 * h + h * z)
    return counts.fft_flops(b * steps, n) + 2 * macs + 4 * b * conf["frames"] * z


def forward_flops(conf: dict, b: int) -> float:
    """One forward at batch ``b`` and its loss: the z encoder, the
    controller, oscillator, noise, reverb and MSS (``counts.py``)."""
    t, hop = conf["frames"], conf["hop_length"]
    length = t * hop
    ir = conf["reverb_length"] or conf["sample_rate"]
    return (z_encoder_flops(b, conf) + 2 * controller_macs(b, t, conf)
            + counts.FLOP_PER_POINT * b * length * conf["n_harmonics"]
            + counts.noise_flops(b, t, conf)
            + counts.reverb_flops(b, length, ir)
            + counts.mss_forward_flops(b, length, conf["mss_ffts"], conf["mss_overlap"]))


def train_counts(ctx) -> dict:
    """The forward, the backward as twice it; the forward oscillator's and
    the loss forward's least seconds, as the decoder's; and the GRU gate
    launches a step the program's counter read (absent where the step
    launched none: the plain GRU on the CPU)."""
    from ddsp_tpu_torch.ops.cuda import gru

    cd, b = ctx.cd, int(ctx.mix["batch"])
    t, hop = cd["frames"], cd["hop_length"]
    out = {"unit_flops": 3 * forward_flops(cd, b),
           "osc_bound_s": counts.osc_forward_bound_s(b, t, hop, cd["n_harmonics"]),
           "loss_bound_s": counts.mss_forward_bound_s(cd, b, t * hop)}
    seen = getattr(ctx, "gru_count", None)
    if seen is not None and seen.steps and gru.FWD_LAUNCHES > seen.launches:
        out["gru_fwd_launches_per_step"] = (gru.FWD_LAUNCHES - seen.launches) / seen.steps
    return out


def train_reference(ctx, inputs) -> dict:
    return base.train_reference(ctx, inputs, block_loss=rae.block_loss)
