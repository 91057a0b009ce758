"""Seeded weights, made on the device in one draw, named as the reference
implementation's state dicts name them (kureta/ddsp-pytorch's Decoder,
CREPE's converted ``.pth``), so the same tensors load into the program's
modules and feed the plain reference.

The distributions are torch's default initialisations of each layer:
uniform within 1/sqrt(fan in) for linear and convolution weights and
biases, and for every GRU tensor within 1/sqrt(hidden); LayerNorm at unit
scale and zero shift; BatchNorm at its identity statistics; the reverb's
noise uniform in [-1, 1), its decay 5 and its wet logit 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, bound) for a uniform draw in [-bound, bound), or
# (name, shape, None, value) for a constant
Leaf = Tuple


def _linear(name: str, n_in: int, n_out: int) -> List[Leaf]:
    b = 1.0 / math.sqrt(n_in)
    return [(f"{name}.weight", (n_out, n_in), b), (f"{name}.bias", (n_out,), b)]


def _mlp(name: str, n_in: int, units: int, layers: int) -> List[Leaf]:
    out = []
    for i in range(layers):
        out += _linear(f"{name}.mlp_layer{i + 1}.0", n_in if i == 0 else units, units)
        out += [(f"{name}.mlp_layer{i + 1}.1.weight", (units,), None, 1.0),
                (f"{name}.mlp_layer{i + 1}.1.bias", (units,), None, 0.0)]
    return out


def decoder_layout(conf: dict) -> List[Leaf]:
    """The decoder's leaves: controller (two input MLPs, GRU, MLP, three
    heads) and reverb, as ``Decoder.state_dict`` names them."""
    u, layers, g = conf["decoder_mlp_units"], conf["decoder_mlp_layers"], conf["decoder_gru_units"]
    ir = conf["reverb_length"] or conf["sample_rate"]
    out = _mlp("controller.mlp_f0", 1, u, layers) + _mlp("controller.mlp_loudness", 1, u, layers)
    bg = 1.0 / math.sqrt(g)
    for k in range(conf["decoder_gru_layers"]):
        fan_in = 2 * u if k == 0 else g
        out += [(f"controller.gru.weight_ih_l{k}", (3 * g, fan_in), bg),
                (f"controller.gru.weight_hh_l{k}", (3 * g, g), bg),
                (f"controller.gru.bias_ih_l{k}", (3 * g,), bg),
                (f"controller.gru.bias_hh_l{k}", (3 * g,), bg)]
    out += _mlp("controller.mlp_gru", g + 2 * u, u, layers)
    out += _linear("controller.dense_harmonic", u, conf["n_harmonics"])
    out += _linear("controller.dense_loudness", u, 1)
    out += _linear("controller.dense_filter", u, conf["n_noise_filters"])
    out += [("reverb.noise", (ir,), 1.0), ("reverb.decay", (), None, 5.0),
            ("reverb.wet", (), None, 0.0)]
    return out


# CREPE (Kim et al. 2018) at its two published capacities: six conv stages
# (kernel 512 stride 4, then kernel 64) and a 360-bin classifier
CREPE_CHANNELS = {
    "tiny": [1, 128, 16, 16, 16, 32, 64],
    "full": [1, 1024, 128, 128, 128, 256, 512],
}
CREPE_KERNELS = [512, 64, 64, 64, 64, 64]


def crepe_layout(capacity: str) -> List[Leaf]:
    ch = CREPE_CHANNELS[capacity]
    out = []
    for i in range(6):
        b = 1.0 / math.sqrt(ch[i] * CREPE_KERNELS[i])
        out += [(f"conv{i + 1}.weight", (ch[i + 1], ch[i], CREPE_KERNELS[i]), b),
                (f"conv{i + 1}.bias", (ch[i + 1],), b),
                (f"conv{i + 1}_BN.weight", (ch[i + 1],), None, 1.0),
                (f"conv{i + 1}_BN.bias", (ch[i + 1],), None, 0.0),
                (f"conv{i + 1}_BN.running_mean", (ch[i + 1],), None, 0.0),
                (f"conv{i + 1}_BN.running_var", (ch[i + 1],), None, 1.0)]
    out += _linear("classifier", 4 * ch[6], 360)
    return out


def make(layout: List[Leaf], seed: int, device, salt: int) -> Dict[str, torch.Tensor]:
    """The leaves of ``layout`` from one uniform draw of a generator on
    ``device`` seeded by (``seed``, ``salt``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    n = sum(math.prod(leaf[1]) for leaf in layout if leaf[2] is not None)
    draw = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for leaf in layout:
        name, shape, bound = leaf[:3]
        if bound is None:
            out[name] = torch.full(shape, float(leaf[3]), device=device)
        else:
            size = math.prod(shape)
            out[name] = (draw[at:at + size] * bound).reshape(shape)
            at += size
    return out


def decoder_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make(decoder_layout(conf), seed, device, salt=1)


def crepe_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make(crepe_layout(conf["crepe_capacity"]), seed, device, salt=2)
