"""Seeded weights, made on the device in one draw, named as the reference
implementation's state dicts name them, so the same tensors load into the
program's modules and feed the plain reference.  A model's layout of
leaves is its own (``benchmark/models/<name>.py``); the draw, its salts and
the layers' initialisations are shared here.

The distributions are torch's default initialisations of each layer:
uniform within 1/sqrt(fan in) for linear and convolution weights and
biases, and for every GRU tensor within 1/sqrt(hidden); LayerNorm at unit
scale and zero shift; BatchNorm at its identity statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, bound) for a uniform draw in [-bound, bound), or
# (name, shape, None, value) for a constant
Leaf = Tuple

# the salt of each seeded draw, so that no two share a stream: a group of
# leaves a model adds takes a number of its own (``traffic.py`` draws the
# training batches with 3 and the serving loop with 4)
SALTS = {"decoder": 1, "crepe": 2}


def linear(name: str, n_in: int, n_out: int) -> List[Leaf]:
    b = 1.0 / math.sqrt(n_in)
    return [(f"{name}.weight", (n_out, n_in), b), (f"{name}.bias", (n_out,), b)]


def mlp(name: str, n_in: int, units: int, layers: int) -> List[Leaf]:
    """kureta/ddsp-pytorch's MLP: ``layers`` of Linear then LayerNorm."""
    out = []
    for i in range(layers):
        out += linear(f"{name}.mlp_layer{i + 1}.0", n_in if i == 0 else units, units)
        out += [(f"{name}.mlp_layer{i + 1}.1.weight", (units,), None, 1.0),
                (f"{name}.mlp_layer{i + 1}.1.bias", (units,), None, 0.0)]
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
