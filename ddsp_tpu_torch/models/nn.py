"""Dense + LayerNorm MLP blocks and a torch-gate-order GRU.

Counterpart of ``ddsp_tpu/models/nn.py``.  Parameter names follow the
reference Decoder's state dict (``ddsp_tpu/models/torch_export.py``):
an MLP's layer ``i`` is ``mlp_layer{i}.0`` (Linear) and ``mlp_layer{i}.1``
(LayerNorm); the GRU keeps ``torch.nn.GRU``'s ``weight_ih_l{k}``,
``weight_hh_l{k}``, ``bias_ih_l{k}`` and ``bias_hh_l{k}`` with gates
ordered (reset, update, new).

``MLP.forward(x, compute_dtype)`` with a low-precision dtype rounds as the
JAX package's ``mlp_apply(dtype=...)`` does once XLA has compiled it
(``ddsp_tpu/models/nn.py:40-56``, under ``jax.jit`` as its train step and
decoders run): x, the weight, the bias and the product, and the dense
sum; the LayerNorm's statistics are float32 sums of the sum before its
rounding, rounded; the variance plus the rounded epsilon, and its rsqrt,
are rounded; the centred value is rounded, and its product with the
rsqrt stays float32 into the float32 weight multiply (XLA drops the
round trips it may, ``xla_allow_excess_precision``).  Op by op, without
``jit``, JAX rounds after every bf16 operation instead, which moves the
controls by as much as bf16 against float32 does.  ``count_params`` counts a
module's state as the JAX package's pytree holds it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def compute_dtype_of(name: str) -> Optional[torch.dtype]:
    """A config's dtype name -> the torch dtype to round to, or None for
    'float32' (no rounding), as the JAX package maps it."""
    return None if name == "float32" else getattr(torch, name)


class MLP(nn.Module):
    """N x [Linear -> LayerNorm(eps 1e-5) -> LeakyReLU(0.01)]
    (reference decoder.py:9-38)."""

    def __init__(self, n_in: int, n_units: int, n_layers: int):
        super().__init__()
        for i in range(n_layers):
            self.add_module(
                f"mlp_layer{i + 1}",
                nn.Sequential(
                    nn.Linear(n_in if i == 0 else n_units, n_units),
                    nn.LayerNorm(n_units, eps=1e-5),
                    nn.LeakyReLU(0.01),
                ),
            )

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        for layer in self.children():
            x = layer(x) if compute_dtype is None else _layer_lowp(layer, x, compute_dtype)
        return x


def _layer_lowp(layer: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One MLP layer with the roundings to ``dtype`` of the JAX package's
    compiled ``mlp_apply``: each value is computed in float32 and rounded
    where XLA's compiled form rounds it."""
    linear, norm, act = layer

    def r(t):
        return t.to(dtype).float()

    pre = r(r(x) @ r(linear.weight).T) + r(linear.bias)  # the sum, before its rounding
    mean = pre.mean(dim=-1, keepdim=True)
    var = r(((pre - mean) ** 2).mean(dim=-1, keepdim=True))
    eps = torch.tensor(norm.eps, dtype=dtype).item()  # JAX adds eps in the low dtype
    inv = r(torch.rsqrt(r(var + eps)))
    return act(r(r(pre) - r(mean)) * inv * norm.weight + norm.bias)


def count_params(module: nn.Module) -> int:
    """Elements of the state the JAX package keeps in its parameter pytree
    (its ``count_params``): every parameter and every floating-point buffer
    (CREPE's BatchNorm statistics), not ``num_batches_tracked``."""
    return sum(t.numel() for t in (*module.parameters(), *module.buffers())
               if t.is_floating_point())


def gru_cell(
    w_hh: torch.Tensor, b_hh: torch.Tensor, h: torch.Tensor, gi: torch.Tensor
) -> torch.Tensor:
    """One torch-semantics GRU update from the input projection
    ``gi = x W_ih^T + b_ih``.  h: (B, H), gi: (B, 3H)."""
    gh = h @ w_hh.T + b_hh
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


class GRU(nn.Module):
    """Stacked GRU, batch first, ``torch.nn.GRU`` parameterisation."""

    def __init__(self, n_in: int, n_hidden: int, n_layers: int = 1):
        super().__init__()
        self.n_hidden = n_hidden
        self.n_layers = n_layers
        bound = 1.0 / math.sqrt(n_hidden)
        for k in range(n_layers):
            fan_in = n_in if k == 0 else n_hidden
            for name, shape in (
                (f"weight_ih_l{k}", (3 * n_hidden, fan_in)),
                (f"weight_hh_l{k}", (3 * n_hidden, n_hidden)),
                (f"bias_ih_l{k}", (3 * n_hidden,)),
                (f"bias_hh_l{k}", (3 * n_hidden,)),
            ):
                p = nn.Parameter(torch.empty(shape))
                nn.init.uniform_(p, -bound, bound)
                self.register_parameter(name, p)

    def forward(
        self, x: torch.Tensor, h0: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, in), h0: (layers, B, H) or None for zeros ->
        (outputs (B, T, H), advanced hidden (layers, B, H))."""
        b, t, _ = x.shape
        if h0 is None:
            h0 = x.new_zeros((self.n_layers, b, self.n_hidden))
        finals = []
        seq = x
        for k in range(self.n_layers):
            # every step's input projection in one matmul; only the
            # hidden-to-hidden recurrence is sequential
            gi = seq @ getattr(self, f"weight_ih_l{k}").T + getattr(
                self, f"bias_ih_l{k}"
            )
            w_hh = getattr(self, f"weight_hh_l{k}")
            b_hh = getattr(self, f"bias_hh_l{k}")
            h = h0[k]
            outs = []
            for i in range(t):
                h = gru_cell(w_hh, b_hh, h, gi[:, i])
                outs.append(h)
            seq = torch.stack(outs, dim=1)
            finals.append(h)
        return seq, torch.stack(finals)
