"""A second model for the benchmark's own tests, which add it to a copy of
the benchmark as ``benchmark/models/ddsp_f0lin.py``: the DDSP decoder
whose f0 input (the normalised cents) passes through one more seeded
``Linear(1, 1)``, the leaf ``f0_in``, before the controller, in the
program and in its reference alike.  Its training comes from
``ddsp_decoder`` but for the leaf; it is not served."""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from benchmark import traffic, weights
from benchmark.models import ddsp_decoder as base
from benchmark.models.ddsp_decoder import (  # noqa: F401  (this model's interface)
    STAGES, as_dict, config, device, train_change, train_counts, train_grad, train_release)
from benchmark.reference import threefry
from benchmark.reference import train as rtrain
from ddsp_tpu_torch.models.controller import Decoder, decoder_apply


class F0Decoder(Decoder):
    def __init__(self, conf):
        super().__init__(conf)
        self.f0_in = torch.nn.Linear(1, 1)


def _decode(params, batch, conf, noise_key):
    batch = dict(batch, normalized_cents=params.f0_in(batch["normalized_cents"]))
    return decoder_apply(params, batch, conf, noise_key)


def block_loss(wd, conf, batch, rows, noise_key):
    """The reference's loss with the leaf: the decoder's on f0_in(cents)."""
    cents = batch["normalized_cents"] * wd["f0_in.weight"][0, 0] + wd["f0_in.bias"][0]
    return rtrain.block_loss(wd, conf, dict(batch, normalized_cents=cents), rows, noise_key)


def train_inputs(ctx) -> SimpleNamespace:
    cd, dev = ctx.cd, ctx.device
    layout = base.decoder_layout(cd) + weights.linear("f0_in", 1, 1)
    return SimpleNamespace(start=weights.make(layout, ctx.seed, dev, salt=weights.SALTS["decoder"]),
                           batches=traffic.training_batches(ctx.mix, cd, ctx.seed, dev),
                           key=threefry.seed_key(ctx.seed, dev))


def train_program(ctx, inputs) -> SimpleNamespace:
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    set_stft_impl(ctx.mix["stft_impl"])
    with torch.device("meta"):
        params = F0Decoder(ctx.conf)
    params = params.to_empty(device=ctx.device)
    params.load_state_dict(inputs.start)
    step = trainer.make_train_step(ctx.conf, loss=functools.partial(trainer.loss_fn,
                                                                    decode=_decode))
    opt = trainer.make_optimizer(ctx.conf)
    state = trainer.TrainState(0, params, opt.init(list(params.parameters())), inputs.key.clone())
    return SimpleNamespace(step=step, state=state, params=params)


def train_reference(ctx, inputs) -> dict:
    return base.train_reference(ctx, inputs, block_loss=block_loss)
