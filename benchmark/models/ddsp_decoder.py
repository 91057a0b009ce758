"""kureta/ddsp-pytorch's DDSP decoder as the port runs it: the controller
(f0 and loudness MLPs, a GRU, an MLP, three heads) and the reverb, behind
CREPE when served.  The interface is in ``benchmark/models/__init__.py``.

Training: ``trainer.make_train_step`` on the decoder, from Adam's first
state, on the mix's seeded batches of tones and their features; the plain
reference takes the same first steps (``reference/train.steps``).
Serving: ``MultiStreamServer`` over the decoder and CREPE; the reference
replays the sampled slots (``reference/serve.replay``), following the f0
and the oscillator phase the server served.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List

import torch

from benchmark import counts, traffic, weights
from benchmark.reference import serve as rserve
from benchmark.reference import threefry
from benchmark.reference import train as rtrain
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import Crepe

# the stage ranges the program opens (record_function) on each path
STAGES = {
    "serve": ("features", "controller", "oscillator", "noise", "reverb"),
    "train": ("controller", "oscillator_bank", "filtered_noise", "reverb", "loss", "backward",
              "optimizer"),
}

# CREPE (Kim et al. 2018) at its two published capacities: six conv stages
# (kernel 512 stride 4, then kernel 64) and a 360-bin classifier
CREPE_CHANNELS = {
    "tiny": [1, 128, 16, 16, 16, 32, 64],
    "full": [1, 1024, 128, 128, 128, 256, 512],
}
CREPE_KERNELS = [512, 64, 64, 64, 64, 64]

ADAM_B1 = 0.9  # the program's Adam, as optax's: mu = (1 - b1) g after one step


def config(fields: dict) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    return Config.from_dict({k: v for k, v in fields.items() if k in names})


def as_dict(conf: Config) -> dict:
    d = dataclasses.asdict(conf)
    d["frames"] = conf.frames_per_example
    return d


def device(name: str) -> torch.device:
    """TF32 off on the card: the configuration computes in float32."""
    return resolve_device(name)


# --- weights -----------------------------------------------------------------

def decoder_layout(conf: dict) -> List[weights.Leaf]:
    """The decoder's leaves: controller (two input MLPs, GRU, MLP, three
    heads) and reverb (its noise uniform in [-1, 1), decay 5, wet logit 0),
    as ``Decoder.state_dict`` names them."""
    u, layers, g = conf["decoder_mlp_units"], conf["decoder_mlp_layers"], conf["decoder_gru_units"]
    ir = conf["reverb_length"] or conf["sample_rate"]
    out = (weights.mlp("controller.mlp_f0", 1, u, layers)
           + weights.mlp("controller.mlp_loudness", 1, u, layers))
    bg = 1.0 / math.sqrt(g)
    for k in range(conf["decoder_gru_layers"]):
        fan_in = 2 * u if k == 0 else g
        out += [(f"controller.gru.weight_ih_l{k}", (3 * g, fan_in), bg),
                (f"controller.gru.weight_hh_l{k}", (3 * g, g), bg),
                (f"controller.gru.bias_ih_l{k}", (3 * g,), bg),
                (f"controller.gru.bias_hh_l{k}", (3 * g,), bg)]
    out += weights.mlp("controller.mlp_gru", g + 2 * u, u, layers)
    out += weights.linear("controller.dense_harmonic", u, conf["n_harmonics"])
    out += weights.linear("controller.dense_loudness", u, 1)
    out += weights.linear("controller.dense_filter", u, conf["n_noise_filters"])
    out += [("reverb.noise", (ir,), 1.0), ("reverb.decay", (), None, 5.0),
            ("reverb.wet", (), None, 0.0)]
    return out


def crepe_layout(capacity: str) -> List[weights.Leaf]:
    """CREPE's leaves as its converted ``.pth`` names them."""
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
    return out + weights.linear("classifier", 4 * ch[6], 360)


def decoder_weights(conf: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make(decoder_layout(conf), seed, dev, salt=weights.SALTS["decoder"])


def crepe_weights(conf: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make(crepe_layout(conf["crepe_capacity"]), seed, dev,
                        salt=weights.SALTS["crepe"])


# --- the program, from the weights -------------------------------------------
# made without initialising, then loaded with a copy of the seeded tensors,
# so the reference keeps the weights the program started from

def decoder(conf: Config, w: Dict[str, torch.Tensor], dev) -> Decoder:
    with torch.device("meta"):
        module = Decoder(conf)
    module = module.to_empty(device=dev)
    module.load_state_dict(w)
    return module


def crepe(conf: Config, w: Dict[str, torch.Tensor], dev) -> Crepe:
    with torch.device("meta"):
        module = Crepe(conf.crepe_capacity)
    module = module.to_empty(device=dev)
    counters = {f"conv{i}_BN.num_batches_tracked": torch.zeros((), dtype=torch.long)
                for i in range(1, 7)}
    module.load_state_dict({**w, **counters})
    return module.eval()


# --- training ----------------------------------------------------------------

def _norms(named) -> Dict[str, float]:
    return {k: math.sqrt(float((v.detach().double() ** 2).sum())) for k, v in named}


def train_inputs(ctx) -> SimpleNamespace:
    cd, dev = ctx.cd, ctx.device
    return SimpleNamespace(start=decoder_weights(cd, ctx.seed, dev),
                           batches=traffic.training_batches(ctx.mix, cd, ctx.seed, dev),
                           key=threefry.seed_key(ctx.seed, dev))


def train_program(ctx, inputs) -> SimpleNamespace:
    """The decoder's step of ``trainer.make_train_step`` with its Adam, on
    the mix's loss STFT route."""
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    set_stft_impl(ctx.mix["stft_impl"])
    params = decoder(ctx.conf, inputs.start, ctx.device)
    step = trainer.make_train_step(ctx.conf)
    opt = trainer.make_optimizer(ctx.conf)
    state = trainer.TrainState(0, params, opt.init(list(params.parameters())), inputs.key.clone())
    return SimpleNamespace(step=step, state=state, params=params)


def train_grad(program, state) -> Dict[str, float]:
    """From Adam's first moment after one step."""
    names = [k for k, _ in program.params.named_parameters()]
    return _norms((k, mu / (1 - ADAM_B1)) for k, mu in zip(names, state.opt_state.adam.mu))


def train_change(program, inputs) -> Dict[str, float]:
    return _norms((k, p - inputs.start[k]) for k, p in program.params.named_parameters())


def train_counts(ctx) -> dict:
    cd, b = ctx.cd, int(ctx.mix["batch"])
    hop = cd["hop_length"]
    return {
        "unit_flops": counts.train_step_flops(cd, b, finetune=False),
        "osc_bound_s": counts.osc_forward_bound_s(b, cd["frames"], hop, cd["n_harmonics"]),
        "loss_bound_s": counts.mss_forward_bound_s(cd, b, cd["frames"] * hop),
    }


def train_reference(ctx, inputs, block_loss=rtrain.block_loss) -> dict:
    """``block_loss``: the reference's loss over a block of rows (a model
    that extends the decoder passes its own)."""
    n = int(ctx.mix["check_steps"])
    ref = rtrain.steps(inputs.start, ctx.cd, inputs.batches[:n], inputs.key,
                       block=int(ctx.mix["reference_rows"]), block_loss=block_loss)
    return {"loss": ref["loss"], "grad1": rtrain.leaf_norms(ref["grad1"]),
            "change": rtrain.leaf_norms(ref["change"])}


def train_release(ctx) -> None:
    from ddsp_tpu_torch.ops.spectral import set_stft_impl

    set_stft_impl("auto")


# --- serving -----------------------------------------------------------------

def serve_inputs(ctx) -> SimpleNamespace:
    cd, dev = ctx.cd, ctx.device
    return SimpleNamespace(decoder=decoder_weights(cd, ctx.seed, dev),
                           crepe=crepe_weights(cd, ctx.seed, dev))


def serve_program(ctx, inputs):
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer

    conf, dev = ctx.conf, ctx.device
    return MultiStreamServer(decoder(conf, inputs.decoder, dev), crepe(conf, inputs.crepe, dev),
                             conf, int(ctx.mix["slots"]), noise_seed=ctx.seed, device=dev)


def serve_traffic(ctx):
    return traffic.serving_loop(ctx.mix, ctx.cd, ctx.seed, ctx.device).cpu().numpy()


def serve_kept(server):
    """The f0 the server served and its oscillator's phase after the call."""
    return server.state.cur["f0"], server.state.phase


def serve_followed(kept, slots) -> Dict[str, torch.Tensor]:
    return {"f0": torch.stack([f[slots, 0, 0] for f, _ in kept], 1),
            "phase": torch.stack([p[slots] for _, p in kept], 1)}


def serve_counts(ctx) -> dict:
    cd, n = ctx.cd, int(ctx.mix["slots"])
    tail = math.ceil(rserve.CREPE_WINDOW * cd["sample_rate"] / rserve.CREPE_RATE) + 64
    return {"unit_flops": counts.serve_hop_flops(cd, n),
            "features_bound_s": counts.features_bound_s(cd, n, tail)}


def serve_reference(ctx, inputs, blocks, followed, slots) -> dict:
    f0, phase = (None, None) if followed is None else (followed["f0"], followed["phase"])
    return rserve.replay(inputs.decoder, inputs.crepe, ctx.cd, blocks, f0, phase, ctx.seed, slots)
