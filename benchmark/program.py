"""The system under test, built from the benchmark's weights: the port's
decoder and CREPE modules, made without initialising them and then
loaded with the seeded tensors (a copy each, so the reference keeps the
weights the program started from)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import Crepe

# the stage ranges the program opens (record_function) on each path
SERVE_STAGES = ("features", "controller", "oscillator", "noise", "reverb")
TRAIN_STAGES = ("controller", "oscillator_bank", "filtered_noise", "reverb",
                "loss", "backward", "optimizer")


def config(fields: dict) -> Config:
    """The program's Config from a configuration file's fields (its other
    keys, such as ``assumed``, are the benchmark's)."""
    names = {f.name for f in dataclasses.fields(Config)}
    return Config.from_dict({k: v for k, v in fields.items() if k in names})


def as_dict(conf: Config) -> dict:
    """The configuration as the reference and the counts read it, with its
    frames per example."""
    d = dataclasses.asdict(conf)
    d["frames"] = conf.frames_per_example
    return d


def decoder(conf: Config, w: Dict[str, torch.Tensor], device) -> Decoder:
    with torch.device("meta"):
        module = Decoder(conf)
    module = module.to_empty(device=device)
    module.load_state_dict(w)
    return module


def crepe(conf: Config, w: Dict[str, torch.Tensor], device) -> Crepe:
    with torch.device("meta"):
        module = Crepe(conf.crepe_capacity)
    module = module.to_empty(device=device)
    counters = {f"conv{i}_BN.num_batches_tracked": torch.zeros((), dtype=torch.long)
                for i in range(1, 7)}
    module.load_state_dict({**w, **counters})
    return module.eval()
