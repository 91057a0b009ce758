"""Weight carry-over into the port's modules.

* ``decoder_from_jax`` / ``crepe_from_jax`` / ``autoencoder_from_jax``
  take the JAX package's parameter trees as numpy arrays
  (``jax.tree.map(np.asarray, params)``, done by the caller so this
  package never imports jax), and the ``*_to_jax`` functions give the
  modules back in that layout, so a test can compare parameters after a
  training or finetune step;
* ``decoder_from_state_dict`` / ``load_lightning_decoder`` read the
  reference Decoder layout, which ``ddsp_tpu/models/torch_export.py``
  writes and the reference's Lightning checkpoints hold.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import CAPACITIES, Crepe


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def decoder_from_state_dict(sd: Mapping[str, torch.Tensor], conf: Config) -> Decoder:
    """Reference Decoder state dict -> :class:`Decoder`.

    Keys the Decoder does not learn (``harmonics.*``, ``reverb.t``,
    ``reverb.buffer``) are ignored; a missing learned key raises."""
    model = Decoder(conf)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"decoder state dict lacks {missing}")
    model.load_state_dict(
        {k: torch.as_tensor(sd[k], dtype=torch.float32) for k in own}
    )
    return model.eval()


def load_lightning_decoder(path: str, conf: Config) -> Decoder:
    """A Lightning ``.ckpt`` (keys under ``state_dict`` with a ``model.``
    prefix) or a bare Decoder state dict file -> :class:`Decoder`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    return decoder_from_state_dict(
        {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()},
        conf,
    )


def decoder_from_jax(np_tree: Dict, conf: Config) -> Decoder:
    """ddsp_tpu decoder tree ``{'controller': ..., 'reverb': ...}`` with
    numpy leaves -> :class:`Decoder`."""
    ctrl = np_tree["controller"]
    sd: Dict[str, torch.Tensor] = {}

    def put_mlp(prefix: str, mlp: Dict) -> None:
        for i, layer in enumerate(mlp["layers"], start=1):
            sd[f"{prefix}.mlp_layer{i}.0.weight"] = _t(layer["dense"]["weight"])
            sd[f"{prefix}.mlp_layer{i}.0.bias"] = _t(layer["dense"]["bias"])
            sd[f"{prefix}.mlp_layer{i}.1.weight"] = _t(layer["norm"]["weight"])
            sd[f"{prefix}.mlp_layer{i}.1.bias"] = _t(layer["norm"]["bias"])

    put_mlp("controller.mlp_f0", ctrl["mlp_f0"])
    put_mlp("controller.mlp_loudness", ctrl["mlp_loudness"])
    for k, layer in enumerate(ctrl["gru"]["layers"]):
        sd[f"controller.gru.weight_ih_l{k}"] = _t(layer["w_ih"])
        sd[f"controller.gru.weight_hh_l{k}"] = _t(layer["w_hh"])
        sd[f"controller.gru.bias_ih_l{k}"] = _t(layer["b_ih"])
        sd[f"controller.gru.bias_hh_l{k}"] = _t(layer["b_hh"])
    put_mlp("controller.mlp_gru", ctrl["mlp_gru"])
    for head in ("dense_harmonic", "dense_loudness", "dense_filter"):
        sd[f"controller.{head}.weight"] = _t(ctrl[head]["weight"])
        sd[f"controller.{head}.bias"] = _t(ctrl[head]["bias"])
    for leaf in ("noise", "decay", "wet"):
        sd[f"reverb.{leaf}"] = _t(np_tree["reverb"][leaf])
    return decoder_from_state_dict(sd, conf)


def decoder_to_jax(decoder: Decoder) -> Dict:
    """:class:`Decoder` -> ddsp_tpu decoder tree ``{'controller': ...,
    'reverb': ...}`` with numpy leaves: the inverse of
    :func:`decoder_from_jax`."""
    sd = {k: v.detach().cpu().numpy() for k, v in decoder.state_dict().items()}

    def mlp(prefix: str) -> Dict:
        layers, i = [], 1
        while f"{prefix}.mlp_layer{i}.0.weight" in sd:
            layers.append({
                "dense": {"weight": sd[f"{prefix}.mlp_layer{i}.0.weight"],
                          "bias": sd[f"{prefix}.mlp_layer{i}.0.bias"]},
                "norm": {"weight": sd[f"{prefix}.mlp_layer{i}.1.weight"],
                         "bias": sd[f"{prefix}.mlp_layer{i}.1.bias"]},
            })
            i += 1
        return {"layers": layers}

    gru, k = [], 0
    while f"controller.gru.weight_ih_l{k}" in sd:
        gru.append({
            "w_ih": sd[f"controller.gru.weight_ih_l{k}"],
            "w_hh": sd[f"controller.gru.weight_hh_l{k}"],
            "b_ih": sd[f"controller.gru.bias_ih_l{k}"],
            "b_hh": sd[f"controller.gru.bias_hh_l{k}"],
        })
        k += 1
    ctrl = {
        "mlp_f0": mlp("controller.mlp_f0"),
        "mlp_loudness": mlp("controller.mlp_loudness"),
        "gru": {"layers": gru},
        "mlp_gru": mlp("controller.mlp_gru"),
    }
    for head in ("dense_harmonic", "dense_loudness", "dense_filter"):
        ctrl[head] = {"weight": sd[f"controller.{head}.weight"],
                      "bias": sd[f"controller.{head}.bias"]}
    return {
        "controller": ctrl,
        "reverb": {leaf: sd[f"reverb.{leaf}"] for leaf in ("noise", "decay", "wet")},
    }


def crepe_from_jax(np_tree: Dict) -> Crepe:
    """ddsp_tpu CREPE tree ``{'layers': [...], 'classifier': ...}`` with
    numpy leaves -> :class:`Crepe` (capacity read from the widths)."""
    layers = np_tree["layers"]
    first_out = np.shape(layers[0]["weight"])[0]
    capacity = next(
        name for name, spec in CAPACITIES.items()
        if spec["out_channels"][0] == first_out
    )
    model = Crepe(capacity)
    sd = {}
    for i, layer in enumerate(layers, start=1):
        sd[f"conv{i}.weight"] = _t(layer["weight"])
        sd[f"conv{i}.bias"] = _t(layer["bias"])
        bn = layer["bn"]
        sd[f"conv{i}_BN.weight"] = _t(bn["weight"])
        sd[f"conv{i}_BN.bias"] = _t(bn["bias"])
        sd[f"conv{i}_BN.running_mean"] = _t(bn["mean"])
        sd[f"conv{i}_BN.running_var"] = _t(bn["var"])
    sd["classifier.weight"] = _t(np_tree["classifier"]["weight"])
    sd["classifier.bias"] = _t(np_tree["classifier"]["bias"])
    result = model.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"CREPE tree mismatch: {missing} {result.unexpected_keys}")
    return model.eval()


def crepe_to_jax(crepe: Crepe) -> Dict:
    """:class:`Crepe` -> ddsp_tpu CREPE tree ``{'layers': [...],
    'classifier': ...}`` with numpy leaves: the inverse of
    :func:`crepe_from_jax` (BatchNorm statistics as ``mean`` / ``var``)."""
    sd = {k: v.detach().cpu().numpy() for k, v in crepe.state_dict().items()}
    layers = [
        {
            "weight": sd[f"conv{i}.weight"],
            "bias": sd[f"conv{i}.bias"],
            "bn": {
                "weight": sd[f"conv{i}_BN.weight"],
                "bias": sd[f"conv{i}_BN.bias"],
                "mean": sd[f"conv{i}_BN.running_mean"],
                "var": sd[f"conv{i}_BN.running_var"],
            },
        }
        for i in range(1, 7)
    ]
    return {
        "layers": layers,
        "classifier": {"weight": sd["classifier.weight"], "bias": sd["classifier.bias"]},
    }


def autoencoder_from_jax(np_tree: Dict, conf: Config) -> nn.ModuleDict:
    """ddsp_tpu autoencoder tree ``{'decoder', 'crepe'}`` with numpy
    leaves -> ``nn.ModuleDict`` of :class:`Decoder` and :class:`Crepe`."""
    return nn.ModuleDict({
        "decoder": decoder_from_jax(np_tree["decoder"], conf),
        "crepe": crepe_from_jax(np_tree["crepe"]),
    })


def autoencoder_to_jax(params) -> Dict:
    """``{'decoder', 'crepe'}`` modules -> the ddsp_tpu autoencoder tree
    with numpy leaves: the inverse of :func:`autoencoder_from_jax`."""
    return {
        "decoder": decoder_to_jax(params["decoder"]),
        "crepe": crepe_to_jax(params["crepe"]),
    }
