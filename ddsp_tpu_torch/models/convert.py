"""Weight carry-over into the port's modules.

* ``decoder_from_jax`` / ``crepe_from_jax`` / ``autoencoder_from_jax`` /
  ``extractor_from_jax`` (the style-transfer conv) take the JAX
  package's parameter trees as numpy arrays
  (``jax.tree.map(np.asarray, params)``, done by the caller so this
  package never imports jax), and the ``*_to_jax`` functions give the
  modules back in that layout, so a test can compare parameters after a
  training or finetune step;
* ``decoder_from_state_dict`` / ``load_lightning_decoder`` read the
  reference Decoder layout, which ``ddsp_tpu/models/torch_export.py`` and
  ``models/lightning_export.py`` write and the reference's Lightning
  checkpoints hold; ``find_latest_lightning_checkpoint`` finds the newest
  of them in a ``lightning_logs`` tree;
* ``decoder_from_orbax`` reads the decoder of a ``step_*`` directory that
  the JAX package's trainer wrote with Orbax, through ``tensorstore``
  alone (imported at the call; no jax or orbax).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Mapping, Tuple

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


def find_latest_lightning_checkpoint(logs_dir: str, version: int) -> str:
    """Newest ``*.ckpt`` under ``lightning_logs/version_N/checkpoints``, by
    the epoch number in its file name (reference rt/utils.py:8-16)."""
    pattern = os.path.join(logs_dir, f"version_{version}", "checkpoints", "*.ckpt")
    files = glob.glob(pattern)
    if not files:
        raise FileNotFoundError(pattern)

    def epoch_of(f):
        m = re.search(r"epoch=(\d+)", os.path.basename(f))
        return int(m.group(1)) if m else -1

    return max(files, key=epoch_of)


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a ``step_*`` directory written by Orbax (the JAX
    package's trainer, ``ddsp_tpu/training/trainer.py:373-443``)."""
    return any(os.path.exists(os.path.join(path, f)) for f in ("_METADATA", "manifest.ocdbt"))


def _orbax_leaves(path: str) -> Tuple[List[List[str]], bool]:
    """The key path of every leaf in an Orbax checkpoint's ``_METADATA``,
    and whether its arrays are zarr3."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise FileNotFoundError(
            f"{path}: an Orbax checkpoint of the JAX package whose _METADATA lists no "
            "arrays (an unfinished save, or not its trainer's)")
    return [[str(k["key"]) for k in leaf["key_metadata"]]
            for leaf in meta["tree_metadata"].values()], bool(meta.get("use_zarr3"))


def decoder_from_orbax(path: str, conf: Config) -> Decoder:
    """The decoder of a JAX-package Orbax checkpoint directory -> :class:`Decoder`.

    Each leaf under ``params`` (or ``params.decoder``, a finetune
    checkpoint's) is read with ``tensorstore`` from the directory's OCDBT
    store, under its key path joined with ``.``; the tree then goes through
    :func:`decoder_from_jax`.  The optimizer state, step and key are not
    read (the JAX package's ``reconstruct.load_decoder_params`` reads only
    the parameters too).  Raises ImportError naming ``tensorstore`` when it
    is not installed."""
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            f"{path} is an Orbax checkpoint of the JAX package: reading it needs the "
            "'tensorstore' package, which is not installed") from e
    leaves, zarr3 = _orbax_leaves(path)
    finetuned = any(k[:2] == ["params", "decoder"] for k in leaves)
    prefix = ["params", "decoder"] if finetuned else ["params"]
    tree: Dict = {}
    base = "file://" + os.path.abspath(path)
    for keys in leaves:
        if keys[: len(prefix)] != prefix:
            continue
        spec = {"driver": "zarr3" if zarr3 else "zarr",
                "kvstore": {"driver": "ocdbt", "base": base, "path": ".".join(keys)}}
        value = tensorstore.open(spec).result().read().result()
        node = tree
        for k in keys[len(prefix):-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(value)
    if "controller" not in tree or "reverb" not in tree:
        raise KeyError(f"{path}: no decoder parameters under {'.'.join(prefix)}")

    def lists(node):  # {'0': a, '1': b} -> [a, b]: the tree's sequences
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return decoder_from_jax(lists(tree), conf)


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


def extractor_from_jax(np_tree: Dict) -> Dict[str, torch.Tensor]:
    """The style-transfer extractor of ``ddsp_tpu/experiments/
    style_transfer.extractor_init``, ``{'weight': (features, channels,
    kernel)}`` with a numpy leaf -> the port's ``{'weight': tensor}``."""
    return {"weight": _t(np_tree["weight"])}


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
