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
  the JAX package's trainer wrote with Orbax (``models/orbax.py``: numpy
  and the system's libzstd; no tensorstore, orbax or jax), and
  ``train_state_from_jax`` turns the whole JAX train state (parameters,
  optax's Adam and plateau state, step, key) into the port's, so training
  resumes from such a directory.
"""

from __future__ import annotations

import copy
import glob
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import CAPACITIES, Crepe
from ddsp_tpu_torch.models.orbax import flatten, is_orbax_checkpoint, read_orbax  # noqa: F401 (re-exported)


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


def decoder_from_orbax(path: str, conf: Config) -> Decoder:
    """The decoder of a JAX-package Orbax checkpoint directory -> :class:`Decoder`.

    The leaves under ``params`` (or ``params.decoder``, a finetune
    checkpoint's) are read by ``models/orbax.read_orbax`` (numpy and the
    system's libzstd; no tensorstore, orbax or jax) and go through
    :func:`decoder_from_jax`.  The optimizer state, step and key are not
    read here (the JAX package's ``reconstruct.load_decoder_params`` reads
    only the parameters too); :func:`train_state_from_jax` takes them."""
    params = read_orbax(path, prefix=("params",)).get("params", {})
    tree = params.get("decoder", params)
    if not isinstance(tree, dict) or "controller" not in tree or "reverb" not in tree:
        raise KeyError(f"{path}: no decoder parameters under params or params.decoder")
    return decoder_from_jax(tree, conf)


def _refuse_z_module(decoder, what: str) -> None:
    if getattr(decoder, "z_encoder", None) is not None:
        raise ValueError(f"{what} does not support a z encoder: the JAX package's decoder "
                         "tree has no z leaves; use a decoder with z_dims=0")


def decoder_from_jax(np_tree: Dict, conf: Config) -> Decoder:
    """ddsp_tpu decoder tree ``{'controller': ..., 'reverb': ...}`` with
    numpy leaves -> :class:`Decoder`."""
    refuse_z(conf, "decoder_from_jax", "z leaves in the JAX package's decoder tree")
    return decoder_from_state_dict(_decoder_state_dict(np_tree), conf)


def _decoder_state_dict(np_tree: Dict) -> Dict[str, torch.Tensor]:
    """The decoder tree's leaves under the :class:`Decoder`'s state-dict
    names: the one layout map of the parameters and of Adam's moments."""
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
    return sd


def decoder_to_jax(decoder: Decoder) -> Dict:
    """:class:`Decoder` -> ddsp_tpu decoder tree ``{'controller': ...,
    'reverb': ...}`` with numpy leaves: the inverse of
    :func:`decoder_from_jax`."""
    _refuse_z_module(decoder, "decoder_to_jax")
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
    result = model.load_state_dict(_crepe_state_dict(np_tree), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"CREPE tree mismatch: {missing} {result.unexpected_keys}")
    return model.eval()


def _crepe_state_dict(np_tree: Dict) -> Dict[str, torch.Tensor]:
    """The CREPE tree's leaves under :class:`Crepe`'s state-dict names."""
    sd = {}
    for i, layer in enumerate(np_tree["layers"], start=1):
        sd[f"conv{i}.weight"] = _t(layer["weight"])
        sd[f"conv{i}.bias"] = _t(layer["bias"])
        bn = layer["bn"]
        sd[f"conv{i}_BN.weight"] = _t(bn["weight"])
        sd[f"conv{i}_BN.bias"] = _t(bn["bias"])
        sd[f"conv{i}_BN.running_mean"] = _t(bn["mean"])
        sd[f"conv{i}_BN.running_var"] = _t(bn["var"])
    sd["classifier.weight"] = _t(np_tree["classifier"]["weight"])
    sd["classifier.bias"] = _t(np_tree["classifier"]["bias"])
    return sd


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


def _at(tree, path: str):
    """``tree``'s node at the ``.``-joined ``path``; a KeyError names it."""
    node = tree
    for k in path.split("."):
        try:
            node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
        except (KeyError, IndexError, TypeError):
            raise KeyError(f"the JAX train state has no {path}") from None
    return node


def train_state_from_jax(np_tree: Dict, template):
    """The JAX trainer's whole ``TrainState`` with numpy leaves (what
    ``models/orbax.read_orbax`` gives for its checkpoint:
    ``{'params', 'opt_state', 'step', 'rng'}``) -> the port's
    ``training.trainer.TrainState`` on ``template``'s device.

    ``template`` is a port state of the same model: a decoder state
    (``init_state``) or a finetune state (``init_finetune_state``, CREPE's
    BatchNorm statistics made parameters).  Its parameters take the JAX
    parameters in place.  optax's ``ScaleByAdamState`` ``mu`` and ``nu``
    have the parameters' tree, so they go through the same layout map
    (:func:`_decoder_state_dict`, :func:`_crepe_state_dict`) and follow the
    order of ``template.params.parameters()``; ``count`` stays int32, the
    six ``ReduceLROnPlateauState`` fields keep the template's dtypes
    (``best_value`` may be inf), ``step`` becomes an int and the uint32[2]
    threefry key the port's (2,) int64 key, word for word.  A leaf missing
    on either side, or of another shape or dtype, raises and names it.
    """
    from ddsp_tpu_torch.training.trainer import AdamState, OptState, PlateauState, TrainState

    finetune = not isinstance(template.params, Decoder)
    _refuse_z_module(template.params["decoder"] if finetune else template.params,
                     "train_state_from_jax")
    want = {p: (np.shape(v), np.asarray(v).dtype) for p, v in flatten(
        (autoencoder_to_jax if finetune else decoder_to_jax)(template.params)).items()}

    def state_dict(where: str) -> Dict[str, torch.Tensor]:
        got = flatten(_at(np_tree, where))
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        if missing or extra:
            raise KeyError(f"{where}: leaves the JAX state lacks {[f'{where}.{p}' for p in missing]}, "
                           f"leaves the port's state lacks {[f'{where}.{p}' for p in extra]}")
        for p, (shape, dtype) in want.items():
            if (np.shape(got[p]), np.asarray(got[p]).dtype) != (shape, dtype):
                raise ValueError(f"{where}.{p}: {np.asarray(got[p]).dtype} of shape "
                                 f"{np.shape(got[p])} in the JAX state, {dtype} of shape "
                                 f"{shape} in the port's")
        tree = _at(np_tree, where)
        if not finetune:
            return _decoder_state_dict(tree)
        return {**{f"decoder.{k}": v for k, v in _decoder_state_dict(tree["decoder"]).items()},
                **{f"crepe.{k}": v for k, v in _crepe_state_dict(tree["crepe"]).items()}}

    device = template.rng.device
    names = [n for n, _ in template.params.named_parameters()]
    params = state_dict("params")
    buffers = sorted(set(params) - set(names))
    if buffers:
        raise KeyError(f"the JAX state optimises {buffers}, which the port's template keeps "
                       "as buffers (a finetune template needs make_statistics_trainable)")
    moments = {m: state_dict(f"opt_state.0.0.{m}") for m in ("mu", "nu")}
    empty = _at(np_tree, "opt_state.0.1")  # optax's EmptyState: None, or ()
    if (empty is not None and len(empty)) or len(_at(np_tree, "opt_state")) != 2:
        raise KeyError("opt_state: not optax.chain(optax.adam(lr), reduce_on_plateau(...))'s "
                       "state ((ScaleByAdamState, EmptyState), ReduceLROnPlateauState)")

    def scalar(where: str, like: torch.Tensor) -> torch.Tensor:
        value = np.asarray(_at(np_tree, where))
        dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        if value.shape != () or value.dtype != dtype:
            raise ValueError(f"{where}: {value.dtype}{list(value.shape)} in the JAX state, "
                             f"{dtype}[] in the port's")
        return torch.from_numpy(value.copy()).to(device)

    adam, plateau = template.opt_state
    count = scalar("opt_state.0.0.count", adam.count)
    plateau = PlateauState(**{f: scalar(f"opt_state.1.{f}", getattr(plateau, f))
                              for f in PlateauState._fields})
    rng = np.asarray(_at(np_tree, "rng"))
    if rng.shape != (2,) or rng.dtype != np.uint32:
        raise ValueError(f"rng: {rng.dtype}{list(rng.shape)} in the JAX state; the threefry "
                         "key is uint32[2]")
    with torch.no_grad():  # every check passed: the template takes the parameters
        for name, p in template.params.named_parameters():
            p.copy_(params[name])
    return TrainState(
        int(np.asarray(_at(np_tree, "step"))),
        template.params,
        OptState(AdamState(count, *([moments[m][n].to(device) for n in names]
                                    for m in ("mu", "nu"))), plateau),
        torch.from_numpy(rng.astype(np.int64)).to(device),
    )


def train_state_to_jax(state) -> Dict:
    """The port's ``TrainState`` -> the JAX trainer's state tree with numpy
    leaves, keyed as ``models/orbax.read_orbax`` keys its checkpoint: the
    inverse of :func:`train_state_from_jax`, so a test can compare a
    resumed state with the JAX package's leaf by leaf."""
    from ddsp_tpu_torch.training.trainer import PlateauState

    decoder = state.params if isinstance(state.params, Decoder) else state.params["decoder"]
    _refuse_z_module(decoder, "train_state_to_jax")
    to_jax = decoder_to_jax if isinstance(state.params, Decoder) else autoencoder_to_jax

    def layout(values):  # per-parameter tensors in parameters() order
        module = copy.deepcopy(state.params)
        with torch.no_grad():
            for p, v in zip(module.parameters(), values):
                p.copy_(v)
        return to_jax(module)

    adam, plateau = state.opt_state
    return {
        "params": to_jax(state.params),
        "opt_state": [[{"count": adam.count.cpu().numpy(), "mu": layout(adam.mu),
                        "nu": layout(adam.nu)}, None],
                      {f: getattr(plateau, f).cpu().numpy() for f in PlateauState._fields}],
        "step": np.asarray(state.step),
        "rng": state.rng.cpu().numpy().astype(np.uint32),
    }
