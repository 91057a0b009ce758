"""CREPE pitch CNN, and loading of the reference ``.pth`` checkpoints.

Counterpart of ``ddsp_tpu/models/crepe.py`` (reference crepe/crepe.py):
six [pad -> conv (stride 4, then 1) -> ReLU -> inference BatchNorm
(eps 1e-3) -> maxpool 2] stages over 1024-sample windows, then a sigmoid
classifier over 360 pitch bins (``crepe_embed``: the first five stages;
``crepe_activation``: the map after any stage).  The stack runs as 1-D
convolutions in the torch-shaped (N, C, H) layout; the JAX package's channels-last form is a
TPU layout choice with the same math.  Also the three pitch decodes
(argmax, and the differentiable local averages that finetuning needs) and
``make_statistics_trainable`` for the finetune state.

``compute_dtype`` (``Config.crepe_compute_dtype``, read by the encoder)
rounds the convolutions' and the classifier's operands to that dtype and
sums in float32, as the JAX package's ``preferred_element_type=float32``
products do (``ddsp_tpu/models/crepe.py:107-117, 257-258``); bias,
ReLU, BatchNorm, pooling and the sigmoid stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

PITCH_BINS = 360
CENTS_PER_BIN = 20
WINDOW_SIZE = 1024
BN_EPS = 0.0010000000474974513  # MMdnn-converted epsilon (crepe/crepe.py:33-35)

CAPACITIES = {
    "full": {
        "in_channels": [1, 1024, 128, 128, 128, 256],
        "out_channels": [1024, 128, 128, 128, 256, 512],
        "in_features": 2048,
    },
    "tiny": {
        "in_channels": [1, 128, 16, 16, 16, 32],
        "out_channels": [128, 16, 16, 16, 32, 64],
        "in_features": 256,
    },
}
KERNEL_SIZES = [512] + 5 * [64]
STRIDES = [4] + 5 * [1]
PADS = [(254, 254)] + 5 * [(31, 32)]


class Crepe(nn.Module):
    """Parameters named as in the reference state dict: ``conv{i}``,
    ``conv{i}_BN`` (i = 1..6) and ``classifier``."""

    def __init__(self, capacity: str = "tiny"):
        super().__init__()
        spec = CAPACITIES[capacity]
        for i in range(6):
            c_in, c_out = spec["in_channels"][i], spec["out_channels"][i]
            self.add_module(f"conv{i + 1}", nn.Conv1d(c_in, c_out, KERNEL_SIZES[i]))
            self.add_module(f"conv{i + 1}_BN", nn.BatchNorm1d(c_out, eps=BN_EPS))
        self.classifier = nn.Linear(spec["in_features"], PITCH_BINS)


def crepe_init(capacity: str = "tiny", seed: int = 0) -> Crepe:
    """Random init (tests and serving without trained weights)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Crepe(capacity).eval()


def load_torch_checkpoint(path: str, capacity: str = None) -> Crepe:
    """Load a reference CREPE ``.pth`` (``convN.{weight,bias}`` with
    (O, I, k, 1) weights, ``convN_BN.{weight,bias,running_mean,
    running_var}``, ``classifier.{weight,bias}``).  ``capacity`` None reads
    it from ``conv1``'s width, as the JAX package's loader takes the
    checkpoint's shapes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if capacity is None:
        width = sd["conv1.weight"].shape[0] if "conv1.weight" in sd else None
        capacity = next((name for name, spec in CAPACITIES.items()
                         if spec["out_channels"][0] == width), "tiny")
    model = Crepe(capacity)
    mapped = {}
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in sd:
            raise KeyError(f"{path}: missing {key!r}")
        value = sd[key].to(torch.float32)
        if value.dim() == ref.dim() + 1:  # (O, I, k, 1) -> (O, I, k)
            value = value[..., 0]
        mapped[key] = value
    model.load_state_dict(mapped, strict=False)
    return model.eval()


def save_torch_checkpoint(crepe: Crepe, path: str) -> None:
    """Write ``crepe`` as a reference CREPE ``.pth`` (conv weights as
    (O, I, k, 1), no ``num_batches_tracked``): the inverse of
    :func:`load_torch_checkpoint`, which both packages read."""
    sd = {}
    for key, value in crepe.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        value = value.detach().to("cpu", torch.float32).clone()
        sd[key] = value[..., None] if key.startswith("conv") and value.dim() == 3 else value
    torch.save(sd, path)


def _operands(dtype, *ts):
    """``ts`` rounded to ``dtype`` and back to float32 (None: as they are)."""
    return ts if dtype is None else tuple(t.to(dtype).float() for t in ts)


def _layer(x: torch.Tensor, conv: nn.Conv1d, bn: nn.BatchNorm1d,
           stride: int, pad, compute_dtype=None) -> torch.Tensor:
    """pad -> conv1d -> relu -> inference BN -> maxpool(2, stride 2)."""
    x, w = _operands(compute_dtype, F.pad(x, pad), conv.weight)
    x = F.conv1d(x, w, stride=stride)
    x = torch.relu(x + conv.bias[:, None])
    scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    x = (x - bn.running_mean[:, None]) * scale[:, None] + bn.bias[:, None]
    return F.max_pool1d(x, 2, 2)


def _stages(crepe: Crepe, frames: torch.Tensor, n: int, compute_dtype=None) -> torch.Tensor:
    """The first ``n`` conv stages over (B, 1024) windows -> (B, C, H)."""
    x = frames[:, None, :]
    for i in range(n):
        x = _layer(x, getattr(crepe, f"conv{i + 1}"),
                   getattr(crepe, f"conv{i + 1}_BN"), STRIDES[i], PADS[i], compute_dtype)
    return x


def crepe_embed(crepe: Crepe, frames: torch.Tensor,
                compute_dtype: torch.dtype = None) -> torch.Tensor:
    """First five conv stages: (B, 1024) windows -> (B, C5, 8) features
    (reference ``Crepe.embed``, crepe/crepe.py:108-120).  The JAX package's
    ``layout`` argument picks its TPU's channels-last form; the port keeps
    the (N, C, H) layout, the same math, so it takes none."""
    return _stages(crepe, frames, 5, compute_dtype)


def crepe_activation(crepe: Crepe, frames: torch.Tensor, layer_index: int) -> torch.Tensor:
    """The activation after conv stage ``layer_index`` (0-based, < 6),
    (B, C, H): what the DeepDream experiment reads (reference
    trajectory.py:18-41 takes it with a forward hook)."""
    if not 0 <= layer_index < 6:
        raise ValueError(f"layer_index must be in 0..5, got {layer_index}")
    return _stages(crepe, frames, layer_index + 1)


def crepe_forward(crepe: Crepe, frames: torch.Tensor,
                  compute_dtype: torch.dtype = None) -> torch.Tensor:
    """(B, 1024) windows -> (B, 360) sigmoid pitch-bin probabilities,
    with the reference's h-major flatten of the final (B, C, H) map.
    ``compute_dtype``: the operand dtype of the module docstring."""
    x = _stages(crepe, frames, 6, compute_dtype)
    b, c, h = x.shape
    x, w = _operands(compute_dtype, x.transpose(1, 2).reshape(b, h * c),
                     crepe.classifier.weight)
    return torch.sigmoid(F.linear(x, w, crepe.classifier.bias))


def cents_map(bins: torch.Tensor) -> torch.Tensor:
    """Pitch-bin index -> cents (reference encoder.py:39-41)."""
    return bins * CENTS_PER_BIN + 1997.3794084376191


def freq_map(cents: torch.Tensor) -> torch.Tensor:
    """Cents -> Hz (reference encoder.py:46-48)."""
    return 10 * 2 ** (cents / 1200)


def pitch_argmax(probabilities: torch.Tensor):
    """Argmax pitch decode (reference encoder.py:120-128): (..., 360) ->
    (freq, harmonicity, normalized_cents), each (..., 1)."""
    bins = probabilities.argmax(dim=-1, keepdim=True)
    fbins = bins.to(probabilities.dtype)
    freq = freq_map(cents_map(fbins))
    harmonicity = probabilities.gather(-1, bins)
    return freq, harmonicity, fbins / 359.0


def _local_average(probabilities: torch.Tensor, center: torch.Tensor,
                   cents_offsets: torch.Tensor):
    """Probability-weighted mean cents of the 9 bins ``center - 4 ..
    center + 4`` (zero-padded at the edges), each value paired with the
    cents of ``center + cents_offsets``; returns (freq, harmonicity,
    normalized_cents), each (..., 1).  The gradient flows through the
    gathered probabilities, not through the argmax."""
    value_offsets = torch.arange(-4, 5, device=probabilities.device)
    padded = F.pad(probabilities, (4, 4))
    values = padded.gather(-1, center + value_offsets + 4)  # (..., 9)
    cents_cols = cents_map((center + cents_offsets).to(probabilities.dtype))
    cents = (values * cents_cols).sum(-1, keepdim=True) / values.sum(-1, keepdim=True)
    harmonicity = probabilities.gather(-1, center)
    min_c, max_c = cents_map(0.0), cents_map(359.0)
    return freq_map(cents), harmonicity, (cents - min_c) / (max_c - min_c)


def pitch_weighted(probabilities: torch.Tensor):
    """Local weighted-average decode around the argmax bin (the JAX
    package's ``pitch_weighted``): mean cents of the bins within +-4 of the
    argmax, weighted by probability, with each probability paired with its
    own bin's cents (the reference's evident intent, encoder.py:91-118).
    Differentiable in the probabilities: the finetune path's decode."""
    center = probabilities.argmax(dim=-1, keepdim=True)
    offsets = torch.arange(-4, 5, device=probabilities.device)
    return _local_average(probabilities, center, offsets)


# the reference's ``selection[:, :, idx]`` with idx in -4..4 stores the
# offsets' cents in Python's negative-index order
_REF_CENTS_OFFSETS = (0, 1, 2, 3, 4, -4, -3, -2, -1)


def pitch_centered_ref(probabilities: torch.Tensor, center=None):
    """Bug-compatible replica of the reference's ``pitch_centered``
    (encoder.py:94-117, the JAX package's ``pitch_centered_ref``): the
    probabilities of bins ``center - 4 .. center + 4`` in ascending order
    are paired with the cents of offsets [0, 1, 2, 3, 4, -4, -3, -2, -1]."""
    if center is None:
        center = probabilities.argmax(dim=-1, keepdim=True)
    offsets = torch.tensor(_REF_CENTS_OFFSETS, device=probabilities.device)
    return _local_average(probabilities, center, offsets)


def make_statistics_trainable(crepe: Crepe) -> Crepe:
    """Turn every BatchNorm's ``running_mean`` / ``running_var`` buffer into
    an ``nn.Parameter`` of the same name (in place; returns ``crepe``).

    The JAX package keeps them in the parameter pytree (``crepe.py:60-61``,
    ``:95-96``), so its finetune step differentiates them, Adam updates them
    and ``grad_norm`` counts them; the port's finetune state does the same
    through this.  The state-dict keys do not change; ``num_batches_tracked``
    stays a buffer (it is not in the JAX tree).  The frozen encoder and
    serving read the statistics the same way either way.
    """
    for i in range(1, 7):
        bn = getattr(crepe, f"conv{i}_BN")
        for name in ("running_mean", "running_var"):
            value = getattr(bn, name)
            if not isinstance(value, nn.Parameter):
                del bn._buffers[name]
                bn.register_parameter(name, nn.Parameter(value.detach().clone()))
    return crepe
