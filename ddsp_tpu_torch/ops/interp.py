"""Per-hop linear-interpolation weights (frame rate -> audio rate).

The reference upsamples frame-rate controls with
``F.interpolate(mode='linear', align_corners=False)``.  For an integer
scale ``hop`` the output sample ``t*hop + j`` mixes frames ``t-1, t, t+1``
with fixed weights that depend only on ``j``; the oscillator uses those
weights directly and never builds audio-rate control tensors.

Counterpart of ``ddsp_tpu/ops/interp.py`` (weights in numpy, cached;
``edge_pad_frames`` and ``upsample_linear`` on tensors).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def hop_weights(hop: int) -> np.ndarray:
    """(hop, 3) weights w[j] over frames (t-1, t, t+1) for sample t*hop + j.

    For j < hop/2 the source coordinate falls in [t-1, t]; for j >= hop/2 in
    [t, t+1].  Boundary clamping is the caller's (edge-padded frames).
    """
    j = np.arange(hop, dtype=np.float64)
    u = (j + 0.5) / hop  # in (0, 1)
    w = np.zeros((hop, 3), dtype=np.float64)
    lo = u < 0.5
    w[lo, 0] = 0.5 - u[lo]
    w[lo, 1] = 0.5 + u[lo]
    w[~lo, 1] = 1.5 - u[~lo]
    w[~lo, 2] = u[~lo] - 0.5
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hop_weight_cumsum(hop: int) -> np.ndarray:
    """(hop, 3) inclusive prefix sums of :func:`hop_weights` along j.

    Row j gives the contribution of frames (t-1, t, t+1) to the partial sum
    ``sum_{j'<=j} x_up[t*hop + j']`` of the upsampled signal within hop t
    (the closed-form oscillator phase accumulation).
    """
    return np.cumsum(hop_weights(hop), axis=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hop_weights_on(hop: int, device: torch.device) -> torch.Tensor:
    """:func:`hop_weights` as a tensor on ``device``, made once: a fresh
    host-to-device copy each call would stall the host on the device."""
    return torch.as_tensor(hop_weights(hop), device=device)


@functools.lru_cache(maxsize=None)
def hop_weight_cumsum_on(hop: int, device: torch.device) -> torch.Tensor:
    """:func:`hop_weight_cumsum` as a tensor on ``device``, made once."""
    return torch.as_tensor(hop_weight_cumsum(hop), device=device)


def edge_pad_frames(x: torch.Tensor) -> torch.Tensor:
    """Replicate one frame of context on each side of the time axis
    (axis 1): the interpolation edge clamp of offline renders."""
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def upsample_linear(x: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, C) frame-rate signal -> (B, T*hop, C) audio rate, by the
    reference's ``F.interpolate(x.permute(0, 2, 1), scale_factor=hop,
    mode='linear')`` (model/ddsp/harmonic_oscillator.py:52-55), as the JAX
    package computes it: three shifted frame views mixed by
    :func:`hop_weights`."""
    b, t, c = x.shape
    xp = edge_pad_frames(x)
    w = hop_weights_on(hop, x.device)  # (hop, 3)
    out = (xp[:, :-2, None, :] * w[None, None, :, 0, None]
           + xp[:, 1:-1, None, :] * w[None, None, :, 1, None]
           + xp[:, 2:, None, :] * w[None, None, :, 2, None])
    return out.reshape(b, t * hop, c)
