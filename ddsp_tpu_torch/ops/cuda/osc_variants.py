"""The oscillator's kernel variants behind the JAX package's dispatchers.

Counterparts of ``ddsp_tpu/ops/pallas/oscillator.py:_pallas_forward``
(:507) and ``_pallas_backward`` (:894), with their signatures and defaults,
on the port's kernels:

=========================  ==================================================
``pallas_forward``
``impl='banked'``          K5 (``ops/cuda/oscillator.osc_hop_slots``) over the
                           B*T frame rows, windows from ``amps_pad[:, :-2]``,
                           ``[1:-1]``, ``[2:]``, on ``_kernel_banked``'s
                           rotation fill; takes ``h_start``
``impl='banked2'``         K1 with the K8 options (``ops/cuda/osc_frames``):
                           ``fill``, ``resync_tiles``, ``k_chunk``; bf16
                           operands when ``bank_dtype='bfloat16'`` or
                           ``precision='default'`` (one bf16 MXU pass)
``impl='cheb'``            K7 (``ops/cuda/osc_cheb``), ``resync``; no
                           ``h_start`` (NotImplementedError, as :638-641)
``pallas_backward``
``impl='banked'``          K6 (``ops/cuda/osc_banked_bwd``)
``impl='banked2'``         K2 with the K8 options: ``fill``,
                           ``resync_tiles``; bf16 operands when
                           ``bank_dtype`` or ``contract_dtype`` is bf16
=========================  ==================================================

CUDA tensors launch the kernels, CPU tensors take their plain versions,
anything else raises.  ``frames_per_block`` is accepted and ignored: it is
the TPU's block of frames and changes nothing that is computed (the CUDA
kernels take one frame per block).  ``fill='rot4'`` with ``k_chunk`` raises
ValueError, as :521-530 does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ddsp_tpu_torch.ops.cuda import osc_banked_bwd, osc_cheb, osc_frames
from ddsp_tpu_torch.ops.cuda.oscillator import osc_hop_slots, render_hop_slots_plain
from ddsp_tpu_torch.ops.interp import hop_weights_on

FWD_IMPLS = ("banked", "banked2", "cheb")
BWD_IMPLS = ("banked", "banked2")
PRECISIONS = ("highest", "default")
DTYPES = ("float32", "bfloat16")


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    name = str(dtype).replace("torch.", "")
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    return name


def _precision_name(precision) -> str:
    name = str(precision).lower().replace("precision.", "")
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return name


def _chunk_tiles(k_chunk) -> Optional[int]:
    return None if k_chunk is None else max(1, int(k_chunk) // 8)


def frame_options(direction: str, kw: dict) -> dict:
    """The K1 ('fwd') or K2 ('bwd') options of an ``impl='banked2'`` call
    with the JAX keywords ``kw``: fill, bf16, resync_tiles, chunk_tiles."""
    bank = _dtype_name(kw.get("bank_dtype", "float32"))
    if direction == "fwd":
        bf16 = bank == "bfloat16" or _precision_name(kw.get("precision", "highest")) == "default"
        chunk = _chunk_tiles(kw.get("k_chunk"))
    else:
        bf16 = "bfloat16" in (bank, _dtype_name(kw.get("contract_dtype")))
        chunk = None
    return dict(fill=kw.get("fill", "cheb8" if direction == "fwd" else "rot"), bf16=bf16,
                resync_tiles=kw.get("resync_tiles", 8), chunk_tiles=chunk)


def _device(*tensors) -> torch.device:
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def render_rows(phase1, amps_pad, loud_pad, h_start: int = 0,
                plain: bool = False) -> torch.Tensor:
    """``impl='banked'``: every frame of the batch as an independent K5 row
    with its (previous, current, next) windows, on the rotation fill
    (``plain``: K5's plain version on any device).  Returns (B, T*hop)."""
    b, t, hop = phase1.shape
    rows = lambda x: x.reshape(b * t, -1).contiguous()  # noqa: E731
    loud = torch.stack([loud_pad[:, :-2], loud_pad[:, 1:-1], loud_pad[:, 2:]], -1)
    out = (render_hop_slots_plain if plain else osc_hop_slots)(
        rows(phase1), rows(amps_pad[:, :-2]), rows(amps_pad[:, 1:-1]),
        rows(amps_pad[:, 2:]), loud.reshape(b * t, 3).contiguous(),
        hop_weights_on(hop, phase1.device), h_start, "rot",
    )
    return out.reshape(b, t * hop)


def pallas_forward(
    phase1: torch.Tensor,  # (B, T, hop)
    amps_pad: torch.Tensor,  # (B, T+2, H)
    loud_pad: torch.Tensor,  # (B, T+2)
    frames_per_block=None,
    resync: int = 32,
    impl: str = "banked",
    h_start=None,
    fill: str = "cheb8",
    resync_tiles: int = 8,
    k_chunk=None,
    precision="highest",
    bank_dtype: str = "float32",
) -> torch.Tensor:
    """(B, T, hop) phase, (B, T+2, H) amps, (B, T+2) loudness -> (B, T*hop)
    by the kernel ``impl`` selects (module docstring)."""
    del frames_per_block  # the TPU's block size: nothing here depends on it
    if fill == "rot4" and k_chunk is not None:
        raise ValueError(
            "fill='rot4' is whole-bank only and cannot be combined with "
            "k_chunk interleaving; use fill='rot' with k_chunk, or drop k_chunk"
        )
    if impl not in FWD_IMPLS:
        raise ValueError(f"impl must be one of {FWD_IMPLS}, got {impl!r}")
    opts = frame_options("fwd", dict(fill=fill, resync_tiles=resync_tiles, k_chunk=k_chunk,
                                     precision=precision, bank_dtype=bank_dtype))
    _device(phase1, amps_pad, loud_pad)
    if impl == "cheb":
        if h_start is not None:
            raise NotImplementedError(
                "h_start offsets are supported by the 'banked' kernel only"
            )
        return osc_cheb.osc_cheb_fwd(phase1, amps_pad, loud_pad, resync)
    h0 = 0 if h_start is None else int(h_start)
    if impl == "banked":
        return render_rows(phase1, amps_pad, loud_pad, h0)
    if phase1.device.type == "cpu":
        return osc_frames.render_from_phase_variant_plain(phase1, amps_pad, loud_pad, h0, **opts)
    return osc_frames.osc_frames_fwd(
        phase1.contiguous(), amps_pad.contiguous(), loud_pad.contiguous(), h0, **opts)


def pallas_backward(
    phase1: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    g: torch.Tensor,  # (B, T*hop)
    frames_per_block=None,
    bank_dtype: str = "float32",
    h_start=None,
    impl: str = "banked",
    fill: str = "rot",
    resync_tiles: int = 8,
    contract_dtype=None,
):
    """(dphase (B, T, hop), d amps_pad (B, T+2, H), d loud_pad (B, T+2)) for
    the audio gradient ``g`` by the kernel ``impl`` selects."""
    del frames_per_block
    if impl not in BWD_IMPLS:
        raise ValueError(f"impl must be one of {BWD_IMPLS}, got {impl!r}")
    opts = frame_options("bwd", dict(fill=fill, resync_tiles=resync_tiles,
                                     bank_dtype=bank_dtype, contract_dtype=contract_dtype))
    _device(phase1, amps_pad, loud_pad, g)
    h0 = 0 if h_start is None else int(h_start)
    if impl == "banked":
        return osc_banked_bwd.osc_banked_bwd(
            g.contiguous(), phase1.contiguous(), amps_pad.contiguous(),
            loud_pad.contiguous(), h0, _dtype_name(bank_dtype))
    if phase1.device.type == "cpu":
        return osc_frames.render_from_phase_bwd_variant_plain(
            g, phase1, amps_pad, loud_pad, h0, **opts)
    return osc_frames.osc_frames_bwd(
        g.contiguous(), phase1.contiguous(), amps_pad.contiguous(),
        loud_pad.contiguous(), h0, **opts)
