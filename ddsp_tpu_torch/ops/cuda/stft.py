"""Power-STFT kernels of the MSS loss (forward and backward): CUDA C++ for
Hopper.

Counterpart of ``ddsp_tpu/ops/pallas/stft.py:stft_power_blocked`` and its
``custom_vjp`` (kernels ``_fwd_kernel`` and ``_bwd_kernel``), without the
TPU's padding:

* inputs: hop blocks xb (B, n_blocks, hop) float32 of the centre-padded
  signal, the geometry ``n_fft``, ``hop``, ``n_frames`` and the
  Hann-windowed rDFT matrices Wc, Ws (n_fft, bins) in bf16
  (:func:`dft_mats`, built in float64 as the JAX package builds them);
* ``stft_power_fwd`` launches the forward kernel: |S|^2 (B, n_frames,
  bins) float32 from bf16-rounded signal and matrices, float32 sums;
* ``stft_power_bwd`` launches the backward kernel for the magnitude
  gradient dmag (B, n_frames, bins): dxb (B, n_blocks, hop) float32, with
  re/im recomputed and the TPU kernel's two bf16 casts
  (``dre = bf16(2 re bf16(dmag))``, ``dim`` likewise);
* ``StftPower`` joins them in one ``torch.autograd.Function``: a CUDA
  tensor launches the kernels, a CPU tensor takes their plain versions.
  Nothing falls back from the card to the plain versions.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches and nothing
else.  ``stft_power_plain`` and ``stft_power_bwd_plain`` are the plain
PyTorch versions the tests and ``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.fft import DIRECT_MAX

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_BATCH = 65535  # the kernels' grid.z
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "stft_power_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "stft_power_bwd": [_P] * 5 + [_I] * 5 + [_P],
}


def _library() -> ctypes.CDLL:
    return _build.library("stft_power", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hann-windowed rDFT matrices (n_fft, n_fft//2+1), computed in float64
    and rounded to float32 (``ddsp_tpu/ops/spectral.py:_hann_rdft_blocks``
    and ``ops/pallas/stft.py:_wmats`` unblocked)."""
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos = (win[:, None] * np.cos(ang)).astype(np.float32)
    sin = (win[:, None] * np.sin(ang)).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def dft_mats(n_fft: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Wc, Ws), each (n_fft, bins) bf16 on ``device``, cached per
    (n_fft, device).  float64 -> float32 -> bf16, as the JAX package: a
    float32 ``cos`` of the large angles would round some entries to the
    neighbouring bf16 value."""
    return tuple(
        torch.from_numpy(m).to(device=device, dtype=torch.bfloat16)
        for m in _dft_mats_np(n_fft)
    )


def _re_im(xb: torch.Tensor, n_fft: int, hop: int, n_frames: int):
    """(re, im), each (B, n_frames, bins) float32: the hop-blocked sums of
    the bf16-rounded signal against the bf16 matrices (plain version)."""
    wc, ws = (w.float() for w in dft_mats(n_fft, xb.device))
    xq = xb.to(torch.bfloat16).float()
    re = im = 0.0
    for j in range(n_fft // hop):
        part = xq[:, j : j + n_frames]
        re = re + part @ wc[j * hop : (j + 1) * hop]
        im = im + part @ ws[j * hop : (j + 1) * hop]
    return re, im


def stft_power_plain(xb: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Plain version of the forward kernel: (B, n_blocks, hop) ->
    (B, n_frames, bins) float32 |S|^2, the counterpart of the JAX
    package's ``_spectrogram_hopblocked(matmul_dtype=bfloat16)``."""
    re, im = _re_im(xb, n_fft, hop, n_frames)
    return re * re + im * im


def stft_power_bwd_plain(
    xb: torch.Tensor, dmag: torch.Tensor, n_fft: int, hop: int, n_frames: int
) -> torch.Tensor:
    """Plain version of the backward kernel: recomputed re/im, the two
    bf16 casts of ``ddsp_tpu/ops/pallas/stft.py:160-162`` written out (so
    not autograd of :func:`stft_power_plain`, which would skip them), and
    the transposed hop-block products.  Returns dxb (B, n_blocks, hop)."""
    with torch.no_grad():
        re, im = _re_im(xb, n_fft, hop, n_frames)
        dm = dmag.to(torch.bfloat16).float()
        dre = (2.0 * re * dm).to(torch.bfloat16).float()
        dim = (2.0 * im * dm).to(torch.bfloat16).float()
        wc, ws = (w.float() for w in dft_mats(n_fft, xb.device))
        dxb = torch.zeros_like(xb)
        for j in range(n_fft // hop):
            dxb[:, j : j + n_frames] += (
                dre @ wc[j * hop : (j + 1) * hop].T + dim @ ws[j * hop : (j + 1) * hop].T
            )
        return dxb


def _check(xb, n_fft: int, hop: int, n_frames: int, dmag=None) -> None:
    if xb.dim() != 3 or xb.shape[-1] != hop:
        raise ValueError(f"xb must be (B, n_blocks, {hop}), got {tuple(xb.shape)}")
    b, n_blocks, _ = xb.shape
    if hop < 1 or n_fft % hop or n_fft > DIRECT_MAX:
        raise ValueError(f"need hop | n_fft <= {DIRECT_MAX}, got n_fft={n_fft}, hop={hop}")
    if n_frames < 1 or (n_frames - 1) * hop + n_fft > n_blocks * hop:
        raise ValueError(f"{n_frames} frames of {n_fft} exceed {n_blocks} blocks of {hop}")
    if dmag is not None and tuple(dmag.shape) != (b, n_frames, n_fft // 2 + 1):
        raise ValueError(
            f"dmag must be {(b, n_frames, n_fft // 2 + 1)}, got {tuple(dmag.shape)}")
    tensors = [xb] + ([] if dmag is None else [dmag])
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("stft_power kernels take CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("stft_power inputs lie on different devices")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("stft_power kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("stft_power kernels take contiguous tensors only")
    if b > MAX_BATCH:
        raise ValueError(f"B={b} exceeds {MAX_BATCH}")
    if n_blocks * hop >= 2**31:
        raise ValueError(f"{n_blocks} blocks of {hop} samples exceed int32 indexing")


def stft_power_fwd(xb: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Launch the forward kernel: (B, n_blocks, hop) -> (B, n_frames, bins)
    float32.  CUDA tensors only."""
    global FWD_LAUNCHES
    _check(xb, n_fft, hop, n_frames)
    b, n_blocks, _ = xb.shape
    wc, ws = dft_mats(n_fft, xb.device)
    out = torch.empty((b, n_frames, n_fft // 2 + 1), dtype=torch.float32, device=xb.device)
    lib = _library()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        rc = lib.stft_power_fwd(
            xb.data_ptr(), wc.data_ptr(), ws.data_ptr(), out.data_ptr(),
            b, n_blocks, hop, n_fft, n_frames, stream,
        )
    if rc != 0:
        raise RuntimeError(f"stft_power_fwd launch failed: CUDA error {rc}")
    FWD_LAUNCHES += 1
    return out


def stft_power_bwd(
    xb: torch.Tensor, dmag: torch.Tensor, n_fft: int, hop: int, n_frames: int
) -> torch.Tensor:
    """Launch the backward kernel for the magnitude gradient ``dmag``
    (B, n_frames, bins): dxb (B, n_blocks, hop) float32.  CUDA tensors
    only."""
    global BWD_LAUNCHES
    _check(xb, n_fft, hop, n_frames, dmag)
    b, n_blocks, _ = xb.shape
    wc, ws = dft_mats(n_fft, xb.device)
    dxb = torch.empty_like(xb)
    lib = _library()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        rc = lib.stft_power_bwd(
            xb.data_ptr(), dmag.data_ptr(), wc.data_ptr(), ws.data_ptr(),
            dxb.data_ptr(), b, n_blocks, hop, n_fft, n_frames, stream,
        )
    if rc != 0:
        raise RuntimeError(f"stft_power_bwd launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return dxb


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"stft_power: unsupported device {x.device}")
    return x.device.type == "cuda"


class StftPower(torch.autograd.Function):
    """|S|^2 of hop blocks with the TPU kernel pair's gradient: on a CUDA
    tensor the forward and backward kernels, on a CPU tensor their plain
    versions.  Only ``xb`` takes a gradient."""

    @staticmethod
    def forward(ctx, xb, n_fft: int, hop: int, n_frames: int):
        ctx.save_for_backward(xb)
        ctx.geometry = (n_fft, hop, n_frames)
        fwd = stft_power_fwd if _on_cuda(xb) else stft_power_plain
        return fwd(xb, n_fft, hop, n_frames)

    @staticmethod
    def backward(ctx, dmag):
        (xb,) = ctx.saved_tensors
        bwd = stft_power_bwd if _on_cuda(xb) else stft_power_bwd_plain
        return bwd(xb, dmag.contiguous(), *ctx.geometry), None, None, None
