"""Power-STFT kernels of the MSS loss (forward and backward): CUDA C++ for
Hopper, on wgmma.

Counterpart of ``ddsp_tpu/ops/pallas/stft.py:stft_power_blocked`` and its
``custom_vjp`` (kernels ``_fwd_kernel`` and ``_bwd_kernel``), without the
TPU's padding:

* inputs: hop blocks xb (B, n_blocks, hop) of the centre-padded signal,
  float32 or its bf16 copy (the wrappers make that copy with one cast, as
  ``ddsp_tpu/ops/pallas/stft.py:189`` does), the geometry ``n_fft``,
  ``hop``, ``n_frames`` and the Hann-windowed rDFT matrices Wc, Ws
  (n_fft, bins) in bf16 (:func:`dft_mats`, built in float64 as the JAX
  package builds them), cached in the kernels' layouts (:func:`wt_layout`,
  :func:`wcat_layout`);
* ``stft_power_fwd`` launches the forward kernel: |S|^2 (B, n_frames,
  bins) float32 from bf16 signal and matrices, float32 sums;
* ``stft_power_bwd`` launches the backward's two kernels for the
  magnitude gradient dmag (B, n_frames, bins): the recompute of re/im with
  the TPU kernel's two bf16 casts (``dre = bf16(2 re bf16(dmag))``,
  ``dim`` likewise) into a bf16 scratch D, then the shifted product of D
  with the matrices: dxb (B, n_blocks, hop) float32;
* ``StftPower`` joins them in one ``torch.autograd.Function``: a CUDA
  tensor launches the kernels (and keeps the bf16 copy for the backward),
  a CPU tensor takes their plain versions.  Nothing falls back from the
  card to the plain versions.

``FWD_LAUNCHES`` counts forward launches, ``BWD_LAUNCHES`` the backward's
shifted product (one a ``stft_power_bwd`` call) and
``BWD_RECOMPUTE_LAUNCHES`` its recompute, and nothing else.
``stft_power_plain`` and ``stft_power_bwd_plain`` are the plain PyTorch
versions the tests and ``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.fft import DIRECT_MAX
from ddsp_tpu_torch.utils.profiling import check_kernel_output

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_RECOMPUTE_LAUNCHES = 0

GROUP = 64  # bins a group of the cached layouts: re | im, one wgmma N of 128
ROWS = 64  # rows of an M tile (frames, output hop blocks)
_ENCODE_ERROR = 10000  # csrc/stft_power.cu: + the CUresult of a refused tensor map
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "stft_power_fwd": [_P] * 3 + [_I] * 5 + [_P],
    "stft_power_bwd_recompute": [_P] * 4 + [_I] * 5 + [_P],
    "stft_power_bwd_shifted": [_P] * 3 + [_I] * 5 + [_P],
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


def bins_pad(n_fft: int) -> int:
    """bins = n_fft/2 + 1 rounded up to a multiple of :data:`GROUP`."""
    return -(-(n_fft // 2 + 1) // GROUP) * GROUP


@functools.lru_cache(maxsize=None)
def wt_layout(n_fft: int, device) -> torch.Tensor:
    """The forward GEMM's B operand, K-major: (2 bins_pad, ru(n_fft, 8))
    bf16, the entries of :func:`dft_mats` regrouped.  Bins are padded with
    zeros to a multiple of 64; each group of 64 Wc^T rows (bins 64 g ...
    64 g + 63) is followed by the same group's Ws^T rows, so one N = 128
    tile holds re in columns 0-63 and im in 64-127.  Columns past n_fft
    (n_fft % 8 != 0) are zeros."""
    bins, bp, ldk = n_fft // 2 + 1, bins_pad(n_fft), -(-n_fft // 8) * 8
    out = torch.zeros(bp // GROUP, 2, GROUP, ldk, dtype=torch.bfloat16, device=device)
    for part, w in enumerate(dft_mats(n_fft, device)):
        padded = torch.zeros(bp, ldk, dtype=torch.bfloat16, device=device)
        padded[:bins, :n_fft] = w.T
        out[:, part] = padded.view(bp // GROUP, GROUP, ldk)
    return out.reshape(2 * bp, ldk)


@functools.lru_cache(maxsize=None)
def wcat_layout(n_fft: int, device) -> torch.Tensor:
    """The shifted product's B operand, K-major: (n_fft, 2 bins_pad) bf16,
    ``[Wc | Ws]`` in :func:`wt_layout`'s group order (its transpose), so
    row i*hop + j is contiguous along the K of (a)'s scratch D."""
    return wt_layout(n_fft, device)[:, :n_fft].T.contiguous()


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
    if xb.dtype not in (torch.float32, torch.bfloat16) or (
            dmag is not None and dmag.dtype != torch.float32):
        raise ValueError("stft_power kernels take float32 tensors (xb also bf16) only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("stft_power kernels take contiguous tensors only")
    if b * -(-max(n_blocks, n_frames) // ROWS) >= 2**31:
        raise ValueError(f"B={b} rows of {n_blocks} blocks exceed the kernels' grid")
    if n_blocks * hop >= 2**31:
        raise ValueError(f"{n_blocks} blocks of {hop} samples exceed int32 indexing")


def _launch(name: str, device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc >= _ENCODE_ERROR:
        raise RuntimeError(
            f"{name}: the driver refused a tensor map, CUresult {rc - _ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def stft_power_fwd(xb: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Launch the forward kernel: (B, n_blocks, hop) float32 or bf16 ->
    (B, n_frames, bins) float32.  CUDA tensors only."""
    global FWD_LAUNCHES
    _check(xb, n_fft, hop, n_frames)
    b, n_blocks, _ = xb.shape
    xq = xb.to(torch.bfloat16)  # xb itself when it is the bf16 copy
    wt = wt_layout(n_fft, xb.device)
    out = torch.empty((b, n_frames, n_fft // 2 + 1), dtype=torch.float32, device=xb.device)
    _launch("stft_power_fwd", xb.device, xq.data_ptr(), wt.data_ptr(), out.data_ptr(),
            b, n_blocks, hop, n_fft, n_frames)
    FWD_LAUNCHES += 1
    check_kernel_output("stft_power_fwd", out)
    return out


def stft_power_bwd(
    xb: torch.Tensor, dmag: torch.Tensor, n_fft: int, hop: int, n_frames: int
) -> torch.Tensor:
    """Launch the backward's two kernels for the magnitude gradient
    ``dmag`` (B, n_frames, bins): the recompute into the bf16 scratch D
    (B, n_frames, 2 bins_pad), then the shifted product; returns dxb (B,
    n_blocks, hop) float32.  ``xb`` float32 or its bf16 copy.  CUDA
    tensors only."""
    global BWD_LAUNCHES, BWD_RECOMPUTE_LAUNCHES
    _check(xb, n_fft, hop, n_frames, dmag)
    b, n_blocks, _ = xb.shape
    xq = xb.to(torch.bfloat16)  # xb itself when it is the bf16 copy
    wt, wcat = wt_layout(n_fft, xb.device), wcat_layout(n_fft, xb.device)
    d = torch.empty((b, n_frames, 2 * bins_pad(n_fft)), dtype=torch.bfloat16, device=xb.device)
    dxb = torch.empty(xb.shape, dtype=torch.float32, device=xb.device)
    _launch("stft_power_bwd_recompute", xb.device, xq.data_ptr(), dmag.data_ptr(),
            wt.data_ptr(), d.data_ptr(), b, n_blocks, hop, n_fft, n_frames)
    BWD_RECOMPUTE_LAUNCHES += 1
    check_kernel_output("stft_power_bwd_recompute", d)
    _launch("stft_power_bwd_shifted", xb.device, d.data_ptr(), wcat.data_ptr(), dxb.data_ptr(),
            b, n_blocks, hop, n_fft, n_frames)
    BWD_LAUNCHES += 1
    check_kernel_output("stft_power_bwd", dxb)
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
        ctx.geometry = (n_fft, hop, n_frames)
        if _on_cuda(xb):
            xq = xb.to(torch.bfloat16)  # the one cast; the backward reads it
            ctx.save_for_backward(xq)
            return stft_power_fwd(xq, n_fft, hop, n_frames)
        ctx.save_for_backward(xb)
        return stft_power_plain(xb, n_fft, hop, n_frames)

    @staticmethod
    def backward(ctx, dmag):
        (xb,) = ctx.saved_tensors
        bwd = stft_power_bwd if _on_cuda(xb) else stft_power_bwd_plain
        return bwd(xb, dmag.contiguous(), *ctx.geometry), None, None, None
