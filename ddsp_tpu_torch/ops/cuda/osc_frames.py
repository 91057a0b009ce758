"""Frame oscillator kernels (forward and backward): CUDA C++ for Hopper.

Counterpart of ``ddsp_tpu/ops/pallas/oscillator.py:pallas_render_from_phase``
and its ``custom_vjp`` ``_render_h`` (kernels ``_kernel_banked2`` and
``_kernel_banked2_bwd``), after the caller's Nyquist normalisation and
phase stage, without the TPU's padding:

* inputs: phase (B, T, hop) in cycles, amps_pad (B, T+2, H), loud_pad
  (B, T+2), the (hop, 3) hop weights and an integer ``h_start``
  (``amps_pad[..., i]`` drives harmonic ``h_start + i + 1``);
* ``osc_frames_fwd`` launches the forward kernel: audio (B, T*hop);
* ``osc_frames_bwd`` launches the backward kernel
  (``osc_frames_bwd_windows``: dphase and the per-window gradients) and
  the overlap-add kernel (``osc_overlap_add``, bit-equal to its plain
  version ``overlap_add_windows``), which sums those onto the padded frame
  axis: (dphase (B, T, hop), d amps_pad (B, T+2, H), d loud_pad (B, T+2));
* ``OscFrames`` joins the two in one ``torch.autograd.Function``;
* ``render_from_phase(..., fill)`` dispatches by device: a CUDA tensor
  takes ``OscFrames``, a CPU tensor the plain version of the same fill
  (``OscFramesPlain``).  The training path passes the fill that
  ``models/synths.osc_fill`` resolves from ``Config.osc_impl``: 'rot',
  the TPU kernels' own, on the card by default.  Nothing falls back from
  the card to the plain version.

The kernels take the options of ``_kernel_banked2`` / ``_bwd`` (K8,
``:507-520``, ``:894-906``), each compiled as its own instantiation:
``fill`` ('exact', the default: every harmonic's own sine; 'rot', 'rot4',
'cheb8': the TPU's bank fills, ``ops/osc_fill.py``), ``resync_tiles`` and
``chunk_tiles`` (``k_chunk // 8``) for those fills, and ``bf16``: the
contraction's operands rounded to bfloat16 (forward: ``bank_dtype`` bf16
or precision DEFAULT; backward: ``contract_dtype`` or a bf16 bank).
``set_osc_bwd_contract_dtype('bfloat16')`` makes the training backward
(``OscFrames`` on the card, the plain version with the same casts on the
CPU) contract in bf16, as ``_bwd`` does (``:1076-1094``); the setting in
force when the forward runs decides its backward.

``FWD_LAUNCHES``, ``BWD_LAUNCHES`` and ``OVERLAP_LAUNCHES`` count kernel
launches and nothing else; ``VARIANT_LAUNCHES`` counts the first two by
:func:`variant_name`.
``render_from_phase_plain`` (defined in ``ops/oscillator.py``),
``render_from_phase_bwd_plain`` and the ``*_variant_plain`` functions are
the plain PyTorch versions the tests and ``chip_smoke.py`` hold the
kernels against.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.ops.interp import hop_weights_on
from ddsp_tpu_torch.ops.osc_fill import FILLS, fill_banks, round_bf16
from ddsp_tpu_torch.ops.oscillator import TWO_PI, render_from_phase_plain

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
OVERLAP_LAUNCHES = 0
VARIANT_LAUNCHES: collections.Counter = collections.Counter()

_FILL_CODES = {"exact": 0, "rot": 1, "cheb8": 2}  # csrc/osc_fill.cuh
_WHOLE_BANK = 1 << 30  # chunk_tiles of an unchunked fill
_CONTRACT_DTYPES = (None, "bfloat16")
_BWD_CONTRACT_DTYPE = None

MAX_HARMONICS = 2048  # h * (1/4096-grid phase) stays exact in float32
MAX_BATCH = 65535  # the kernels' grid.y
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "osc_frames_fwd": [_P] * 5 + [_I] * 9 + [_P],
    "osc_frames_bwd": [_P] * 8 + [_I] * 9 + [_P],
    "osc_frames_overlap_add": [_P] * 4 + [_I] * 3 + [_P],
}


def _library() -> ctypes.CDLL:
    return _build.library("osc_frames", _SIGNATURES)


def render_from_phase_bwd_plain(
    g: torch.Tensor,
    phase: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    h_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: ``torch.autograd.grad`` of
    :func:`render_from_phase_plain` for the audio gradient ``g``
    (B, T*hop).  Returns (dphase, d amps_pad, d loud_pad)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(True) for x in (phase, amps_pad, loud_pad)]
        audio = render_from_phase_plain(*inputs, h_start)
        return torch.autograd.grad(audio, inputs, g)


def set_osc_bwd_contract_dtype(dtype) -> None:
    """None (float32 sums of float32 operands) or 'bfloat16' (the three
    backward contractions' operands rounded to bf16) for the training
    oscillator's backward, as ``ddsp_tpu``'s switch of the same name."""
    global _BWD_CONTRACT_DTYPE
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if dtype not in _CONTRACT_DTYPES:
        raise ValueError(f"contract dtype must be one of {_CONTRACT_DTYPES}, got {dtype!r}")
    _BWD_CONTRACT_DTYPE = dtype


def get_osc_bwd_contract_dtype():
    return _BWD_CONTRACT_DTYPE


def fill_options(fill: str, resync_tiles: int = 8,
                 chunk_tiles: Optional[int] = None) -> Tuple[str, int, Optional[int]]:
    """Checked (fill, resync_tiles, chunk_tiles), with 'rot4' as 'rot' in
    chunks of 4 tiles (the same seeds and rotations)."""
    if fill not in FILLS:
        raise ValueError(f"fill must be one of {FILLS}, got {fill!r}")
    if fill == "rot4":
        if chunk_tiles is not None:
            raise ValueError(
                "fill='rot4' is whole-bank only and cannot be combined with "
                "k_chunk interleaving; use fill='rot' with k_chunk, or drop k_chunk"
            )
        fill, chunk_tiles = "rot", 4
    if int(resync_tiles) < 1 or (chunk_tiles is not None and int(chunk_tiles) < 1):
        raise ValueError("resync_tiles and chunk_tiles must be >= 1")
    return fill, int(resync_tiles), (None if chunk_tiles is None else int(chunk_tiles))


def variant_name(kernel: str, fill: str = "exact", bf16: bool = False,
                 resync_tiles: int = 8, chunk_tiles: Optional[int] = None) -> str:
    """The launch-counter key of one option set, e.g.
    ``osc_frames_fwd[fill=cheb8,resync_tiles=23]``; the default options
    give the bare kernel name."""
    opts = [] if fill == "exact" else [f"fill={fill}"]
    if fill == "cheb8" and resync_tiles != 8:
        opts.append(f"resync_tiles={resync_tiles}")
    if chunk_tiles is not None:
        opts.append(f"chunk_tiles={chunk_tiles}")
    if bf16:
        opts.append("bf16")
    return kernel + (f"[{','.join(opts)}]" if opts else "")


def _windows(x: torch.Tensor) -> torch.Tensor:
    """(B, T+2, ...) padded frames -> (B, T, 3, ...) (previous, current,
    next) windows."""
    return torch.stack([x[:, :-2], x[:, 1:-1], x[:, 2:]], dim=2)


def render_from_phase_variant_plain(
    phase, amps_pad, loud_pad, h_start: int = 0, fill: str = "exact",
    bf16: bool = False, resync_tiles: int = 8, chunk_tiles: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the forward kernel with its options: the bank from
    ``fill`` and, with ``bf16``, both operands rounded to bfloat16.
    Returns (B, T*hop)."""
    fill, resync_tiles, chunk_tiles = fill_options(fill, resync_tiles, chunk_tiles)
    b, t, hop = phase.shape
    sines, _ = fill_banks(phase, amps_pad.shape[-1], h_start, fill, resync_tiles,
                          chunk_tiles, cos=False)
    amp_win = _windows(amps_pad)  # (B, T, 3, H)
    if bf16:
        sines, amp_win = round_bf16(sines), round_bf16(amp_win)
    w = hop_weights_on(hop, phase.device)
    s = torch.einsum("btjh,btkh->btjk", sines, amp_win)
    harm = torch.einsum("btjk,jk->btj", s, w)
    loud_up = torch.einsum("btk,jk->btj", _windows(loud_pad), w)
    return (loud_up * harm).reshape(b, t * hop)


def overlap_add_windows(da_win, dl_win, t: int):
    """Per-window gradients (B, T, 3, H), (B, T, 3) -> the padded frame
    axis (B, T+2, H), (B, T+2): window k of frame t belongs to row t + k
    (``_pallas_backward``, :1046-1052)."""
    b, _, _, h = da_win.shape
    d_amps = da_win.new_zeros((b, t + 2, h))
    d_loud = dl_win.new_zeros((b, t + 2))
    for k in range(3):
        d_amps[:, k : k + t] += da_win[:, :, k]
        d_loud[:, k : k + t] += dl_win[:, :, k]
    return d_amps, d_loud


def render_from_phase_bwd_variant_plain(
    g, phase, amps_pad, loud_pad, h_start: int = 0, fill: str = "exact",
    bf16: bool = False, resync_tiles: int = 8, chunk_tiles: Optional[int] = None,
    amps_rounded_first: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel with its options, written out
    as the TPU kernel's three contractions (not autograd: the sines come
    from ``fill``, and ``bf16`` rounds each contraction's operands).  The
    phase derivative's amplitude operand is bf16(bf16(A) * 2 pi h)
    (``contract_dtype``, :873) or, with ``amps_rounded_first=False``,
    bf16(A * 2 pi h) (one bf16 pass of a float32 operand).  Returns
    (dphase (B, T, hop), d amps_pad (B, T+2, H), d loud_pad (B, T+2))."""
    fill, resync_tiles, chunk_tiles = fill_options(fill, resync_tiles, chunk_tiles)
    b, t, hop = phase.shape
    h = amps_pad.shape[-1]
    sines, coses = fill_banks(phase, h, h_start, fill, resync_tiles, chunk_tiles)
    w = hop_weights_on(hop, phase.device)
    g3 = g.reshape(b, t, hop)
    ql = g3 * torch.einsum("btk,jk->btj", _windows(loud_pad), w)
    qw = ql[..., None] * w  # (B, T, hop, 3)
    a_win = _windows(amps_pad)  # (B, T, 3, H)
    h_row = TWO_PI * (torch.arange(h, dtype=phase.dtype, device=phase.device)
                      + (1.0 + h_start))
    if bf16:
        a_scaled = round_bf16((round_bf16(a_win) if amps_rounded_first else a_win) * h_row)
        sines, coses, qw, a_win = (round_bf16(x) for x in (sines, coses, qw, a_win))
    else:
        a_scaled = a_win * h_row
    da_win = torch.einsum("btjk,btjh->btkh", qw, sines)
    harm = torch.einsum("btjk,jk->btj", torch.einsum("btjh,btkh->btjk", sines, a_win), w)
    dphi = torch.einsum("btjk,jk->btj", torch.einsum("btjh,btkh->btjk", coses, a_scaled), w)
    dl_win = torch.einsum("btj,jk->btk", g3 * harm, w)
    d_amps, d_loud = overlap_add_windows(da_win, dl_win, t)
    return ql * dphi, d_amps, d_loud


def _check(phase, amps_pad, loud_pad, h_start, g=None) -> None:
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, T, hop), got {tuple(phase.shape)}")
    b, t, hop = phase.shape
    h = amps_pad.shape[-1] if amps_pad.dim() == 3 else -1
    want = {"amps_pad": (b, t + 2, h), "loud_pad": (b, t + 2)}
    for name, x in (("amps_pad", amps_pad), ("loud_pad", loud_pad)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")
    if g is not None and tuple(g.shape) != (b, t * hop):
        raise ValueError(f"g must be {(b, t * hop)}, got {tuple(g.shape)}")
    if h < 1 or h_start < 0 or h_start + h > MAX_HARMONICS:
        raise ValueError(
            f"harmonics {h_start + 1}..{h_start + h} outside [1, {MAX_HARMONICS}]"
        )
    tensors = [phase, amps_pad, loud_pad] + ([] if g is None else [g])
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("osc_frames kernels take CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("osc_frames inputs lie on different devices")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("osc_frames kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("osc_frames kernels take contiguous tensors only")
    if b > MAX_BATCH:
        raise ValueError(f"B={b} exceeds {MAX_BATCH}")
    if t * -(-hop // 128) >= 2**31:
        raise ValueError(f"T={t} frames of {hop} samples exceed the grid")


def _launch_options(fill, resync_tiles, chunk_tiles):
    fill, resync_tiles, chunk_tiles = fill_options(fill, resync_tiles, chunk_tiles)
    return (_FILL_CODES[fill], resync_tiles,
            _WHOLE_BANK if chunk_tiles is None else chunk_tiles)


def osc_frames_fwd(phase, amps_pad, loud_pad, h_start: int = 0, fill: str = "exact",
                   bf16: bool = False, resync_tiles: int = 8,
                   chunk_tiles: Optional[int] = None) -> torch.Tensor:
    """Launch the forward kernel: (B, T, hop), (B, T+2, H), (B, T+2) ->
    (B, T*hop) float32 audio.  CUDA tensors only."""
    global FWD_LAUNCHES
    _check(phase, amps_pad, loud_pad, h_start)
    code, resync, chunk = _launch_options(fill, resync_tiles, chunk_tiles)
    b, t, hop = phase.shape
    device = phase.device
    w = hop_weights_on(hop, device)
    out = torch.empty((b, t * hop), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_frames_fwd(
            phase.data_ptr(), amps_pad.data_ptr(), loud_pad.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            b, t, hop, amps_pad.shape[-1], int(h_start), code, int(bool(bf16)),
            resync, chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_frames_fwd launch failed: CUDA error {rc}")
    FWD_LAUNCHES += 1
    VARIANT_LAUNCHES[variant_name("osc_frames_fwd", fill, bf16, resync_tiles, chunk_tiles)] += 1
    return out


def osc_frames_bwd_windows(
    g, phase, amps_pad, loud_pad, h_start: int = 0, fill: str = "exact",
    bf16: bool = False, resync_tiles: int = 8, chunk_tiles: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel alone for the audio gradient ``g``
    (B, T*hop): (dphase (B, T, hop), da_win (B, T, 3, H), dl_win (B, T, 3)),
    the gradients of each frame's three windows.  CUDA tensors only."""
    global BWD_LAUNCHES
    _check(phase, amps_pad, loud_pad, h_start, g)
    code, resync, chunk = _launch_options(fill, resync_tiles, chunk_tiles)
    b, t, hop = phase.shape
    h = amps_pad.shape[-1]
    device = phase.device
    w = hop_weights_on(hop, device)
    dphase = torch.empty_like(phase)
    da_win = torch.empty((b, t, 3, h), dtype=torch.float32, device=device)
    dl_win = torch.empty((b, t, 3), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_frames_bwd(
            g.data_ptr(), phase.data_ptr(), amps_pad.data_ptr(),
            loud_pad.data_ptr(), w.data_ptr(), dphase.data_ptr(),
            da_win.data_ptr(), dl_win.data_ptr(),
            b, t, hop, h, int(h_start), code, int(bool(bf16)), resync, chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"osc_frames_bwd launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    VARIANT_LAUNCHES[variant_name("osc_frames_bwd", fill, bf16, resync_tiles, chunk_tiles)] += 1
    return dphase, da_win, dl_win


def osc_overlap_add(da_win, dl_win, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the overlap-add kernel: :func:`overlap_add_windows` (its plain
    version) in one launch, with the same float additions in the same
    order, so bit-equal to it.  CUDA tensors only."""
    global OVERLAP_LAUNCHES
    b, t_win, k, h = da_win.shape
    if (t_win, k) != (t, 3) or tuple(dl_win.shape) != (b, t, 3):
        raise ValueError(f"window gradients {tuple(da_win.shape)}, {tuple(dl_win.shape)} "
                         f"are not (B, {t}, 3, H), (B, {t}, 3)")
    if any(x.device.type != "cuda" for x in (da_win, dl_win)):
        raise ValueError("osc_frames kernels take CUDA tensors only")
    if da_win.device != dl_win.device:
        raise ValueError("osc_overlap_add inputs lie on different devices")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in (da_win, dl_win)):
        raise ValueError("osc_overlap_add takes contiguous float32 tensors only")
    device = da_win.device
    d_amps = torch.empty((b, t + 2, h), dtype=torch.float32, device=device)
    d_loud = torch.empty((b, t + 2), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.osc_frames_overlap_add(da_win.data_ptr(), dl_win.data_ptr(),
                                        d_amps.data_ptr(), d_loud.data_ptr(), b, t, h, stream)
    if rc != 0:
        raise RuntimeError(f"osc_frames_overlap_add launch failed: CUDA error {rc}")
    OVERLAP_LAUNCHES += 1
    return d_amps, d_loud


def osc_frames_bwd(
    g, phase, amps_pad, loud_pad, h_start: int = 0, fill: str = "exact",
    bf16: bool = False, resync_tiles: int = 8, chunk_tiles: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel and the overlap-add kernel for the audio
    gradient ``g`` (B, T*hop): (dphase (B, T, hop), d amps_pad (B, T+2, H),
    d loud_pad (B, T+2)).  CUDA tensors only."""
    dphase, da_win, dl_win = osc_frames_bwd_windows(
        g, phase, amps_pad, loud_pad, h_start, fill, bf16, resync_tiles, chunk_tiles)
    return (dphase, *osc_overlap_add(da_win, dl_win, phase.shape[1]))


class OscFrames(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient, both on
    one ``fill``; the backward contracts in bf16 when the contract dtype
    was 'bfloat16' as the forward ran.  The gradient with respect to
    ``h_start`` is none (``_render_h``'s VJP returns zeros for it)."""

    @staticmethod
    def forward(ctx, phase, amps_pad, loud_pad, h_start: int, fill: str):
        ctx.save_for_backward(phase, amps_pad, loud_pad)
        ctx.h_start, ctx.fill = h_start, fill
        ctx.bf16 = _BWD_CONTRACT_DTYPE == "bfloat16"
        return osc_frames_fwd(phase, amps_pad, loud_pad, h_start, fill=fill)

    @staticmethod
    def backward(ctx, g):
        phase, amps_pad, loud_pad = ctx.saved_tensors
        dphase, d_amps, d_loud = osc_frames_bwd(
            g.contiguous(), phase, amps_pad, loud_pad, ctx.h_start, fill=ctx.fill,
            bf16=ctx.bf16,
        )
        return dphase, d_amps, d_loud, None, None


class OscFramesPlain(torch.autograd.Function):
    """CPU: the plain forward of ``fill`` with the plain backward of the
    same fill, written out as the kernels' three contractions (with the
    bf16 casts under ``set_osc_bwd_contract_dtype('bfloat16')``): what the
    JAX package's ``_render_h`` computes in Pallas interpret mode."""

    @staticmethod
    def forward(ctx, phase, amps_pad, loud_pad, h_start: int, fill: str):
        ctx.save_for_backward(phase, amps_pad, loud_pad)
        ctx.h_start, ctx.fill = h_start, fill
        ctx.bf16 = _BWD_CONTRACT_DTYPE == "bfloat16"
        if fill == "exact":
            return render_from_phase_plain(phase, amps_pad, loud_pad, h_start)
        return render_from_phase_variant_plain(phase, amps_pad, loud_pad, h_start, fill)

    @staticmethod
    def backward(ctx, g):
        phase, amps_pad, loud_pad = ctx.saved_tensors
        grads = render_from_phase_bwd_variant_plain(
            g, phase, amps_pad, loud_pad, ctx.h_start, fill=ctx.fill, bf16=ctx.bf16
        )
        return (*grads, None, None)


def render_from_phase(
    phase: torch.Tensor,
    amps_pad: torch.Tensor,
    loud_pad: torch.Tensor,
    h_start: int = 0,
    fill: str = "exact",
) -> torch.Tensor:
    """(B, T, hop) phase, (B, T+2, H) amps, (B, T+2) loudness -> (B, T*hop),
    on the sine ``fill`` ('exact' or 'rot', forward and backward).

    CUDA tensors go through :class:`OscFrames` (the kernel pair); CPU
    tensors take :func:`render_from_phase_plain` with ordinary autograd on
    the exact fill and float32 contractions, else :class:`OscFramesPlain`;
    any other device raises.
    """
    if fill not in ("exact", "rot"):
        raise ValueError(f"render_from_phase fills 'exact' or 'rot', got {fill!r}")
    device = phase.device
    if device.type == "cpu":
        if fill == "exact" and _BWD_CONTRACT_DTYPE is None:
            return render_from_phase_plain(phase, amps_pad, loud_pad, h_start)
        return OscFramesPlain.apply(phase, amps_pad, loud_pad, int(h_start), fill)
    if device.type != "cuda":
        raise ValueError(f"render_from_phase: unsupported device {device}")
    return OscFrames.apply(
        phase.contiguous(), amps_pad.contiguous(), loud_pad.contiguous(),
        int(h_start), fill,
    )
