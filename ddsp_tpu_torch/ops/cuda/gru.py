"""The GRU's time recurrence over a whole sequence: CUDA gate kernels for
Hopper and a hand-written backward.

Counterpart of ``ddsp_tpu/models/nn.py:gru_apply``'s ``lax.scan``
(no Pallas kernel: XLA fuses the scan's step on the TPU).  The caller
computes the input projection ``gi = x W_ih^T + b_ih`` for every step in
one matmul, under autograd; this module runs the recurrence on it, torch
gate order (reset, update, new):

* ``gru_sequence(gi, h0, w_hh, b_hh)`` -- the entry: gi (B, T, 3H), h0
  (B, H) -> (outputs (B, T, H), last hidden (B, H)).  A step is one fp32
  ``torch.addmm`` for ``gh = h W_hh^T + b_hh`` and one launch of
  ``gru_gates_fwd`` (``csrc/gru_gates.cu``).  When a gradient is wanted
  (grad mode on and an input requiring it) the sequence is one autograd
  node that keeps r, z, n and ``gh_n`` a step; its backward walks t from
  T-1 down to 0, a step one launch of ``gru_gates_bwd`` and one
  ``addmm`` for the carried ``dh``, and after the loop forms
  ``dW_hh = dgh^T [h0, h_1 .. h_{T-1}]`` and ``db_hh`` in one product
  and one sum; ``dgi`` goes back through autograd to x, W_ih and b_ih.
  Without a gradient nothing is kept.  CUDA tensors launch the kernels;
  CPU tensors take the plain version; anything else raises.
* ``gru_sequence_plain`` -- the plain version on any device: the same
  loop and backward with the gate arithmetic in torch ops, in the order
  the kernels round it.
* ``FWD_LAUNCHES``, ``BWD_LAUNCHES`` count kernel launches and nothing
  else: T of each per call and layer.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ddsp_tpu_torch.ops.cuda import build as _build
from ddsp_tpu_torch.utils.profiling import check_kernel_output

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gru_gates_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "gru_gates_bwd": [_P, _L, _L] + [_P] * 6 + [_I] * 4 + [_P],
}
MAX_ROWS = (2**31 - 1) * 256  # B * H: the kernels' one-dimensional grid


def _library() -> ctypes.CDLL:
    return _build.library("gru_gates", _SIGNATURES)


def gates_fwd_plain(gi_t: torch.Tensor, gh: torch.Tensor, h: torch.Tensor):
    """One step's gates: gi_t, gh (B, 3H), h (B, H) -> (h_t, r, z, n)."""
    i_r, i_z, i_n = gi_t.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h, r, z, n


def gates_bwd_plain(dh, r, z, n, hn, hp):
    """One step's backward from dh = dL/dh_t: -> (dgi_t, dgh_t, dh z), the
    pre-activation gradients (B, 3H) of gi and gh and the direct path to
    h_{t-1}."""
    omz = 1.0 - z
    dz = dh * (hp - n)
    da_n = dh * omz * (1.0 - n * n)
    da_r = da_n * hn * (1.0 - r) * r
    da_z = dz * omz * z
    return (torch.cat([da_r, da_z, da_n], -1), torch.cat([da_r, da_z, da_n * r], -1), dh * z)


def _check(gi, h0, w_hh, b_hh) -> Tuple[int, int, int]:
    if gi.dim() != 3 or gi.shape[-1] % 3:
        raise ValueError(f"gi must be (B, T, 3H), got {tuple(gi.shape)}")
    b, t, h3 = gi.shape
    h = h3 // 3
    for name, x, want in (("h0", h0, (b, h)), ("w_hh", w_hh, (h3, h)), ("b_hh", b_hh, (h3,))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
    if t < 1:
        raise ValueError("gi has no time step")
    if len({x.device for x in (gi, h0, w_hh, b_hh)}) != 1:
        raise ValueError("gru_sequence inputs lie on different devices")
    return b, t, h


def _plain_for(device: torch.device) -> bool:
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"gru_sequence: unsupported device {device}")
    return False


def _kernel_operands(*tensors) -> None:
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("the GRU gate kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the GRU gate kernels take contiguous tensors only")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(gi, h0, w_hh, b_hh, plain: bool, save: bool):
    """(outputs (B, T, H), the gate planes (4, B, T, H) or None)."""
    global FWD_LAUNCHES
    b, t, h = _check(gi, h0, w_hh, b_hh)
    out = gi.new_empty((b, t, h))
    gates = gi.new_empty((4, b, t, h)) if save else None
    gh = gi.new_empty((b, 3 * h))
    w_t = w_hh.t()
    prev = (h0, *out.unbind(1)[:-1])  # h_{t-1} a step, views made once
    if plain:
        for i in range(t):
            torch.addmm(b_hh, prev[i], w_t, out=gh)
            h_t, r, z, n = gates_fwd_plain(gi[:, i], gh, prev[i])
            out[:, i] = h_t
            if save:
                for k, g in enumerate((r, z, n, gh[:, 2 * h:])):
                    gates[k, :, i] = g
        return out, gates
    _kernel_operands(gi, h0)
    if b * h > MAX_ROWS:
        raise ValueError(f"B * H = {b * h} exceeds the grid")
    fn, stream = _library().gru_gates_fwd, _stream(gi.device)
    gi_p, gh_p, h0_p, out_p = gi.data_ptr(), gh.data_ptr(), h0.data_ptr(), out.data_ptr()
    gates_p = gates.data_ptr() if save else None
    with torch.cuda.device(gi.device):
        for i in range(t):
            torch.addmm(b_hh, prev[i], w_t, out=gh)
            rc = fn(gi_p, gh_p, h0_p, out_p, gates_p, b, t, h, i, stream)
            if rc != 0:
                raise RuntimeError(f"gru_gates_fwd launch failed: CUDA error {rc}")
    FWD_LAUNCHES += t
    check_kernel_output("gru_gates_fwd", out)
    return out, gates


def _backward(d_out, d_last, out, gates, h0, w_hh, plain: bool, need_h0: bool):
    """(dgi, dgh) (B, T, 3H) and dL/dh0 (B, H) or None, over t from T-1
    down to 0."""
    global BWD_LAUNCHES
    _, b, t, h = gates.shape
    dgi = out.new_empty((b, t, 3 * h))
    dgh = torch.empty_like(dgi)
    carry = out.new_zeros((b, h)) if d_last is None else d_last.clone(
        memory_format=torch.contiguous_format)
    dgh_t = dgh.unbind(1)
    if plain:
        prev = (h0, *out.unbind(1)[:-1])
        for i in reversed(range(t)):
            dh = carry if d_out is None else carry + d_out[:, i]
            dgi[:, i], dgh[:, i], carry = gates_bwd_plain(dh, *gates[:, :, i], prev[i])
            if i or need_h0:
                carry.addmm_(dgh_t[i], w_hh)
        return dgi, dgh, carry if need_h0 else None
    if d_out is not None and d_out.stride(-1) != 1:
        d_out = d_out.contiguous()
    _kernel_operands(carry, gates, h0, out)
    fn, stream = _library().gru_gates_bwd, _stream(out.device)
    dy_p = None if d_out is None else d_out.data_ptr()
    dy_sb, dy_st = (0, 0) if d_out is None else (d_out.stride(0), d_out.stride(1))
    ptrs = (carry.data_ptr(), gates.data_ptr(), h0.data_ptr(), out.data_ptr(), dgi.data_ptr(),
            dgh.data_ptr())
    with torch.cuda.device(out.device):
        for i in reversed(range(t)):
            rc = fn(dy_p, dy_sb, dy_st, *ptrs, b, t, h, i, stream)
            if rc != 0:
                raise RuntimeError(f"gru_gates_bwd launch failed: CUDA error {rc}")
            if i or need_h0:
                carry.addmm_(dgh_t[i], w_hh)
    BWD_LAUNCHES += t
    check_kernel_output("gru_gates_bwd", dgi, dgh)
    return dgi, dgh, carry if need_h0 else None


class _GRUSequence(torch.autograd.Function):
    """The recurrence as one autograd node over the whole sequence."""

    @staticmethod
    def forward(ctx, gi, h0, w_hh, b_hh, plain: bool):
        ctx.set_materialize_grads(False)
        out, gates = _forward(gi, h0, w_hh, b_hh, plain, save=True)
        ctx.save_for_backward(out, gates, h0, w_hh)
        ctx.plain = plain
        return out, out[:, -1].clone()

    @staticmethod
    def backward(ctx, d_out, d_last):
        out, gates, h0, w_hh = ctx.saved_tensors
        if d_out is None and d_last is None:
            return None, None, None, None, None
        need = ctx.needs_input_grad
        dgi, dgh, dh0 = _backward(d_out, d_last, out, gates, h0, w_hh, ctx.plain, need[1])
        d_w_hh = d_b_hh = None
        if need[2]:
            b, t, h = out.shape
            prev = torch.cat([h0[:, None], out[:, :-1]], 1)  # h_{t-1} a step
            d_w_hh = dgh.reshape(b * t, 3 * h).t() @ prev.reshape(b * t, h)
        if need[3]:
            d_b_hh = dgh.sum((0, 1))
        return dgi, dh0, d_w_hh, d_b_hh, None


def _run(gi, h0, w_hh, b_hh, plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and any(x.requires_grad for x in (gi, h0, w_hh, b_hh)):
        return _GRUSequence.apply(gi, h0, w_hh, b_hh, plain)
    out, _ = _forward(gi, h0, w_hh, b_hh, plain, save=False)
    return out, out[:, -1]


def gru_sequence(gi: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gi (B, T, 3H), h0 (B, H), w_hh (3H, H), b_hh (3H,) -> (outputs
    (B, T, H), last hidden (B, H)).  CUDA tensors launch the kernels; CPU
    tensors take :func:`gru_sequence_plain`'s arithmetic; anything else
    raises."""
    return _run(gi, h0.contiguous(), w_hh, b_hh, _plain_for(gi.device))


def gru_sequence_plain(gi: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_sequence` with the gate arithmetic in torch ops, on any
    device."""
    return _run(gi, h0.contiguous(), w_hh, b_hh, True)
