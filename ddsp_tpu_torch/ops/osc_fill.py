"""Sine (and cosine) bank fills of the oscillator kernels, in plain torch.

Counterpart of the bank fills of ``ddsp_tpu/ops/pallas/oscillator.py``,
which the variant kernels K1/K2 (fill options), K6 and S2 run:

* ``'exact'``: every harmonic's split-precision phase and its sine, as
  ``harmonic_sines`` (the port's default K1/K2);
* ``'rot'``: ``_fill_sine_banks_cat`` / ``_fill_sine_banks_cat_range``
  (``:58``, ``:237``): tiles of 8 consecutive harmonics; the first tile of
  each chunk is seeded exactly, every later tile is the previous one
  rotated by the rotor ``e^{i 2 pi 8 x}``;
* ``'rot4'``: ``_fill_sine_banks_rot_logdepth`` (``:266``) with span 4,
  which seeds tiles 0, 4, 8, ... exactly and rotates within each span:
  the same values as ``'rot'`` with chunks of 4 tiles;
* ``'cheb8'``: ``_fill_sine_banks_cheb8`` (``:104``): the tile-level
  three-term recurrence ``sin((h+8)x) = 2 cos(8x) sin(hx) - sin((h-8)x)``
  (and the same for the cosine), with two consecutive exact seed tiles
  whenever ``(g - g0) % resync_tiles < 2`` for a chunk starting at tile
  ``g0``.

``chunk_tiles`` is the JAX package's ``k_chunk // 8`` (at least 1): each
chunk of that many tiles starts from an exact seed.  ``h_start`` offsets
the harmonic numbers (row i is harmonic ``h_start + i + 1``).

Every operation rounds as the JAX code does, one IEEE operation at a time
(no fused multiply-add), so the CUDA device functions (``csrc/osc_fill.cuh``)
reproduce these values up to the last bit of their seeds' sines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ddsp_tpu_torch.ops.oscillator import QUANT, TWO_PI

FILLS = ("exact", "rot", "rot4", "cheb8")
TILE = 8  # harmonics per tile


def split_phase(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo with hi on the 1/4096 grid."""
    hi = torch.floor(x * QUANT) * (1.0 / QUANT)
    return hi, x - hi


def exact_sincos(hi: torch.Tensor, lo: torch.Tensor, hv) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of 2 pi h x by the split-precision product (``exact(hv)``
    of the JAX fills); ``hv`` broadcasts against ``hi``."""
    coarse = hi * hv  # exact: hi on the 1/4096 grid, hv integer <= 2048
    coarse = coarse - torch.floor(coarse)
    frac = coarse + lo * hv
    frac = frac - torch.floor(frac)
    a = TWO_PI * frac
    return torch.sin(a), torch.cos(a)


def fill_banks(
    phase: torch.Tensor,
    n_harmonics: int,
    h_start: int = 0,
    fill: str = "exact",
    resync_tiles: int = 8,
    chunk_tiles: Optional[int] = None,
    cos: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(sin, cos) banks (..., n_harmonics) of harmonics ``h_start + 1`` ...
    ``h_start + n_harmonics`` from the fundamental phase (..., ) in cycles,
    by ``fill``.  ``cos=False`` returns (sin, None)."""
    if fill not in FILLS:
        raise ValueError(f"fill must be one of {FILLS}, got {fill!r}")
    if fill == "rot4":
        if chunk_tiles is not None:
            raise ValueError("fill='rot4' is whole-bank only and takes no chunks")
        fill, chunk_tiles = "rot", 4
    groups = -(-n_harmonics // TILE)
    chunk = groups if chunk_tiles is None else max(1, int(chunk_tiles))
    hi, lo = (t[..., None] for t in split_phase(phase))
    k_row = torch.arange(TILE, dtype=phase.dtype, device=phase.device) + float(h_start)
    if fill == "exact":
        s, c = exact_sincos(hi, lo, torch.arange(
            1, n_harmonics + 1, dtype=phase.dtype, device=phase.device) + float(h_start))
        return s, (c if cos else None)
    s8, c8 = exact_sincos(hi, lo, 8.0)
    two_c8 = 2.0 * c8
    sins, coss = [], []
    s_t = c_t = s_p = c_p = s_pp = c_pp = None
    for g in range(groups):
        local = g % chunk
        if fill == "rot":
            if local == 0:
                s_t, c_t = exact_sincos(hi, lo, k_row + (1.0 + 8.0 * g))
            else:
                s_t, c_t = s_t * c8 + c_t * s8, c_t * c8 - s_t * s8
        else:  # cheb8
            if local % resync_tiles < 2:
                s_t, c_t = exact_sincos(hi, lo, k_row + (1.0 + 8.0 * g))
            else:
                s_t = two_c8 * s_p - s_pp
                c_t = two_c8 * c_p - c_pp
            s_pp, s_p, c_pp, c_p = s_p, s_t, c_p, c_t
        sins.append(s_t)
        coss.append(c_t)
    s = torch.cat(sins, dim=-1)[..., :n_harmonics]
    return s, (torch.cat(coss, dim=-1)[..., :n_harmonics] if cos else None)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)
