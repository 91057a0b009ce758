"""Threefry-2x32 (20 rounds; Salmon et al., SC'11) and the key handling of
jax's default PRNG, on int64 tensors holding uint32 words.

The program's noise is a pure function of (key, row, absolute sample):
each sample's word is the first output lane of the cipher on the counter
pair (sample, 0) under the row's key, whose top 24 bits map onto [-1, 1).
"""

from __future__ import annotations

import torch

M32 = (1 << 32) - 1
PARITY = 0x1BD11BDA
ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def cipher(k0, k1, c0, c1):
    """Both output words of threefry-2x32 for counter words (c0, c1) under
    key words (k0, k1); every argument an int64 tensor of uint32 values,
    broadcast together."""
    sched = (k0, k1, k0 ^ k1 ^ PARITY)
    a = (c0 + k0) & M32
    b = (c1 + k1) & M32
    for block in range(5):
        for r in ROT[4 * (block % 2): 4 * (block % 2) + 4]:
            a = (a + b) & M32
            b = _rotl32(b, r) ^ a
        a = (a + sched[(block + 1) % 3]) & M32
        b = (b + sched[(block + 2) % 3] + block + 1) & M32
    return a, b


def seed_key(seed: int, device=None) -> torch.Tensor:
    """jax's PRNGKey(seed): the 64-bit seed's high and low words."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def derive(key: torch.Tensor, data) -> torch.Tensor:
    """jax's fold_in(key, data), and split's key ``data``: the cipher on
    the counter words (0, data).  ``key`` (..., 2) -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    a, b = cipher(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a, b], dim=-1)


def uniform_pm1(row_keys: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Noise in [-1, 1): ``row_keys`` (R, 2), ``samples`` (R, L) absolute
    sample indices -> (R, L) float32."""
    word, _ = cipher(row_keys[:, :1], row_keys[:, 1:], samples & M32,
                     torch.zeros_like(samples))
    return (word >> 8).to(torch.float32) / float(1 << 23) - 1.0
