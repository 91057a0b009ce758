"""Race the permuted-CT convolution kernel S1 against its plain version and
cuFFT.

    python -m ddsp_tpu_torch.utils.ct_conv_ab [--rows=16] [--n=98304]
        [--iters=20] [--device=cuda|cpu] [--out=FILE.json]

The port of ``scripts/ab_ct_conv_kernel.py``.  At the reverb backward's
training shape (16 complex rows of n = 98,304, (n1, n2) = (384, 256);
``rows`` and ``n`` change it) with seeded random rows and the permuted
spectrum of a full-length random kernel x 0.1, as that script makes them:

* S1 (``ops/cuda/ct_conv.ct_conv``), its plain version
  (``ct_conv_plain``) and cuFFT's ``ifft(fft(z) * K)`` (the same function
  on the natural-order spectrum; the port never calls it), each timed with
  CUDA events over ``iters`` back-to-back calls after a warm-up, in the
  order plain, kernel, cuFFT, cuFFT, kernel, plain (``ms`` the mean of a
  name's two runs);
* SNRs: kernel against plain on every row, and kernel, plain and cuFFT
  against a float64 FFT convolution on two rows; whether two kernel runs
  are bit-equal;
* ``bound_ms``: ``utils/roofline.ct_conv_bound_ms``, the larger of 16 n
  (n1 + n2) flops a row at the 989 TFLOP/s bf16 dense peak and the bytes
  moved (rows in and out, the spectrum in: 4 (4 rows n + 2 n)) at 3.35
  TB/s (H100 SXM, 700 W).

``--device=cpu`` runs the wrapper's CPU path (the plain version) at n =
6144 by default, for the SNRs only: no times.  Prints one JSON line and,
given ``--out``, writes it to that file.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.ops import fft
from ddsp_tpu_torch.ops.cuda import ct_conv as s1
from ddsp_tpu_torch.utils.profiling import card_name, microbench
from ddsp_tpu_torch.utils.roofline import ct_conv_bound_ms


def operands(rows: int, n: int, device, seed: int = 0):
    """(zr, zi, kr, ki, k): seeded complex rows (rows, n), the permuted
    spectrum (1, n) of a random kernel k (n,) x 0.1 formed in float64
    (P[k1, k2] = K[k1 + n1 k2]), all float32 on ``device``; k in numpy."""
    rng = np.random.default_rng(seed)
    zr = rng.standard_normal((rows, n)).astype(np.float32)
    zi = rng.standard_normal((rows, n)).astype(np.float32)
    k = (0.1 * rng.standard_normal(n)).astype(np.float32)
    n1, n2 = fft._split_factors(n)
    spec = np.fft.fft(k.astype(np.float64)).reshape(n2, n1).T.reshape(1, n)
    arrays = (zr, zi, spec.real, spec.imag)
    return (*(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays), k)


def natural_spectrum(kr, ki, n: int) -> torch.Tensor:
    """The permuted spectrum back in natural order, complex64 (n,)."""
    n1, n2 = fft._split_factors(n)
    return torch.complex(kr, ki).reshape(n1, n2).T.reshape(n)


def library_conv(z: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """cuFFT's convolution of complex rows z with the spectrum (timed beside
    S1, never called by the port)."""
    return torch.fft.ifft(torch.fft.fft(z) * spec)


def snr_db(ref, est) -> float:
    ref = np.asarray(ref, np.complex128)
    noise = np.mean(np.abs(ref - np.asarray(est, np.complex128)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(np.abs(ref) ** 2) / noise))


def race(device, rows: int, n: int, iters: int = 20, seed: int = 0) -> Dict:
    """The agreement numbers and, on CUDA, the times described above."""
    zr, zi, kr, ki, k = operands(rows, n, device, seed)
    y = s1.ct_conv(zr, zi, kr, ki, n)
    again = s1.ct_conv(zr, zi, kr, ki, n)
    plain = s1.ct_conv_plain(zr, zi, kr, ki, n)
    spec = natural_spectrum(kr, ki, n)
    z = torch.complex(zr, zi)
    lib = library_conv(z, spec)
    got, want = (torch.complex(*p).cpu().numpy() for p in (y, plain))
    z64 = zr[:2].double().cpu().numpy() + 1j * zi[:2].double().cpu().numpy()
    oracle = np.fft.ifft(np.fft.fft(z64) * np.fft.fft(k.astype(np.float64)))
    out = dict(
        rows=rows, n=n, n1n2=list(fft._split_factors(n)),
        finite=bool(np.isfinite(got).all()),
        bit_equal=bool(torch.equal(y[0], again[0]) and torch.equal(y[1], again[1])),
        snr_plain_db=snr_db(want, got),
        max_abs_err=float(np.abs(got - want).max()),
        snr_f64_db=snr_db(oracle, got[:2]),
        plain_snr_f64_db=snr_db(oracle, want[:2]),
        library_snr_f64_db=snr_db(oracle, lib[:2].cpu().numpy()),
    )
    out["bound_ms"], out["bound_by"] = ct_conv_bound_ms(rows, n)
    if device.type != "cuda":
        out["ms"] = out["plain_ms"] = out["library_ms"] = None  # not measured
        return out
    fns = {"plain": lambda: s1.ct_conv_plain(zr, zi, kr, ki, n),
           "kernel": lambda: s1.ct_conv(zr, zi, kr, ki, n),
           "library": lambda: library_conv(z, spec)}
    times = {name: [] for name in fns}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        times[name].append(microbench(fns[name], (), iters=iters, warmup=3)["ms"])
    out["ms"], out["plain_ms"], out["library_ms"] = (
        float(np.mean(times[name])) for name in ("kernel", "plain", "library"))
    out["runs_ms"] = times
    return out


def finite(x):
    """``x`` with every non-finite float as None (strict JSON): an SNR of
    inf, the CPU path against itself, prints as null."""
    if isinstance(x, float):
        return x if np.isfinite(x) else None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--n", type=int)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.n or (98304 if device.type == "cuda" else 6144)
    result = race(device, args.rows, n, args.iters)
    result["device"] = card_name(device)
    line = json.dumps(finite(result))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
