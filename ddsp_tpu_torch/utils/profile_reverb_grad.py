"""Time the reverb's forward and backward on both gradient routes.

    python -m ddsp_tpu_torch.utils.profile_reverb_grad [--batch=16]
        [--iters=10] [--rounds=2] [--device=cuda|cpu] [--out=FILE.json]

The port of ``scripts/profile_reverb_grad.py``.  At the full default
``Config()`` (a 44,100-tap IR over 88,064-sample examples) with a seeded
random reverb and a seeded (batch, example_length) signal x 0.1, it
measures d(sum(y sin y))/d(x, noise, decay, wet) of ``reverb_apply`` with
``reverb_grad_matmul_dtype`` 'float32' (plain autograd of the float32
``torch.fft`` convolution) and 'bfloat16' (the permuted-CT d/dsignal on
the S1 kernel, ``ops/fir.fft_convolve``), and the forward alone:

* ``<route>_ms``: device ms of one forward + backward (CUDA events over
  ``iters`` back-to-back calls after a warm-up), the routes interleaved
  f32, bf16, bf16, f32 in each of ``rounds`` rounds, the mean over runs;
  ``fwd_only_ms`` likewise; ``runs_ms`` every run;
* ``s1_launches_per_call``: S1's launches in one forward + backward of
  each route (1 on bf16, 0 on float32);
* gradient agreement of the bf16 route with the float32 one (SNR of
  d/dx and d/dnoise, relative error of d/ddecay and d/dwet).

``--device=cpu`` runs both routes once at batch 2 for the agreement
numbers only: no times.  Prints one JSON line and, given ``--out``,
writes it to that file.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.synths import reverb_apply, reverb_init
from ddsp_tpu_torch.ops.cuda import ct_conv as s1
from ddsp_tpu_torch.utils.ct_conv_ab import finite
from ddsp_tpu_torch.utils.profiling import card_name, microbench

ROUTES = ("float32", "bfloat16")


def fwd_bwd(reverb, x, conf):
    """Gradients of sum(y sin y), y = reverb_apply(x), w.r.t. x and the
    reverb's parameters."""
    leaf = x.detach().requires_grad_(True)
    y = reverb_apply(reverb, leaf, conf)
    return torch.autograd.grad((y * torch.sin(y)).sum(),
                               [leaf, reverb.noise, reverb.decay, reverb.wet])


def run(device, batch: int, iters: int, rounds: int) -> Dict:
    confs = {r: Config(reverb_grad_matmul_dtype=r) for r in ROUTES}
    reverb = reverb_init(confs["float32"], seed=0).to(device)
    rng = np.random.default_rng(0)
    x = torch.tensor(0.1 * rng.standard_normal((batch, confs["float32"].example_length)),
                     dtype=torch.float32, device=device)
    out: Dict = dict(batch=batch, length=x.shape[-1], ir_taps=confs["float32"].ir_length)
    grads = {}
    for r in ROUTES:
        before = s1.LAUNCHES
        grads[r] = [g.detach().double().cpu() for g in fwd_bwd(reverb, x, confs[r])]
        out[f"s1_launches_per_call_{r}"] = s1.LAUNCHES - before
    ref, got = grads["float32"], grads["bfloat16"]

    def snr(a, b):
        return float(10 * torch.log10(a.pow(2).mean() / (a - b).pow(2).mean()))

    out["bf16_vs_f32"] = dict(
        dx_snr_db=snr(ref[0], got[0]), dnoise_snr_db=snr(ref[1], got[1]),
        ddecay_rel=float((got[2] - ref[2]).abs() / ref[2].abs()),
        dwet_rel=float((got[3] - ref[3]).abs() / ref[3].abs()))
    if device.type != "cuda":
        return out
    fns = {r: (lambda c=confs[r]: fwd_bwd(reverb, x, c)) for r in ROUTES}

    def fwd_only():
        with torch.no_grad():
            return reverb_apply(reverb, x, confs["float32"])

    fns["fwd_only"] = fwd_only
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for name in ("float32", "bfloat16", "bfloat16", "float32", "fwd_only"):
            runs[name].append(microbench(fns[name], (), iters=iters, warmup=3)["ms"])
    for name, ms in runs.items():
        out[f"{name}_ms"] = float(np.mean(ms))
    out["runs_ms"] = runs
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch = args.batch or (Config().batch_size if device.type == "cuda" else 2)
    result = run(device, batch, args.iters, args.rounds)
    result["device"] = card_name(device)
    line = json.dumps(finite(result))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
