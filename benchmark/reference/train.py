"""The first optimizer steps of decoder training by the plain reference:
its forward pass, torch autograd for the gradients, and Adam.

The loss is a mean over the batch of per-example terms, so each step runs
in blocks of rows, adding each block's share of the gradient; the
reverb's impulse, shared by every row, takes the sum.  The noise of row
b is keyed by derive(step key, b) over the example's samples, the step's
key being the second of the two keys that the training key splits into,
the first carrying on to the next step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import dsp, threefry

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def decode(wd, conf: dict, f0, cents, loud, noise_key, rows: torch.Tensor):
    """Controls -> harmonics + filtered noise -> reverb, (B, T hop)."""
    hop, sr = conf["hop_length"], conf["sample_rate"]
    ctl, _ = dsp.controls(wd, conf, cents, loud)

    def pad(v):  # the edges repeat the first and last frames
        return torch.cat([v[:, :1], v, v[:, -1:]], 1)

    harm, _ = dsp.harmonic(pad(f0), pad(ctl["c"]), pad(ctl["a"]), sr, hop)
    b, t = f0.shape[:2]
    keys = threefry.derive(noise_key, rows)
    samples = torch.arange(t * hop, device=f0.device).expand(b, t * hop)
    noise = threefry.uniform_pm1(keys, samples).reshape(b, t, hop)
    dry = harm + dsp.filtered_noise(ctl["H"], noise)
    ir = dsp.reverb_ir(wd, conf["reverb_length"] or sr, sr)
    return dsp.causal_convolve(dry, ir)


def block_loss(wd: Dict[str, torch.Tensor], conf: dict, batch: Dict[str, torch.Tensor],
               rows: slice, noise_key) -> torch.Tensor:
    audio = batch["audio"][rows]
    f0, cents, loud = batch["f0"][rows], batch["normalized_cents"][rows], batch["loudness"][rows]
    idx = torch.arange(rows.start, rows.stop, device=audio.device)
    pred = decode(wd, conf, f0, cents, loud, noise_key, idx)
    return dsp.mss_loss(pred, audio, conf["mss_ffts"], conf["mss_overlap"], conf["mss_alpha"])


def steps(params0: Dict[str, torch.Tensor], conf: dict, batches: List[Dict[str, torch.Tensor]],
          key: torch.Tensor, block: int = 8, block_loss=block_loss) -> dict:
    """Adam steps (lr ``conf['learning_rate']``) from ``params0`` on
    ``batches`` in turn, the training key ``key`` split once a step, each
    loss ``block_loss(params, conf, batch, rows, noise_key)`` over blocks of
    ``block`` rows.  Returns {'loss': [..], 'grad1': {leaf: first gradient},
    'change': {leaf: params after the last step - params0}}."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = conf["learning_rate"]
    losses, grad1 = [], None
    for step, batch in enumerate(batches, start=1):
        keys = threefry.derive(key, torch.arange(2, device=key.device))
        key, noise_key = keys[0], keys[1]
        n = batch["audio"].shape[0]
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for i in range(0, n, block):
            rows = slice(i, min(n, i + block))
            loss = block_loss(params, conf, batch, rows, noise_key) * (
                (rows.stop - rows.start) / n)
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for name, g in zip(params, got):
                if g is not None:
                    grads[name] += g
            total += float(loss.detach())
        losses.append(total)
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            bc1, bc2 = 1 - ADAM_B1 ** step, 1 - ADAM_B2 ** step
            for name, p in params.items():
                g = grads[name]
                mu[name].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                nu[name].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                p -= lr * (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + ADAM_EPS)
    change = {k: (params[k].detach() - params0[k]) for k in params}
    return {"loss": losses, "grad1": grad1, "change": change}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: math.sqrt(float((v.double() ** 2).sum())) for k, v in tensors.items()}
