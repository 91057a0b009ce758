"""Whether a run's outputs are correct: the numbers that compare the
program with the plain reference, each held to its limit in
``benchmark/limits/<workload>.json``.

Serving, over every call of the sampled slots:
* ``crepe_gap``: the widest amount by which the reference's CREPE
  activation at a served pitch bin lies below its best bin (inf where a
  served f0 is no bin's);
* ``phase_step``: the largest difference, in cycles, between the
  fundamental phase the program advanced by in a hop and the exact
  advance of that hop's f0 (and the phase the first call leaves, 0);
* ``audio_err``: the largest RMS difference of a served hop from the
  reference's, rendered from the same served bins and starting phases, as
  a share of the slot's RMS.

Training, after the first steps of the window's own training object
against the reference's steps from the same weights:
* ``loss_step1``: the first step's loss, relative;
* ``loss_later``: the later steps' losses, the worst, relative;
* ``grad_leaf``: of every leaf, the gap between the norms of the first
  step's gradient (the program's worked out from its Adam moment) and
  the reference's, against the larger of that leaf's reference norm and
  the median leaf's; the worst leaf;
* ``change_leaf``: the same for the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (Adam moves those by rounding alone).
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch


def serving_numbers(out: np.ndarray, phase: torch.Tensor, ref: dict) -> Dict[str, float]:
    """out (S, K, hop) and phase (S, K): the program's outputs and the
    phase it carried after each call; ``ref``: the reference's replay
    (``reference/serve.replay``) that followed them."""
    r = ref["out"].double().cpu().numpy()
    diff = np.sqrt(((out.astype(np.float64) - r) ** 2).mean(-1))  # (S, K)
    rms = np.sqrt((r ** 2).mean(axis=(1, 2)))  # (S,)
    ph = phase.double()
    step = ph[:, 1:] - ph[:, :-1] - ref["advance"].to(ph.device)
    step = torch.cat([ph[:, :1], step], 1)  # the first call leaves the phase at 0
    return {"crepe_gap": float(ref["gap"].max()),
            "phase_step": float((step - torch.round(step)).abs().max()),
            "audio_err": float((diff / rms[:, None]).max())}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep=None) -> Tuple[float, str]:
    med = statistics.median(ref.values())
    worst = (0.0, "")
    for name, r in ref.items():
        if keep is not None and name not in keep:
            continue
        p = prog.get(name, float("nan"))
        v = abs(p - r) / max(r, med) if med > 0 else float("inf")
        if not v <= worst[0]:  # a NaN is the worst
            worst = (v, name)
    return worst


def training_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """prog and ref: {'loss': [...], 'grad1': {leaf: norm}, 'change':
    {leaf: norm}}.  Returns (numbers, the worst leaf of each leaf number)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(float("inf"))
    med = statistics.median(ref["grad1"].values())
    moving = {k for k, v in ref["grad1"].items() if v >= 1e-3 * med}
    g, g_leaf = _worst_leaf(prog["grad1"], ref["grad1"])
    c, c_leaf = _worst_leaf(prog["change"], ref["change"], keep=moving)
    nums = {"loss_step1": losses[0], "loss_later": max(losses[1:], default=0.0),
            "grad_leaf": g, "change_leaf": c}
    return nums, {"grad_leaf": g_leaf, "change_leaf": c_leaf}


@contextlib.contextmanager
def tf32():
    """Float32 matmuls and cuDNN convolutions on TF32, restored after: the
    control's precision, the nearest below the configurations' float32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# a limits file's entry for a number that is reported and not judged: one
# with no upper reading, on seeds that read alike (PERF.md says which)
NOT_COMPARED = "not compared"


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[list]]:
    """(correct, [[name, value, limit], ...]): every number at or under its
    limit; a number without a limit, or not finite, fails; one whose limit
    is ``NOT_COMPARED`` is reported only."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit == NOT_COMPARED or (
            isinstance(limit, (int, float)) and math.isfinite(value) and value <= limit)
        ok &= good
        rows.append([name, value, limit])
    return ok, rows
