"""Where a train step's time goes on the GPU.

    python -m ddsp_tpu_torch.utils.profile_training [--steps=10]
        [--batch_size=16] [--stft_impl=auto|pallas] [--finetune]
        [--out=FILE.json]

At the full default ``Config()`` width with seeded random weights and a
seeded random feature batch (as ``chip_smoke.py`` drives it), one decoder
train step (``make_train_step``) or, with ``--finetune``, one
analysis-by-synthesis finetune step (``make_finetune_step`` with
``pitch_decode='weighted'``, CREPE and the decoder from
``init_finetune_state``, the batch's audio only).  ``--stft_impl`` sets
``ops/spectral.set_stft_impl`` first: 'pallas' puts the loss spectrograms
on the power-STFT kernels (the default bf16 ``loss_matmul_dtype``).

* ``wall_ms_median``: median host time of one ``make_train_step`` call
  ended by ``torch.cuda.synchronize()`` (what a training loop that reads
  its loss every step sees), and ``steps_per_s`` from it;
* a ``torch.profiler`` window over the same steps, unsynchronised, from
  which the card's busy share of the window's wall time (and so its idle
  share) and the launches per step are read;
* a second window with a ``synchronize()`` after each step, in which every
  device operation (kernel, copy or fill) is attributed to the labelled
  range (``encoder`` when finetuning, ``controller``, ``oscillator_bank``,
  ``filtered_noise``, ``reverb``, ``loss``, ``backward``, ``optimizer``;
  ``models/autoencoder.py``, ``models/controller.py`` and
  ``training/trainer.py``) whose host
  interval holds the CUDA runtime call that launched it, matched by
  correlation id.  Attribution goes by the launch's time and not by the
  profiler's call tree because the backward runs on autograd's device
  thread, outside the tree of the ``backward`` range, and the ``ctypes``
  kernels have no operator above them; operations launched outside every
  range (the key split) are ``other``.

Also: every hand kernel's launches per step, from the wrappers'
counters.
Prints one JSON line and, given ``--out``, writes it to that file.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ddsp_tpu_torch.ops.cuda import launch_counts

STAGES = ("encoder", "controller", "oscillator_bank", "filtered_noise", "reverb",
          "loss", "backward", "optimizer")


def _batch(conf, seed: int, device):
    rng = np.random.default_rng(seed)
    n, t = conf.batch_size, conf.frames_per_example
    arrays = {
        "f0": rng.uniform(100.0, 400.0, (n, t, 1)),
        "normalized_cents": rng.uniform(0.0, 1.0, (n, t, 1)),
        "loudness": rng.uniform(0.0, 1.0, (n, t, 1)),
        "audio": 0.1 * rng.standard_normal((n, conf.example_length)),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def _device_ops(prof):
    """(device operations, {correlation id: host start ns of the CUDA
    runtime call that launched it}) of a finished profiler window.  The
    device's copies of the range annotations are left out."""
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events
           if e.device_type() == DeviceType.CUDA and e.name() not in STAGES]
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith("cu")}
    return events, ops, launches


def profile(steps: int, batch_size: int, seed: int = 0, stft_impl: str = "auto",
            finetune: bool = False) -> dict:
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    device = resolve_device("cuda")
    set_stft_impl(stft_impl)
    key = torch.tensor([0, seed], dtype=torch.int64)
    batch = _batch(Config(batch_size=batch_size), seed, device)
    if finetune:
        conf = Config(batch_size=batch_size, pitch_decode="weighted")
        state = trainer.init_finetune_state(key, conf, device=device)
        step = trainer.make_finetune_step(conf)
        batch = {"audio": batch["audio"]}
    else:
        conf = Config(batch_size=batch_size)
        state = trainer.init_state(key, conf, device)
        step = trainer.make_train_step(conf)
    for _ in range(3):  # warm-up: cuFFT plans, cuDNN, the kernels' build
        state, metrics = step(state, batch)
    torch.cuda.synchronize()

    wall = []
    before = launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    per_step = {f"{k}_launches_per_step": (v - before[k]) / steps
                for k, v in launch_counts().items()}

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    _, ops, _ = _device_ops(prof)
    busy_ms = 1e-6 * sum(e.duration_ns() for e in ops)

    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
    events, ops, launches = _device_ops(prof)
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in events
              if e.name() in STAGES and e.device_type() != DeviceType.CUDA]
    per_stage = {name: [0, 0] for name in STAGES + ("other",)}
    by_kernel = {}
    unmatched = 0
    for e in ops:
        start = launches.get(e.correlation_id())
        unmatched += start is None
        stage = "other" if start is None else next(
            (n for n, a, b in ranges if a <= start <= b), "other")
        per_stage[stage][0] += e.duration_ns()
        per_stage[stage][1] += 1
        key = (stage, e.name())
        by_kernel[key] = by_kernel.get(key, 0) + e.duration_ns()
    stages = {
        name: {"device_ms_per_step": 1e-6 * ns / steps, "kernels_per_step": n / steps}
        for name, (ns, n) in per_stage.items()
    }
    for name in STAGES:
        host_ns = sum(b - a for n, a, b in ranges if n == name)
        stages[name]["host_ms_per_step"] = 1e-6 * host_ns / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    ms = statistics.median(wall)
    return {
        "step": "finetune" if finetune else "decoder",
        "stft_impl": stft_impl,
        "batch_size": batch_size,
        "steps": steps,
        "loss": float(metrics["loss"]),
        "wall_ms_median": ms,
        "steps_per_s": 1e3 / ms,
        "profiled_wall_ms_per_step": window_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "kernels_per_step": len(ops) / steps,
        "unattributed_launches": unmatched,
        **per_step,
        "stages": stages,
        "top_kernels_ms_per_step": {
            f"{stage}: {name[:72]}": 1e-6 * ns / steps for (stage, name), ns in top
        },
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main(argv=None) -> int:
    args = {}
    for a in sys.argv[1:] if argv is None else argv:
        key, _, value = a[2:].partition("=")
        args[key] = value or "1"
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0]
    result = profile(int(args.get("steps", "10")), int(args.get("batch_size", "16")),
                     stft_impl=args.get("stft_impl", "auto"),
                     finetune=args.get("finetune", "0") != "0")
    result["card"] = card
    print(json.dumps(result), flush=True)
    out = args.get("out")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
