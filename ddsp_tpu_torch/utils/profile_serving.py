"""Where a serving hop's time goes on the GPU.

    python -m ddsp_tpu_torch.utils.profile_serving [--n_streams=256,1024,2048]
        [--hops=30] [--out=FILE.json]

For each slot count, at the full default ``Config()`` width with seeded
random weights (as ``chip_smoke.py`` drives it):

* ``wall_ms``: median host time of ``MultiStreamServer.process`` per hop,
  blocks in and audio out (what a serving host sees);
* a ``torch.profiler`` window over the same hops, from which each labelled
  stage of the step (features, controller, oscillator, noise, reverb;
  ``runtime/multistream.py``) gets its device time and kernel launches per
  hop, and the card its busy share of the window's wall time.

Prints one JSON line per slot count and, given ``--out``, writes them all
to that file.
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

STAGES = ("features", "controller", "oscillator", "noise", "reverb")


def _kernels_under(event):
    """Device kernels launched inside a profiler event and its children."""
    found = list(event.kernels)
    for child in event.cpu_children:
        found += _kernels_under(child)
    return found


def profile(n_streams: int, hops: int, seed: int = 0) -> dict:
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer

    conf = Config()
    server = MultiStreamServer(
        decoder_init(conf, seed), crepe_init(conf.crepe_capacity, seed + 1),
        conf, n_streams, noise_seed=seed, device="cuda",
    )
    rng = np.random.default_rng(seed)
    blocks = (0.4 * rng.standard_normal((hops, n_streams, conf.hop_length))).astype(np.float32)
    for b in blocks[:5]:  # warm-up
        server.process(b)

    wall = []
    for b in blocks:
        t0 = time.perf_counter()
        server.process(b)
        wall.append(1e3 * (time.perf_counter() - t0))

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for b in blocks:
            server.process(b)
        window_ms = 1e3 * (time.perf_counter() - t0)

    events = prof.events()
    all_kernels = [k for e in events for k in e.kernels]
    busy_ms = 1e-3 * sum(k.duration for k in all_kernels)
    stages = {}
    for name in STAGES:
        ranges = [e for e in events if e.name == name]
        kernels = [k for e in ranges for k in _kernels_under(e)]
        stages[name] = {
            "device_ms_per_hop": 1e-3 * sum(k.duration for k in kernels) / hops,
            "kernels_per_hop": len(kernels) / hops,
            "host_ms_per_hop": 1e-3 * sum(e.time_range.elapsed_us() for e in ranges) / hops,
        }
    by_kernel = {}
    for k in all_kernels:
        by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "n_streams": n_streams,
        "hops": hops,
        "wall_ms_median": statistics.median(wall),
        "profiled_wall_ms_per_hop": window_ms / hops,
        "device_busy_ms_per_hop": busy_ms / hops,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "kernels_per_hop": len(all_kernels) / hops,
        "stages": stages,
        "top_kernels_ms_per_hop": {name[:80]: 1e-3 * us / hops for name, us in top},
    }


def main(argv=None) -> int:
    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 2
    slots = [int(x) for x in args.get("n_streams", "256,1024,2048").split(",")]
    hops = int(args.get("hops", "30"))
    out = args.get("out")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0]
    results = []
    for n in slots:
        r = profile(n, hops)
        r["card"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
