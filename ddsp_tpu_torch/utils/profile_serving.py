"""Where a serving hop's time goes on the GPU.

    python -m ddsp_tpu_torch.utils.profile_serving [--n_streams=256,1024,2048]
        [--hops=30] [--out=FILE.json]

For each slot count, at the full default ``Config()`` width with seeded
random weights (as ``chip_smoke.py`` drives it):

* ``wall_ms``: median host time of ``MultiStreamServer.process`` per hop,
  blocks in and audio out (what a serving host sees);
* a ``torch.profiler`` window over the same hops, from which the card's
  busy share of the window's wall time and its operations per hop are
  read (every kernel, copy and fill the card ran, the slot kernel K5
  among them), and for each span of the hop (``utils/profiling.span_totals``:
  ``process`` and its ``copy_in``, ``hop`` and ``copy_out``; the stages
  ``features``, ``controller``, ``oscillator``, ``noise``, ``reverb``; the
  features' parts and ``state``; ``runtime/multistream.py``) its host ms
  per hop and its device ms per hop: the durations of the operations
  whose launch began inside the span and inside no span nested in it
  (matched by correlation id, so the ``ctypes`` kernels count), and, for
  the spans that time the card, their CUDA event pair's elapsed time on
  the stream, the card's idle inside them included.

Prints one JSON line per slot count and, given ``--out``, writes them all
to that file.
Needs a CUDA device.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ddsp_tpu_torch.utils import profiling


def _device_ns_by_span(prof, names) -> dict:
    """{span: ns of the card's operations launched inside it and inside no
    span nested in it}; 'other' takes the operations launched outside
    every span."""
    ranges = sorted((a, b, n) for n, a, b in profiling.host_ranges(prof, names))
    starts = [r[0] for r in ranges]
    launches = profiling.launch_starts_ns(prof)

    def holder(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:  # the innermost range that holds t
            i -= 1
        return ranges[i][2] if i >= 0 else "other"

    out = {}
    for e in profiling.device_events(prof):
        t = launches.get(e.correlation_id())
        name = "other" if t is None else holder(t)
        out[name] = out.get(name, 0) + e.duration_ns()
    return out


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
    profiling.reset_spans()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for b in blocks:
            server.process(b)
        window_ms = 1e3 * (time.perf_counter() - t0)

    ops = profiling.device_events(prof)
    busy_ms = 1e-6 * sum(e.duration_ns() for e in ops)
    by_name = {}
    for e in ops:
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    totals = profiling.span_totals()
    device_ns = _device_ns_by_span(prof, totals)
    spans = {name: {"device_ms_per_hop": 1e-6 * device_ns.get(name, 0) / hops,
                    "event_ms_per_hop": None if t["device_s"] is None
                    else 1e3 * t["device_s"] / hops,
                    "host_ms_per_hop": 1e3 * t["host_s"] / hops,
                    "count_per_hop": t["count"] / hops}
             for name, t in totals.items()}
    spans["other"] = {"device_ms_per_hop": 1e-6 * device_ns.get("other", 0) / hops}
    profiling.reset_spans()
    return {
        "n_streams": n_streams,
        "hops": hops,
        "wall_ms_median": statistics.median(wall),
        "profiled_wall_ms_per_hop": window_ms / hops,
        "device_busy_ms_per_hop": busy_ms / hops,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "device_ops_per_hop": len(ops) / hops,
        "spans": spans,
        "top_ops_ms_per_hop": {name[:80]: 1e-6 * ns / hops for name, ns in top},
    }


def main(argv=None) -> int:
    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 2
    slots = [int(x) for x in args.get("n_streams", "256,1024,2048").split(",")]
    hops = int(args.get("hops", "30"))
    out = args.get("out")
    card = profiling.card_name()
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
