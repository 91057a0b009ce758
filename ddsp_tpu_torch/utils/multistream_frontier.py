"""Serving-capacity frontier: ms per hop against the slot count.

    python -m ddsp_tpu_torch.utils.multistream_frontier [--slots=256,1024,2048]
        [--target_s=4.0] [--hops=25] [--passes=2] [--trials=5] [--device=cuda]

The port of ``scripts/multistream_frontier.py``.  At the full default
``Config()`` width with seeded random weights, for each slot count N, in
``passes`` interleaved passes over the sweep (the per-N minimum is kept,
so one pass's transient cannot fake a frontier edge):

* ``hop_ms``: the median wall ms of ``MultiStreamServer.process`` over
  ``hops`` hops of tone plus noise (the first 5 left out), blocks in and
  audio out: PERF.md's "ms per hop at N slots", which decides the
  frontier;
* ``chain_ms``: ms a hop of a feedback chain of the multi-stream step,
  each hop's output block through ``tanh`` the next hop's input, by
  ``profiling.marginal_chain_time`` (the scalar fetch its only barrier;
  where the host issues a hop slower than the card runs it, the host's
  time).

Prints a JSON line per (pass, N) with ``scripts/multistream_frontier.py``'s
keys (``slots``, ``rep``, ``hop_ms``, ``per_stream_us``, ``headroom``,
``wall_s``) and ``chain_ms``, then the ``multistream_frontier_slots`` line:
the largest N whose ``hop_ms`` is under the hop's deadline (0 when none
is), with ``deadline_ms``, ``hops_ms``, ``chain_ms`` and the card.
Runs on CUDA unless ``--device=cpu``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch

WARM_HOPS = 5  # the first hops' times (library plans) are left out of the median


def deadline_ms(conf) -> float:
    """One hop of audio: the real-time deadline of a serving step."""
    return 1e3 * conf.hop_length / conf.sample_rate


def measure(n: int, params, crepe, conf, device="cuda", hops: int = 25,
            target_s: float = 4.0, trials: int = 5, seed: int = 0) -> dict:
    """{'wall_ms', 'chain_ms', 'hops_run'} of N = ``n`` slots: the median
    wall ms of ``MultiStreamServer.process``, the feedback chain's ms a
    hop, and how many steps were run in all (the server's warm-up step
    included), each of which launches the slot oscillator once."""
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.runtime.multistream import (MultiStreamServer, make_multistream_step,
                                                    multistream_init)
    from ddsp_tpu_torch.utils.profiling import marginal_chain_time
    from ddsp_tpu_torch.utils.slot_parity import tone_blocks

    device = resolve_device(device)
    server = MultiStreamServer(params, crepe, conf, n, noise_seed=seed, device=device)
    wall = []
    for b in tone_blocks(n, hops, conf.hop_length, conf.sample_rate, seed + n):
        t0 = time.perf_counter()
        server.process(b)  # returns host numpy: the step is done
        wall.append(1e3 * (time.perf_counter() - t0))
    del server

    step = make_multistream_step(params, crepe, conf, PRNGKey(seed, device))
    state0 = multistream_init(conf, n, device)
    chained = [0]
    rng = np.random.default_rng(seed)

    def make_many(iters: int) -> Callable:
        def many(state, blocks):
            for _ in range(iters):
                out, state = step(state, blocks)
                blocks = torch.tanh(out)
            chained[0] += iters
            return blocks.sum()
        return many

    def args_for_trial(trial: int):
        seed_blocks = 0.1 * rng.standard_normal((n, conf.hop_length))
        return state0, torch.tensor(seed_blocks, dtype=torch.float32, device=device)

    chain_s = marginal_chain_time(make_many, args_for_trial, trials=trials, target_s=target_s)
    return {"wall_ms": float(np.median(wall[WARM_HOPS:])), "chain_ms": 1e3 * chain_s,
            "hops_run": 1 + hops + chained[0]}


def frontier(hops_ms: Dict[int, float], deadline: float) -> int:
    """The largest N whose ms per hop is under ``deadline`` ms, 0 when
    none is."""
    fit = [n for n, ms in hops_ms.items() if ms < deadline]
    return max(fit) if fit else 0


def sweep(ns: Iterable[int], measure_n: Callable[[int], dict], deadline: float,
          passes: int = 2, emit: Callable[[str], None] = print) -> dict:
    """``passes`` interleaved passes of ``measure_n`` over ``ns``: a JSON
    line per (pass, N) to ``emit``; returns {'frontier', 'hops_ms',
    'chain_ms', 'hops_run'}, the per-N minima and the steps run."""
    ns = list(ns)
    hops_ms, chain_ms, hops_run = {}, {}, 0
    for rep in range(passes):
        for n in ns:
            t0 = time.time()
            r = measure_n(n)
            hops_ms[n] = min(hops_ms.get(n, np.inf), r["wall_ms"])
            chain_ms[n] = min(chain_ms.get(n, np.inf), r["chain_ms"])
            hops_run += r["hops_run"]
            emit(json.dumps({"slots": n, "rep": rep, "hop_ms": r["wall_ms"],
                             "per_stream_us": 1e3 * r["wall_ms"] / n,
                             "headroom": deadline / r["wall_ms"], "wall_s": time.time() - t0,
                             "chain_ms": r["chain_ms"]}))
    return {"frontier": frontier(hops_ms, deadline), "hops_ms": hops_ms, "chain_ms": chain_ms,
            "hops_run": hops_run}


def frontier_line(result: dict, deadline: float, card: str) -> str:
    """The ``multistream_frontier_slots`` JSON line of a :func:`sweep`."""
    return json.dumps({
        "metric": "multistream_frontier_slots",
        "value": result["frontier"],
        "unit": "concurrent real-time streams/card (swept)",
        "deadline_ms": deadline,
        "hops_ms": {str(n): ms for n, ms in result["hops_ms"].items()},
        "chain_ms": {str(n): ms for n, ms in result["chain_ms"].items()},
        "card": card,
    })


def main(argv=None) -> int:
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.utils.profiling import card_name

    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.get("device", "cuda"))
    ns = [int(x) for x in args.get("slots", "256,1024,2048").split(",")]
    hops, passes = int(args.get("hops", "25")), int(args.get("passes", "2"))
    target_s, trials = float(args.get("target_s", "4.0")), int(args.get("trials", "5"))
    conf = Config()
    params, crepe = decoder_init(conf, seed=0), crepe_init(conf.crepe_capacity, seed=1)
    deadline = deadline_ms(conf)
    result = sweep(ns, lambda n: measure(n, params, crepe, conf, device, hops, target_s, trials),
                   deadline, passes, emit=lambda line: print(line, flush=True))
    print(frontier_line(result, deadline, card_name(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
