"""A serving cell: the model's server (``benchmark/models/``) in a closed
loop, ``process`` called back to back.

Every slot is an active client that sends its next block as soon as the
last call returned (back-to-back hops), each slot playing its own looped
input.  The window times every call; afterwards a sample of slots drawn
from the seed is replayed by the plain reference over every call the
server made, warm-up included.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import judge


def sampled_slots(mix: dict, seed: int) -> torch.Tensor:
    """The slots the check replays, drawn from the seed, in order."""
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return torch.randperm(int(mix["slots"]), generator=gen)[:int(mix["check_slots"])].sort().values


def run(ctx) -> dict:
    model, cd, mix, dev = ctx.model, ctx.cd, ctx.mix, ctx.device
    n, hop, sr = int(mix["slots"]), cd["hop_length"], cd["sample_rate"]
    inputs = model.serve_inputs(ctx)
    server = ctx.tamper(model.serve_program(ctx, inputs))
    ctx.marks.append(("server", time.perf_counter() - ctx.t_start))
    loop = model.serve_traffic(ctx)
    ctx.marks.append(("traffic", time.perf_counter() - ctx.t_start))
    n_loop = loop.shape[0]
    slots = sampled_slots(mix, ctx.seed)
    idx = slots.numpy()
    # each call keeps the sampled rows of its answer, and what the check
    # follows of the server's state (device tensors, not read back)
    outs, kept = [], []

    def call(k):
        out = server.process(loop[k % n_loop])
        outs.append(out[idx])
        kept.append(model.serve_kept(server))

    for k in range(int(mix["warm_hops"])):
        call(k)
    ctx.sync()
    first = len(outs)
    setup_s = time.perf_counter() - ctx.t_start

    times = []
    prof = ctx.profiler()
    with prof:
        t0 = time.perf_counter()
        k = first
        while True:
            a = time.perf_counter()
            call(k)
            b = time.perf_counter()
            times.append(b - a)
            k += 1
            if b - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    calls = len(times)
    memory_peak = ctx.memory_peak()

    result = {"setup_s": setup_s, "attempted": calls, "failed": 0,
              "memory_peak": memory_peak, "window_s": window_s}
    result["metrics"] = {
        "serve_streams_rt": n * calls * hop / sr / window_s,
        "serve_hop_ms_p95": 1e3 * float(np.percentile(times, 95)),
    }
    if ctx.trace:
        result["window"] = ctx.summarise(prof, model.STAGES["serve"], window_s, calls,
                                         model.serve_counts(ctx))
    del prof

    # the check: the sampled slots replayed over every call
    total = len(outs)
    out = np.stack(outs, 1)  # (S, K, hop)
    sel = slots.to(dev)
    followed = model.serve_followed(kept, sel)
    blocks = torch.from_numpy(np.stack([loop[k % n_loop][idx] for k in range(total)], 1)).to(dev)
    del server, outs, kept
    gc.collect()
    ctx.free()
    ctx.marks.append(("window end", time.perf_counter() - ctx.t_start))
    ref = model.serve_reference(ctx, inputs, blocks, followed, sel)
    result["numbers"] = judge.serving_numbers(out, followed["phase"], ref)
    ctx.marks.append(("check end", time.perf_counter() - ctx.t_start))
    return result


def control(ctx, calls: int) -> dict:
    """The control's numbers (``benchmark/controls/readings.py``): the plain
    reference on TF32 in the program's place over ``calls`` calls of the
    sampled slots, making its own decisions, judged by the float32
    reference that follows them."""
    inputs = ctx.model.serve_inputs(ctx)
    slots = sampled_slots(ctx.mix, ctx.seed).to(ctx.device)
    loop = torch.from_numpy(ctx.model.serve_traffic(ctx)).to(ctx.device)
    idx = torch.arange(calls) % loop.shape[0]
    blocks = loop[idx][:, slots].transpose(0, 1).contiguous()
    with judge.tf32():
        ctl = ctx.model.serve_reference(ctx, inputs, blocks, None, slots)
    ref = ctx.model.serve_reference(ctx, inputs, blocks, ctl, slots)
    return judge.serving_numbers(ctl["out"].cpu().numpy(), ctl["phase"], ref)
