"""A serving cell: ``MultiStreamServer.process`` in a closed loop.

Every slot is an active client that sends its next 512-sample block as
soon as the last call returned (back-to-back hops), each slot playing its
own looped tone.  The window times every call; afterwards a sample of
slots drawn from the seed is replayed by the plain reference over every
call the server made, warm-up included.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counts, judge, program, traffic, weights
from benchmark.reference import serve as reference
from ddsp_tpu_torch.runtime.multistream import MultiStreamServer


def run(ctx) -> dict:
    conf, cd, mix, dev = ctx.conf, ctx.cd, ctx.mix, ctx.device
    n, hop, sr = int(mix["slots"]), conf.hop_length, conf.sample_rate
    wd = weights.decoder_weights(cd, ctx.seed, dev)
    wc = weights.crepe_weights(cd, ctx.seed, dev)
    server = MultiStreamServer(program.decoder(conf, wd, dev), program.crepe(conf, wc, dev),
                               conf, n, noise_seed=ctx.seed, device=dev)
    server = ctx.tamper(server)
    ctx.marks.append(("server", time.perf_counter() - ctx.t_start))
    loop_dev = traffic.serving_loop(mix, cd, ctx.seed, dev)
    loop = loop_dev.cpu().numpy()
    del loop_dev
    n_loop = loop.shape[0]
    # the slots the check replays, drawn from the seed
    gen = torch.Generator().manual_seed(int(ctx.seed) % (1 << 63))
    slots = torch.randperm(n, generator=gen)[:int(mix["check_slots"])].sort().values
    idx = slots.numpy()
    # each call keeps the sampled rows of its answer, and the f0 and phase
    # the call left in the server's state (device tensors, not read back)
    outs, f0s, phases = [], [], []

    def call(k):
        out = server.process(loop[k % n_loop])
        outs.append(out[idx])
        f0s.append(server.state.cur["f0"])
        phases.append(server.state.phase)

    ctx.marks.append(("traffic", time.perf_counter() - ctx.t_start))
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
        tail = int(np.ceil(1024 * sr / 16000)) + 64
        result["window"] = ctx.summarise(prof, program.SERVE_STAGES, window_s, calls, {
            "unit_flops": counts.serve_hop_flops(cd, n),
            "features_bound_s": counts.features_bound_s(cd, n, tail),
        })
    del prof

    # the check: the sampled slots replayed over every call
    total = len(outs)
    out = np.stack(outs, 1)  # (S, K, hop)
    sel = slots.to(dev)
    f0 = torch.stack([f[sel, 0, 0] for f in f0s], 1)
    phase = torch.stack([p[sel] for p in phases], 1)
    blocks = torch.from_numpy(np.stack([loop[k % n_loop][idx] for k in range(total)], 1)).to(dev)
    del server, outs, f0s, phases
    gc.collect()
    ctx.free()
    ctx.marks.append(("window end", time.perf_counter() - ctx.t_start))
    ref = reference.replay(wd, wc, cd, blocks, f0, phase, ctx.seed, sel)
    result["numbers"] = judge.serving_numbers(out, phase, ref)
    ctx.marks.append(("check end", time.perf_counter() - ctx.t_start))
    return result
