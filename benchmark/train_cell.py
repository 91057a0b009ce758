"""A training cell: the decoder's step of ``trainer.make_train_step``,
dispatched as ``trainer.fit`` dispatches it: the loss read back every
``log_every`` steps, nothing else.

Set-up builds one training object from the seed and takes its first
steps through the window's own call on the first of the mix's distinct
batches, reading the losses, the first gradient (from Adam's first
moment after one step) and the parameters' change; the window then goes
on with that same object, cycling the batches.  After the window the
plain reference takes the same first steps from the same weights.
"""

from __future__ import annotations

import gc
import math
import time

from benchmark import counts, judge, program, traffic, weights
from benchmark.reference import threefry
from benchmark.reference import train as reference
from ddsp_tpu_torch.ops.spectral import set_stft_impl
from ddsp_tpu_torch.training import trainer


def _norms(named) -> dict:
    return {k: math.sqrt(float((v.detach().double() ** 2).sum())) for k, v in named}


def run(ctx) -> dict:
    conf, cd, mix, dev = ctx.conf, ctx.cd, ctx.mix, ctx.device
    b = int(mix["batch"])
    set_stft_impl(mix["stft_impl"])
    start = weights.decoder_weights(cd, ctx.seed, dev)
    params = program.decoder(conf, start, dev)
    step_fn = trainer.make_train_step(conf)
    batches = traffic.training_batches(mix, cd, ctx.seed, dev)
    key = threefry.seed_key(ctx.seed, dev)
    opt = trainer.make_optimizer(conf)
    state = trainer.TrainState(0, params, opt.init(list(params.parameters())), key.clone())
    step_fn = ctx.tamper(step_fn)
    ctx.marks.append(("state and batches", time.perf_counter() - ctx.t_start))

    n_check = int(mix["check_steps"])
    names = [k for k, _ in params.named_parameters()]
    prog = {"loss": []}
    for i in range(n_check):
        state, metrics = step_fn(state, batches[i % len(batches)])
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            b1 = 0.9  # optax's and the program's Adam: mu = (1 - b1) g after one step
            prog["grad1"] = _norms((k, mu / (1 - b1)) for k, mu in zip(names, state.opt_state.adam.mu))
    prog["change"] = _norms((k, p - start[k]) for k, p in params.named_parameters())
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    steps = 0
    prof = ctx.profiler()
    with prof:
        t0 = time.perf_counter()
        while True:
            state, metrics = step_fn(state, batches[(n_check + steps) % len(batches)])
            steps += 1
            if steps % conf.log_every == 0:
                float(metrics["loss"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    memory_peak = ctx.memory_peak()
    length = cd["frames"] * conf.hop_length
    result = {"setup_s": setup_s, "attempted": steps, "failed": 0,
              "memory_peak": memory_peak, "window_s": window_s,
              "metrics": {"train_audio_s_per_s": steps * b * length / conf.sample_rate / window_s}}
    if ctx.trace:
        result["window"] = ctx.summarise(prof, program.TRAIN_STAGES, window_s, steps, {
            "unit_flops": counts.train_step_flops(cd, b, finetune=False),
            "osc_bound_s": counts.osc_forward_bound_s(b, cd["frames"], conf.hop_length,
                                                      conf.n_harmonics),
            "loss_bound_s": counts.mss_forward_bound_s(cd, b, length),
        })
    del prof, state, metrics, params, step_fn, opt
    gc.collect()
    ctx.free()
    ctx.marks.append(("window end", time.perf_counter() - ctx.t_start))
    ref = reference.steps(start, cd, batches[:n_check], key, block=int(mix["reference_rows"]))
    ref = {"loss": ref["loss"], "grad1": reference.leaf_norms(ref["grad1"]),
           "change": reference.leaf_norms(ref["change"])}
    result["numbers"], result["worst_leaves"] = judge.training_numbers(prog, ref)
    ctx.marks.append(("check end", time.perf_counter() - ctx.t_start))
    set_stft_impl("auto")
    return result
