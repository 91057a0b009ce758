"""A training cell: the model's training step (``benchmark/models/``),
dispatched as ``trainer.fit`` dispatches it: the loss read back every
``log_every`` steps, nothing else.

Set-up builds one training object from the seed and takes its first
steps through the window's own call on the first of the mix's distinct
batches, reading the losses, the first gradient and the parameters'
change; the window then goes on with that same object, cycling the
batches.  After the window the plain reference takes the same first steps
from the same inputs.
"""

from __future__ import annotations

import contextlib
import gc
import time

from benchmark import judge


def run(ctx) -> dict:
    model, cd, mix = ctx.model, ctx.cd, ctx.mix
    inputs = model.train_inputs(ctx)
    program = model.train_program(ctx, inputs)
    step_fn, state, batches = ctx.tamper(program.step), program.state, inputs.batches
    ctx.marks.append(("state and batches", time.perf_counter() - ctx.t_start))

    n_check = int(mix["check_steps"])
    readings = {"loss": []}
    for i in range(n_check):
        state, metrics = step_fn(state, batches[i % len(batches)])
        readings["loss"].append(float(metrics["loss"]))
        if i == 0:
            readings["grad1"] = model.train_grad(program, state)
    readings["change"] = model.train_change(program, inputs)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    steps = 0
    prof = ctx.profiler()
    with prof:
        t0 = time.perf_counter()
        while True:
            state, metrics = step_fn(state, batches[(n_check + steps) % len(batches)])
            steps += 1
            if steps % cd["log_every"] == 0:
                float(metrics["loss"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    memory_peak = ctx.memory_peak()
    length = cd["frames"] * cd["hop_length"]
    result = {"setup_s": setup_s, "attempted": steps, "failed": 0,
              "memory_peak": memory_peak, "window_s": window_s,
              "metrics": {"train_audio_s_per_s":
                          steps * int(mix["batch"]) * length / cd["sample_rate"] / window_s}}
    if ctx.trace:
        result["window"] = ctx.summarise(prof, model.STAGES["train"], window_s, steps,
                                         model.train_counts(ctx))
    del prof, state, metrics, program, step_fn
    gc.collect()
    ctx.free()
    ctx.marks.append(("window end", time.perf_counter() - ctx.t_start))
    ref = model.train_reference(ctx, inputs)
    result["numbers"], result["worst_leaves"] = judge.training_numbers(readings, ref)
    ctx.marks.append(("check end", time.perf_counter() - ctx.t_start))
    model.train_release(ctx)
    return result


def control(ctx, calls: int) -> dict:
    """The control's numbers (``benchmark/controls/readings.py``): the plain
    reference's first steps on TF32 in the program's place, judged against
    the float32 reference's from the same inputs.  ``calls`` is serving's."""
    inputs = ctx.model.train_inputs(ctx)
    out = {}
    for name, precision in (("control", judge.tf32()), ("reference", contextlib.nullcontext())):
        with precision:
            out[name] = ctx.model.train_reference(ctx, inputs)
    nums, worst = judge.training_numbers(out["control"], out["reference"])
    return dict(nums, worst=worst)
