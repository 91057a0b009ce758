"""The upper readings of a cell's correctness numbers, on the card at the
cell's own size: what the check reads from a control or a planted fault.

    python3 benchmark/controls/readings.py --workload NAME --seeds 1,2,3 \\
        --mode tf32 [--calls K]
    python3 benchmark/controls/readings.py --workload NAME --seeds 1,2,3 \\
        --mode fault:NAME [--seconds S]

``tf32``: the control.  The plain reference takes the program's place,
computed one precision below the configuration's float32 (TF32 matmuls
and convolutions), and the float32 reference judges it as it judges the
program: a serving cell over ``--calls`` calls of its sampled slots, a
training cell over its first steps.  ``fault:NAME``: a run of the cell
(a window of ``--seconds``) with a fault of ``benchmark/faults.py``
planted under it.  Prints one JSON line a seed.  Not part of a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import faults, judge, traffic, weights  # noqa: E402
from benchmark.reference import serve as rserve  # noqa: E402
from benchmark.reference import threefry  # noqa: E402
from benchmark.reference import train as rtrain  # noqa: E402
from benchmark.registry import Registry  # noqa: E402


@contextlib.contextmanager
def tf32():
    """Float32 matmuls and cuDNN convolutions on TF32, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def control_serve(cd: dict, mix: dict, seed: int, calls: int, device) -> dict:
    wd, wc = weights.decoder_weights(cd, seed, device), weights.crepe_weights(cd, seed, device)
    loop = traffic.serving_loop(mix, cd, seed, device)
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    slots = torch.randperm(int(mix["slots"]), generator=gen)[:int(mix["check_slots"])].sort().values
    idx = torch.arange(calls) % loop.shape[0]
    blocks = loop[idx][:, slots.to(device)].transpose(0, 1).contiguous()
    with tf32():
        ctl = rserve.replay(wd, wc, cd, blocks, None, None, seed, slots.to(device))
    ref = rserve.replay(wd, wc, cd, blocks, ctl["f0"], ctl["phase"], seed, slots.to(device))
    return judge.serving_numbers(ctl["out"].cpu().numpy(), ctl["phase"], ref)


def control_train(cd: dict, mix: dict, seed: int, device) -> dict:
    start = weights.decoder_weights(cd, seed, device)
    batches = traffic.training_batches(mix, cd, seed, device)[:int(mix["check_steps"])]
    key = threefry.seed_key(seed, device)
    rows = int(mix["reference_rows"])
    out = {}
    for name, ctx in (("control", tf32()), ("reference", contextlib.nullcontext())):
        with ctx:
            r = rtrain.steps(start, cd, batches, key, block=rows)
        out[name] = {"loss": r["loss"], "grad1": rtrain.leaf_norms(r["grad1"]),
                     "change": rtrain.leaf_norms(r["change"])}
    nums, worst = judge.training_numbers(out["control"], out["reference"])
    return dict(nums, worst=worst)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--calls", type=int, default=700)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    from benchmark import run

    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        ctx = run.card_context(ns, cell, reg)
        if args.mode == "tf32":
            if ctx.mix["kind"] == "serve":
                nums = control_serve(ctx.cd, ctx.mix, seed, args.calls, ctx.device)
            else:
                nums = control_train(ctx.cd, ctx.mix, seed, ctx.device)
        else:
            fault = args.mode.split(":", 1)[1]
            ctx.tamper = (faults.SERVE if ctx.mix["kind"] == "serve" else faults.TRAIN)[fault]
            res = run.drive(ctx)
            nums = dict(res["numbers"], worst=res.get("worst_leaves"))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": nums}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
