"""The upper readings of a cell's correctness numbers, on the card at the
cell's own size: what the check reads from a control or a planted fault.

    python3 benchmark/controls/readings.py --workload NAME --seeds 1,2,3 \\
        --mode tf32 [--calls K]
    python3 benchmark/controls/readings.py --workload NAME --seeds 1,2,3 \\
        --mode fault:NAME [--seconds S]

``tf32``: the control (the traffic kind's driver's ``control``).  The
plain reference takes the program's place, computed one precision below
the configuration's float32 (TF32 matmuls and convolutions), and the
float32 reference judges it as it judges the program: a serving cell over
``--calls`` calls of its sampled slots, a training cell over its first
steps.  ``fault:NAME``: a run of the cell (a window of ``--seconds``)
with a fault of ``benchmark/faults.py`` planted under it.  Prints one JSON line a seed.  Not part of a run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import faults  # noqa: E402
from benchmark.registry import Registry  # noqa: E402


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
            nums = run.driver(ctx.mix["kind"]).control(ctx, args.calls)
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
