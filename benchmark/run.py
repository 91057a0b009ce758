"""Run one cell of the benchmark of ddsp_tpu_torch once, on the cards of
this machine:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell's configuration, model, traffic
mix, limits and per-layer readers are found by name
(``benchmark/registry.py``), and the traffic kind's driver as
``benchmark/<kind>_cell.py``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``, every number compared with the
reference beside its limit, which also end standard error.  Without the
cards the cell asks for, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType, SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import guard  # noqa: E402
from benchmark.registry import Registry  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def card_context(args, cell: dict, reg: Registry):
    """The context a cell's driver runs in, on the first of the cards."""
    import torch

    from benchmark import tracing

    torch.set_num_threads(2)
    model = reg.config_model(cell["config"])
    device = model.device("cuda")
    conf = model.config(reg.config(cell["config"]))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return SimpleNamespace(
        model=model, conf=conf, cd=model.as_dict(conf), mix=reg.traffic(cell["traffic"]),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START, tamper=lambda x: x, marks=[],
        sync=torch.cuda.synchronize,
        profiler=(lambda: torch.profiler.profile(activities=activities)) if args.trace
        else contextlib.nullcontext,
        memory_peak=lambda: torch.cuda.max_memory_allocated(device),
        free=torch.cuda.empty_cache,
        summarise=tracing.summarise,
    )


def driver(kind: str) -> ModuleType:
    """The driver of a traffic kind: ``benchmark/<kind>_cell.py``."""
    if not (HERE / f"{kind}_cell.py").is_file():
        raise SystemExit(f"benchmark: unknown traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.{kind}_cell")


def drive(ctx):
    return driver(ctx.mix["kind"]).run(ctx)


def result_line(res: dict, reg: Registry, workload: str, limits: dict, trace: bool,
                device: dict) -> dict:
    """The run's JSON result from its driver's output."""
    from benchmark import judge

    correct, rows = judge.verdict(res["numbers"], limits)
    if trace:
        window = res["window"]
        metrics = {}
        for m in reg.per_layer(workload):
            value = reg.reader(m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=window.busy_s, window_s=window.window_s)
    else:
        values = dict(res["metrics"], setup_s=res["setup_s"])
        metrics = {name: {"value": values[name], "unit": reg.unit(name)}
                   for name in reg.end_to_end(workload)}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": [[n, s] for n, s in res["window"].top_ops],
                             "idle_gaps": [[n, s] for n, s in res["window"].idle_by_range]}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    guard.check_cards(int(cell["chips"]))
    import torch  # noqa: F401  (after the card check: the driver's imports follow)

    ctx = card_context(args, cell, reg)
    ctx.marks.append(("imports and device", time.perf_counter() - T_START))
    guard.check_imports()
    res = drive(ctx)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
              "memory_peak_bytes": int(res["memory_peak"]), "power_limit": _power_limit()}
    line = result_line(res, reg, args.workload, reg.limits(args.workload), bool(args.trace), device)
    emit(line, ctx.marks, res.get("worst_leaves"))
    return 0


def emit(line: dict, marks: list, worst_leaves=None) -> None:
    """Print the run's result: the set-up's marks and the checks on
    standard error, the result line last on standard output.  Refuses
    first if JAX or the JAX package is loaded: by now the window, the
    check and the per-layer readers have all run in this process."""
    guard.check_imports()
    print("setup: " + ", ".join(f"{n} {t:.3f} s" for n, t in marks), file=sys.stderr)
    if worst_leaves:
        print(f"worst leaves: {worst_leaves}", file=sys.stderr)
    for name, value in line["checks"].items():
        print(f"check {name} {value['value']!r} limit {value['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
