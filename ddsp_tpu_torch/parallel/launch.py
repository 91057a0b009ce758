"""Run a function on N rank processes of one machine, with a hard time limit.

``run_ranks(fn, world_size, args)`` starts ``world_size`` processes (the
``spawn`` start method: each a fresh interpreter, safe with CUDA), joins
them into one process group through a ``file://`` store (no port to race
for), calls ``fn(rank, device, *args)`` in each, and returns the ranks'
results in rank order.  A rank that raises, exits or outlives the time
limit fails the whole run: the others are killed and ``RankFailure``
carries each failed rank's traceback.  ``fn`` must be importable by name
(defined at a module's top level) and return a picklable value.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class RankFailure(RuntimeError):
    """One or more ranks failed or hung; the message holds their errors."""


def _rank_main(fn, rank: int, world_size: int, init_method: str, backend: Optional[str],
               device: str, group_timeout: Optional[float], args: Sequence, out: str) -> None:
    from ddsp_tpu_torch.parallel.mesh import initialize_distributed

    try:
        dev = initialize_distributed(init_method, world_size, rank, backend=backend,
                                     timeout=group_timeout, device=device)
        result = fn(rank, dev, *args)
        dist.barrier()
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    args: Sequence = (),
    *,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout: float = 300.0,
    group_timeout: Optional[float] = None,
) -> List[Any]:
    """[fn(rank, device, *args) for each rank], each in its own process.

    ``backend``/``device``: as ``mesh.initialize_distributed`` takes them
    (``backend='gloo'`` with ``device='cuda'`` puts every rank on the one
    card).  ``timeout``: seconds for the whole run, start-up included.
    ``group_timeout``: seconds a collective waits for a peer.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, init_method, backend, device, group_timeout, tuple(args),
            outs[r]), daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one rank failed: the others would wait for it
                time.sleep(0.05)
        finally:
            timed_out = time.monotonic() >= deadline
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        payloads = [torch.load(o, weights_only=False) if os.path.exists(o) else {}
                    for o in outs]
    errors = []
    for r, (p, payload) in enumerate(zip(procs, payloads)):
        if r in hung and "result" not in payload:
            why = f"the {timeout} s limit" if timed_out else "another rank's failure"
            errors.append(f"rank {r}: still running at {why}, killed")
        elif p.exitcode != 0 or "result" not in payload:
            errors.append(f"rank {r}: exit code {p.exitcode}\n{payload.get('error', '')}")
    if errors:
        raise RankFailure("\n".join(errors))
    return [payload["result"] for payload in payloads]
