"""Reading a ``torch.profiler`` window of the card into what the per-layer
metrics take.

The readers of raw kineto events are a frozen copy of those in
``ddsp_tpu_torch/utils/profiling.py`` (``device_events``,
``launch_starts_ns``, ``host_ranges``).  Each device operation is charged
to the host range that was open when the host call that launched it
began, matched by correlation id: the backward launches from autograd's
own thread and the hand kernels through ``ctypes``, so neither sits under
its range in the profiler's call tree.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import torch

from benchmark import spans


def device_events(prof) -> list:
    """Every operation the window saw on the card (kernels, copies, fills),
    without the device copies of the host ranges."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def launch_starts_ns(prof) -> Dict[int, int]:
    """{correlation id: host start ns of the CUDA call that launched it}."""
    return {e.correlation_id(): e.start_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("cu")}


def host_ranges(prof, names: Iterable[str]) -> List[Tuple[str, int, int]]:
    """[(name, start ns, end ns)] of the host ranges named in ``names``."""
    names = set(names)
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() in names and e.device_type() != torch.autograd.DeviceType.CUDA]


def _union_ns(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, gaps) of the union of [start, end) intervals."""
    busy, gaps, end = 0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


@dataclass
class Window:
    """A traced window, reduced: per-unit quantities divide by ``units``
    (the hops or steps the window completed)."""

    window_s: float
    busy_s: float
    units: int
    n_ops: int
    device_s: Dict[str, float] = field(default_factory=dict)  # by stage range
    host_s: Dict[str, float] = field(default_factory=dict)  # by stage range
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_by_range: List[Tuple[str, float]] = field(default_factory=list)
    context: dict = field(default_factory=dict)  # the model's counts, the span table

    def per_unit_ms(self, *stages: str) -> float:
        return 1e3 * sum(self.device_s.get(s, 0.0) for s in stages) / self.units


def summarise(prof, stages: Iterable[str], window_s: float, units: int,
              context: dict) -> Window:
    """Reduce a finished profiler window.  ``stages`` are the program's
    ranges, which do not overlap one another; an operation launched
    outside all of them is charged to 'other'.  ``context`` goes to the
    window with the program's span table under ``spans``."""
    stages = tuple(stages)
    ops = device_events(prof)
    starts = launch_starts_ns(prof)
    ranges = sorted((a, b, n) for n, a, b in host_ranges(prof, stages))
    lo = [r[0] for r in ranges]

    def stage_at(t):
        i = bisect.bisect_right(lo, t) - 1
        return ranges[i][2] if i >= 0 and t <= ranges[i][1] else "other"

    dev = defaultdict(int)
    by_name = defaultdict(int)
    intervals = []
    for e in ops:
        d = e.duration_ns()
        t = starts.get(e.correlation_id())
        dev["other" if t is None else stage_at(t)] += d
        by_name[e.name()] += d
        intervals.append((e.start_ns(), e.start_ns() + d))
    busy, gaps = _union_ns(intervals)
    idle = defaultdict(int)
    for a, b in gaps:
        idle[stage_at((a + b) // 2)] += b - a
    host = defaultdict(int)
    for a, b, n in ranges:
        host[n] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Window(
        window_s=window_s,
        busy_s=1e-9 * busy,
        units=max(1, units),
        n_ops=len(ops),
        device_s={k: 1e-9 * v for k, v in dev.items()},
        host_s={k: 1e-9 * v for k, v in host.items()},
        top_ops=[(n, 1e-9 * v) for n, v in top],
        idle_by_range=[(n, 1e-9 * v) for n, v in
                       sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        context=dict(context, spans=spans.totals()),
    )
