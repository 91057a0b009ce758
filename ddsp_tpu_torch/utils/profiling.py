"""Tracing and timing on the card: the port's one span, timer and profiler
reader.

The counterpart of ``ddsp_tpu/utils/profiling.py``, by what each function
is for on an NVIDIA GPU:

* :class:`named_scope`: the port's span, the only way its code opens a
  ``record_function`` range; while a profiler window is open it also
  records its host interval and, if asked, a CUDA event pair (:func:`span_totals`,
  :func:`span_records`, :func:`reset_spans`), and :func:`backward_span`
  names the backward of a forward stage;
* :func:`trace`: a ``torch.profiler`` window over CPU and CUDA activity
  written as a Chrome/Perfetto trace;
* :func:`microbench`: wall time a call, ended by a device synchronize on
  CUDA (JAX's ``block_until_ready``), and the CUDA-event time of the same
  back-to-back calls;
* :func:`graph_ms`: a kernel's device time without its wrapper's host time,
  replayed from a CUDA graph;
* :func:`marginal_chain_time`: JAX's chained-marginal timer, the scalar
  fetch (``.item()``) as its barrier;
* :func:`kernel_durations_ns`, :func:`device_events`, :func:`launch_starts_ns`
  and :func:`host_ranges`: reading a finished profiler window;
* :func:`debug_nans` and :func:`deoptimized`: numeric triage.

Nothing here builds or launches a kernel at import.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

# ------------------------------------------------------------------ spans

_profiler_enabled = torch._C._autograd._profiler_enabled  # kineto, legacy and emit_nvtx


class _SpanLog:
    """The spans recorded in this process's profiler windows, until
    :func:`reset_spans`.  It is process-wide, as a profiler window is: a
    reader that sees only the window (the benchmark's per-layer metrics)
    reads the program's spans here.

    A span's host stamps are read from the realtime clock (epoch ns), onto
    which the profiler maps its events' stamps (``start_ns()``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.records: List[tuple] = []  # (name, start, end, begin event, end event)
        self.backward = None  # the open backward span
        self.backward_seen = set()  # the backward spans this backward pass opened

    def open(self, name: str, device: bool) -> tuple:
        start = time.time_ns()
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        begin = stream = None
        if device and _on_card() and not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream()
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(stream)
        return name, start, rf, begin, stream

    def close(self, span: tuple) -> None:
        name, start, rf, begin, stream = span
        end = None
        if begin is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
        rf.__exit__(None, None, None)
        self.records.append((name, start, time.time_ns(), begin, end))

    def enter_backward(self, name: str, grad: torch.Tensor) -> None:
        """A gradient hook (on autograd's thread): the backward has reached
        an output of the stage ``name`` is named after."""
        if name in self.backward_seen:
            return
        if not self.backward_seen:  # the pass's first: its end closes the last span
            torch.autograd.Variable._execution_engine.queue_callback(self.end_backward)
        self.backward_seen.add(name)
        if self.backward is not None:
            self.close(self.backward)
        self.backward = self.open(name, device=True) if _profiler_enabled() else None

    def end_backward(self) -> None:
        if self.backward is not None:
            self.close(self.backward)
        self.backward, self.backward_seen = None, set()

    def read(self) -> List[Tuple[str, int, int, Optional[float]]]:
        if not self.records:
            return []
        if any(r[3] is not None for r in self.records):
            torch.cuda.synchronize()
        return [(n, a, b, None if e0 is None else 1e-3 * e0.elapsed_time(e1))
                for n, a, b, e0, e1 in self.records]


_SPANS = _SpanLog()


class named_scope:
    """The port's span: ``with named_scope("reverb"): ...``.

    With no profiler window open it costs one check of
    ``torch._C._autograd._profiler_enabled()``: it opens no
    ``record_function`` range and records nothing.  With a window open it
    opens the ``record_function`` range of its name, which the trace and
    the readers of launches by range see, and records its host interval
    (stamped just outside the range).  With ``device=True``, and on the
    card, it also records a timed CUDA event pair on the current stream
    (:func:`span_records`): two event records under the profiler cost
    about three times the range, so only the spans whose device seconds
    are read take them."""

    __slots__ = ("name", "device", "_span")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device
        self._span = None

    def __enter__(self):
        if _profiler_enabled():
            self._span = _SPANS.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _SPANS.close(self._span)
            self._span = None
        return False


def backward_span(stage: str, *tensors: torch.Tensor) -> None:
    """Name the backward of the forward stage ``stage``, whose outputs are
    ``tensors``.  While a profiler window is open, each output that
    requires grad gets a gradient hook: when autograd first reaches one of
    them, the backward span open until then closes and the span
    ``backward.<stage>`` opens, its CUDA event on the stream the backward
    runs on; the last closes as the backward pass ends, just before
    ``torch.autograd.grad`` returns.  With no window open it registers
    nothing."""
    if not _profiler_enabled():
        return
    hook = functools.partial(_SPANS.enter_backward, f"backward.{stage}")
    for t in tensors:
        if t.requires_grad:
            t.register_hook(hook)


def span_records() -> List[Tuple[str, int, int, Optional[float]]]:
    """[(name, host start ns, host end ns, device seconds or None)] of every
    span closed in the process's profiler windows since the last
    :func:`reset_spans`, in the order they closed.  The host ns are on the
    clock of the profiler's events (``start_ns()``).  Device seconds,
    where the span timed the card (``device=True``, and the backward
    spans), are the elapsed time between its event pair, read after a
    synchronise: the device's wall time from the end of the work queued
    before the span to the end of the span's work, idle inside the span
    included (unlike a trace's sum of kernel durations)."""
    return _SPANS.read()


def span_totals() -> Dict[str, Dict[str, Any]]:
    """{name: {'count', 'host_s', 'device_s'}} over :func:`span_records`:
    how many times each span closed, its host seconds and its device
    seconds (None where it never timed the card).  Nested spans each
    count their own whole interval."""
    totals: Dict[str, Dict[str, Any]] = {}
    for name, a, b, dev in span_records():
        t = totals.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": None})
        t["count"] += 1
        t["host_s"] += 1e-9 * (b - a)
        if dev is not None:
            t["device_s"] = (t["device_s"] or 0.0) + dev
    return totals


def reset_spans() -> None:
    """Forget every span recorded so far."""
    _SPANS.reset()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a ``torch.profiler`` window (CPU, and CUDA where there is a
    card) into a Chrome/Perfetto trace file in ``log_dir``; yields the
    profiler.  With ``create_perfetto_link`` the file's path is printed:
    there is no link service to reach, so open it in ui.perfetto.dev."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print(f"trace written to {path} (open it in ui.perfetto.dev)", flush=True)


def card_name(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them, to print beside every time; "cpu" for the
    CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def microbench(
    fn: Callable[..., Any],
    args: Iterable[Any],
    iters: int = 10,
    warmup: int = 2,
    samples_per_call: Optional[int] = None,
    device_events: bool = True,
) -> Dict[str, float]:
    """Time ``fn(*args)``: {'seconds_per_call', 'calls_per_s',
    'samples_per_s' (if samples_per_call given)}, JAX's keys.

    The first ``warmup`` calls absorb the kernels' builds and the
    libraries' plans.  The wall time of ``iters`` back-to-back calls ends
    with a device synchronize when CUDA is in use.  With
    ``device_events`` there, the result also holds ``ms``: the CUDA-event
    time a call of the same calls (what a kernel's ``ms`` means in
    ``chip_smoke.py``).
    """
    args = tuple(args)
    for _ in range(warmup):
        fn(*args)
    card = _on_card()
    events = card and device_events
    if card:
        torch.cuda.synchronize()
    if events:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if events:
        end.record()
    if card:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    result = {"seconds_per_call": dt, "calls_per_s": 1.0 / dt}
    if samples_per_call:
        result["samples_per_s"] = samples_per_call / dt
    if events:
        result["ms"] = start.elapsed_time(end) / iters
    return result


def graph_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels' time without their Python wrapper's
    host time, which bounds ``microbench``'s ``ms`` for calls shorter than
    it.  Needs a card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _fetch(x) -> float:
    """The first element of ``x`` on the host: a tensor's fetch waits for
    the device work that made it."""
    if isinstance(x, torch.Tensor):
        return float(x.reshape(-1)[0].item())
    return float(x)


def marginal_chain_time(
    make_many: Callable[[int], Callable[..., Any]],
    args_for_trial: Callable[[int], tuple],
    trials: int = 5,
    target_s: float = 2.0,
    verbose: bool = False,
) -> float:
    """Seconds per iteration of a chained computation, free of the fixed
    cost of the barrier.

    ``make_many(iters)`` returns a callable that runs ``iters`` executions
    chained by a real output->input dependency and returns a scalar
    tensor; ``args_for_trial(i)`` supplies varied inputs per trial.
    Returns the median over the trials after the first of the marginal
    (T_HI - T_LO) / (HI - LO) between two chain lengths sized so that the
    HI - LO work difference takes about ``target_s``.  Fetching the scalar
    (``.item()``) is the barrier: its fixed round trip cancels in the
    marginal, and an eager chain's host issue time counts where it exceeds
    the device's.
    """
    import numpy as np

    probe = make_many(40)
    _fetch(probe(*args_for_trial(0)))  # builds, plans, warms
    t0 = time.perf_counter()
    _fetch(probe(*args_for_trial(0)))
    rough = (time.perf_counter() - t0) / 40  # upper bound (incl. round trip)
    hi = int(min(6000, max(160, 3 * target_s / rough)))
    lo = hi // 4
    if verbose:
        print(f"[marginal {time.strftime('%H:%M:%S')}] rough={1e3 * rough:.3f} ms"
              f" -> chain lo={lo} hi={hi}", flush=True)

    runs = {n: make_many(n) for n in (lo, hi)}
    for n in (lo, hi):
        _fetch(runs[n](*args_for_trial(0)))  # warm
    times = []
    for trial in range(trials):
        args = args_for_trial(trial)
        ts = {}
        for n in (lo, hi):
            t0 = time.perf_counter()
            r = _fetch(runs[n](*args))
            ts[n] = time.perf_counter() - t0
            if not np.isfinite(r):
                raise FloatingPointError(f"chain of {n} returned {r}")
        times.append((ts[hi] - ts[lo]) / (hi - lo))
    return float(np.median(times[1:]))


# ------------------------------------------------- reading a profiler window


def device_events(prof, copies: bool = True) -> list:
    """Every operation a finished ``torch.profiler`` window saw on the card
    (kernels, and with ``copies`` also memcpy and memset), the device copies
    of the ``record_function`` ranges left out, read from its raw events:
    building the event tree of ~70k launches takes longer than the work it
    profiled."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()
            and (copies or not e.name().startswith(("Memcpy", "Memset")))]


def kernel_durations_ns(prof) -> List[int]:
    """The duration (ns) of every kernel the profiler saw on the card (its
    device events but copies, fills and the ranges)."""
    return [e.duration_ns() for e in device_events(prof, copies=False)]


def launch_starts_ns(prof) -> Dict[int, int]:
    """{correlation id: host start ns of the CUDA runtime call that launched
    it}, to match each device operation to the host range it came from."""
    return {e.correlation_id(): e.start_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("cu")}


def host_ranges(prof, names) -> list:
    """[(name, start ns, end ns)] of the window's host ranges named in
    ``names`` (``record_function`` ranges, not their device copies)."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() in names and e.device_type() != torch.autograd.DeviceType.CUDA]


# ------------------------------------------------------------ numeric triage


class _NanCheck(TorchDispatchMode):
    """Raise at the first aten op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def check_kernel_output(name: str, *outputs: torch.Tensor) -> None:
    """Inside :func:`debug_nans`, raise ``FloatingPointError`` naming the
    hand kernel ``name`` if one of its outputs holds a NaN.  The kernels
    are reached through ``ctypes``, past the dispatcher, so their wrappers
    call this where they count the launch; outside the scope it costs one
    look at the mode stack."""
    if not any(isinstance(m, _NanCheck) for m in _get_current_dispatch_mode_stack()):
        return
    for t in outputs:
        if bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in the output of the kernel {name}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN check, the counterpart of ``jax_debug_nans``: every aten
    op's floating outputs (the backward's too, through autograd's anomaly
    mode, which also records each backward node's forward traceback) and
    every hand kernel's outputs (:func:`check_kernel_output`) are checked,
    and the first NaN raises ``FloatingPointError`` naming its op.  Both
    settings are restored on exit."""
    if not enable:
        yield
        return
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        with _NanCheck():
            yield
    finally:
        torch.autograd.set_detect_anomaly(anomaly)


NONDETERMINISTIC = "does not have a deterministic implementation"


@contextlib.contextmanager
def deoptimized():
    """Scoped deterministic numerics, the counterpart of
    ``jax_disable_most_optimizations``: eager PyTorch has no fusion to
    turn off, so the knob that isolates numerics on the card is the
    deterministic mode.  Inside: ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, cuDNN's autotuner off and its deterministic
    algorithms on, TF32 off (as ``device.resolve_device`` sets it).  The
    hand kernels stay on.  Yields a list that, on exit, holds the
    warnings of the ops that have no deterministic path, once each.
    Every setting is restored on exit.

    cuBLAS is deterministic only with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
    in the environment before its handle is made: set it at the start of
    the process (``chip_smoke.py`` does).
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    found: List[str] = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            cudnn.benchmark, cudnn.deterministic = False, True
            cudnn.allow_tf32 = matmul.allow_tf32 = False
            try:
                yield found
            finally:
                for w in caught:
                    msg = str(w.message)
                    if NONDETERMINISTIC in msg and msg not in found:
                        found.append(msg)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved[2:]
