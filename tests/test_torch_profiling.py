"""The port's timing and triage helpers (``ddsp_tpu_torch/utils/profiling.py``).

On the CPU: ``microbench`` returns the JAX module's keys
(``ddsp_tpu/utils/profiling.py:53-56``: ``seconds_per_call``,
``calls_per_s``, and ``samples_per_s`` exactly when asked for);
``marginal_chain_time`` recovers a 2 ms step from chains of sleeps within
50 %; ``debug_nans`` raises ``FloatingPointError`` naming the op for a NaN
made forward and for one made only in the backward, passes clean code, and
checks the hand kernels' outputs through ``check_kernel_output``;
``debug_nans`` and ``deoptimized`` restore every setting they touch, also
when their body raises; ``trace`` writes a trace holding a range's name.
The span (``named_scope``): inside a profiler window its host stamps
bracket its ``record_function`` event within 1 ms (the profiler's clock),
outside one it records nothing and enters no range, a span not asked to
time the card makes no CUDA event even where a card is in use, and its
totals add up over nested spans; ``backward_span`` opens the backward spans in the order
autograd reaches the stages and closes the last as the pass ends.

The tests marked ``cuda`` run the profiler reader, the graph timer and the
deterministic mode on the card; this file imports no jax, so they run on a
GPU machine as ``python -m pytest --noconftest -m cuda
tests/test_torch_profiling.py``.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import glob
import os
import time
import warnings

import pytest
import torch

from ddsp_tpu_torch.utils import profiling

JAX_KEYS = ("seconds_per_call", "calls_per_s")


@pytest.mark.parametrize("samples", [None, 4096])
def test_microbench_keys_are_jaxs(samples):
    calls = []
    result = profiling.microbench(lambda x: calls.append(x) or x.sum(), (torch.ones(8),),
                                  iters=5, warmup=2, samples_per_call=samples)
    want = set(JAX_KEYS) | ({"samples_per_s"} if samples else set())
    assert set(result) == want  # no "ms" without a card
    assert len(calls) == 7
    assert result["calls_per_s"] == pytest.approx(1.0 / result["seconds_per_call"])
    if samples:
        assert result["samples_per_s"] == pytest.approx(samples / result["seconds_per_call"])


def test_marginal_chain_time_recovers_a_sleep_step():
    step_s = 0.002

    def make_many(n):
        def many(x):
            for _ in range(n):
                time.sleep(step_s)
            return x + 1.0
        return many

    t = profiling.marginal_chain_time(make_many, lambda trial: (torch.zeros(()),), trials=5,
                                      target_s=0.1)
    assert 0.5 * step_s <= t <= 1.5 * step_s


def test_marginal_chain_time_refuses_a_non_finite_chain():
    with pytest.raises(FloatingPointError, match="returned nan"):
        profiling.marginal_chain_time(lambda n: (lambda: torch.tensor(float("nan"))),
                                      lambda trial: (), trials=2, target_s=0.0)


def test_debug_nans_names_a_forward_op():
    with pytest.raises(FloatingPointError, match=r"aten\.log"):
        with profiling.debug_nans():
            torch.log(-torch.ones(3))
    torch.log(-torch.ones(3))  # outside the scope: no check


def test_debug_nans_names_a_backward_op():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match=r"NaN in the output of aten\."):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's forward traceback
            with profiling.debug_nans():
                y = (torch.sqrt(x) * 0.0).sum()  # finite forward; 0 * inf backward
                assert torch.isfinite(y)
                y.backward()


def test_debug_nans_passes_clean_code():
    x = torch.linspace(0.1, 1.0, 5, requires_grad=True)
    with profiling.debug_nans():
        loss = torch.log(x).exp().sum()
        loss.backward()
    assert torch.allclose(x.grad, torch.ones(5))
    with profiling.debug_nans(enable=False):
        torch.log(-torch.ones(1))


def test_kernel_outputs_are_checked_only_inside_debug_nans():
    bad = torch.tensor([1.0, float("nan")])
    profiling.check_kernel_output("osc_hop_slots", bad)
    with pytest.raises(FloatingPointError, match="kernel osc_hop_slots"):
        with profiling.debug_nans():
            profiling.check_kernel_output("osc_hop_slots", torch.ones(2), bad)
    with profiling.debug_nans():
        profiling.check_kernel_output("osc_hop_slots", torch.ones(2))


@pytest.mark.parametrize("raises", [False, True])
def test_debug_nans_restores_anomaly_mode(raises):
    before = torch.is_anomaly_enabled()
    with pytest.raises(ValueError) if raises else _nothing():
        with profiling.debug_nans():
            assert torch.is_anomaly_enabled()
            if raises:
                raise ValueError("body")
    assert torch.is_anomaly_enabled() == before
    profiling.check_kernel_output("x", torch.tensor(float("nan")))  # the mode is gone


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _settings():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.benchmark,
            cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)


@pytest.mark.parametrize("raises", [False, True])
def test_deoptimized_sets_and_restores_every_setting(raises):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = _settings()
    try:
        cudnn.benchmark, cudnn.deterministic = True, False
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        before = _settings()
        with pytest.raises(ValueError) if raises else _nothing():
            with profiling.deoptimized() as warned:
                assert _settings() == (True, True, False, True, False, False)
                msg = f"scatter_add_cuda_kernel {profiling.NONDETERMINISTIC}, but you set it"
                warnings.warn(msg)
                warnings.warn(msg)
                warnings.warn("an unrelated warning")
                if raises:
                    raise ValueError("body")
        assert _settings() == before
        assert warned == [msg]
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved[2:]


@pytest.mark.parametrize("link", [False, True])
def test_trace_writes_a_trace_with_the_range(tmp_path, capsys, link):
    with profiling.trace(str(tmp_path), create_perfetto_link=link):
        with profiling.named_scope("ddsp_range_under_test"):
            torch.ones(64).cumsum(0)
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    assert "ddsp_range_under_test" in open(files[0]).read()
    assert (files[0] in capsys.readouterr().out) == link


# ------------------------------------------------------------------ spans

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def spans():
    """The span log, empty before and after the test."""
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def test_span_stamps_bracket_its_range_on_the_profilers_clock(spans):
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(5):
            with spans.named_scope("ddsp_span_under_test"):
                torch.ones(256).cumsum(0)
                time.sleep(0.002)
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "ddsp_span_under_test"
                    and e.device_type() == torch.autograd.DeviceType.CPU)
    records = [(a, b) for name, a, b, dev in spans.span_records()]
    assert len(events) == len(records) == 5
    # the profiler maps its stamps with a calibration of its own, which may
    # differ from the span log's by microseconds (another clock: by years)
    calibration = 20_000
    for (a, b), (ea, eb) in zip(records, events):
        assert -calibration <= ea - a <= 1_000_000 and -calibration <= b - eb <= 1_000_000


def test_span_outside_a_window_records_nothing_and_enters_no_range(spans, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered a range or made an event outside a window")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    x = torch.ones(4, requires_grad=True)
    with spans.named_scope("outer"):
        with spans.named_scope("inner"):
            y = (2 * x).sin()
        spans.backward_span("inner", y)
    assert y._backward_hooks is None  # no hook registered
    y.sum().backward()
    assert spans.span_records() == [] and spans.span_totals() == {}


def test_span_without_device_makes_no_event_on_a_card(spans, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a host-only span made an event")

    monkeypatch.setattr(spans, "_on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with torch.profiler.profile(activities=CPU):
        with spans.named_scope("host_only"):
            torch.ones(4).sum()
    assert spans.span_totals()["host_only"]["device_s"] is None


def test_span_totals_add_up_over_nested_spans(spans):
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            with spans.named_scope("outer"):
                for _ in range(3):
                    with spans.named_scope("inner"):
                        time.sleep(0.001)
                time.sleep(0.001)
    records = spans.span_records()
    totals = spans.span_totals()
    assert {k: v["count"] for k, v in totals.items()} == {"outer": 2, "inner": 6}
    assert [r[0] for r in records] == (["inner"] * 3 + ["outer"]) * 2
    for name in ("outer", "inner"):
        want = sum(1e-9 * (b - a) for n, a, b, _ in records if n == name)
        assert totals[name]["host_s"] == pytest.approx(want)
        if not torch.cuda.is_initialized():
            assert totals[name]["device_s"] is None  # no card in use
    assert totals["inner"]["host_s"] >= 6e-3
    assert totals["outer"]["host_s"] >= totals["inner"]["host_s"] + 2e-3


def test_backward_spans_follow_autograd_and_close_at_the_end(spans):
    x = torch.ones(8, requires_grad=True)
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            a = (3 * x).tanh()
            spans.backward_span("first", a)
            b = a.exp() * a
            spans.backward_span("second", b)
            loss = b.sum()
            spans.backward_span("last", loss)
            torch.autograd.grad(loss, [x])
            # the pass's last span closed as it ended
            assert spans._SPANS.backward is None
    names = [r[0] for r in spans.span_records()]
    assert names == ["backward.last", "backward.second", "backward.first"] * 2


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_durations_read_a_window_on_card(cuda_device):
    a = torch.randn(512, 512, device=cuda_device)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with profiling.named_scope("matmuls"):
            for _ in range(3):
                a = a @ a / 512
        a.cpu()  # a device-to-host copy, left out of the kernels
        torch.cuda.synchronize()
    ns = profiling.kernel_durations_ns(prof)
    assert len(ns) >= 3 and all(d > 0 for d in ns)
    names = [e.name() for e in profiling.device_events(prof)]
    assert any(n.startswith("Memcpy") for n in names)
    assert len(profiling.device_events(prof, copies=False)) == len(ns)
    assert [r[0] for r in profiling.host_ranges(prof, ("matmuls",))] == ["matmuls"]


@pytest.mark.cuda
def test_span_times_its_work_on_card(cuda_device):
    """A ``device=True`` span's device seconds are its event pair's elapsed
    time: at least the kernels it launched, at most the wall time from its
    opening to the synchronise after it.  A span without it times nothing."""
    profiling.reset_spans()
    a = torch.randn(2048, 2048, device=cuda_device)
    a = a @ a / 2048  # cuBLAS's handle and workspace, outside the window
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with profiling.named_scope("matmuls", device=True):
            for _ in range(8):
                a = a @ a / 2048
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels_s = 1e-9 * sum(profiling.kernel_durations_ns(prof))
    with torch.profiler.profile(activities=activities):
        with profiling.named_scope("host_only"):
            a = a @ a / 2048
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert totals["matmuls"]["count"] == 1 and totals["host_only"]["device_s"] is None
    assert 0.95 * kernels_s <= totals["matmuls"]["device_s"] <= wall_s


@pytest.mark.cuda
def test_graph_ms_and_microbench_time_the_card(cuda_device):
    x = torch.randn(1 << 20, device=cuda_device)
    in_graph = profiling.graph_ms(lambda: x.mul_(1.0), 50)
    timed = profiling.microbench(lambda: x.mul_(1.0), (), iters=50, warmup=3)
    assert 0 < in_graph < 1.0 and 0 < timed["ms"] < 10.0
    assert set(timed) == set(JAX_KEYS) | {"ms"}


@pytest.mark.cuda
def test_deoptimized_collects_the_cards_nondeterministic_ops(cuda_device):
    """The reflect padding's backward (``torch.stft``'s centre padding) has
    no deterministic path on CUDA; the mode names it."""
    before = _settings()
    x = torch.randn(2, 1, 64, device=cuda_device, requires_grad=True)
    with profiling.deoptimized() as warned:
        torch.nn.functional.pad(x, (8, 8), mode="reflect").sum().backward()
        torch.cuda.synchronize()
    assert _settings() == before
    assert any(w.startswith("reflection_pad1d_backward") for w in warned), warned
