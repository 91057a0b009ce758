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
    under = [k for e in prof.events() if e.name == "matmuls" for k in profiling.kernels_under(e)]
    assert len(under) >= 3


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
