"""The readers of the program's spans (``benchmark/spans.py``) on a fake
table in the window's context: each reads its span's host or device
seconds over the window's units, and None where the span recorded
nothing, where it never ran on the card (device seconds), or where the
program keeps no table."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import spans, tracing
from benchmark.registry import Registry
from ddsp_tpu_torch.utils import profiling

REG = Registry(Path(__file__).resolve().parents[2])
# each span reader: (span, which seconds)
READS = {
    "copy_in_host_ms.serve": ("copy_in", "host_s"),
    "issue_host_ms.serve": ("hop", "host_s"),
    "copy_out_wait_ms.serve": ("copy_out", "host_s"),
    "state_ms.serve": ("state", "device_s"),
    "loudness_ms.serve": ("features.loudness", "device_s"),
    "resample_ms.serve": ("features.resample", "device_s"),
    "crepe_ms.serve": ("features.crepe", "device_s"),
    "step_host_ms.train": ("train_step", "host_s"),
    "controller_host_ms.train": ("controller", "host_s"),
    "bwd_loss_ms.train": ("backward.loss", "device_s"),
    "bwd_reverb_ms.train": ("backward.reverb", "device_s"),
    "bwd_noise_ms.train": ("backward.filtered_noise", "device_s"),
    "bwd_oscillator_ms.train": ("backward.oscillator_bank", "device_s"),
    "bwd_controller_ms.train": ("backward.controller", "device_s"),
}


def _window(table=None):
    context = {} if table is None else {"spans": table}
    return tracing.Window(window_s=2.0, busy_s=1.5, units=40, n_ops=1000, context=context)


def _table(span, host_s, device_s):
    return {span: {"count": 40, "host_s": host_s, "device_s": device_s},
            "unrelated": {"count": 1, "host_s": 9.0, "device_s": 9.0}}


@pytest.mark.parametrize("name", sorted(READS))
def test_span_reader(name):
    span, seconds = READS[name]
    read = REG.reader(name)
    want = 1e3 * {"host_s": 0.2, "device_s": 0.6}[seconds] / 40
    assert read(_window(_table(span, 0.2, 0.6))) == pytest.approx(want)
    assert read(_window(_table("elsewhere", 0.2, 0.6))) is None
    if seconds == "device_s":
        assert read(_window(_table(span, 0.2, None))) is None
    assert read(_window({})) is None  # a program without spans
    assert read(_window()) is None  # a window without the table


def test_the_window_carries_the_span_table(monkeypatch):
    """``summarise`` reads the program's table once, into the window's
    context beside the model's counts; without the program's reader the
    table is empty."""
    table = _table("hop", 0.2, None)
    monkeypatch.setattr(profiling, "span_totals", lambda: table)
    assert spans.totals() == table
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: [])))
    w = tracing.summarise(prof, ("features",), 1.0, 10, {"unit_flops": 5.0})
    assert w.context == {"unit_flops": 5.0, "spans": table}
    monkeypatch.delattr(profiling, "span_totals")
    assert spans.totals() == {}


@pytest.mark.parametrize("name", sorted(READS))
def test_span_metric_entry(name):
    entry = next(m for m in REG.spec["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["workloads"] and all(
        entry["moves"] in REG.end_to_end(cell) for cell in entry["workloads"])


def test_every_span_reader_is_listed():
    names = {m["name"] for m in REG.spec["per_layer"] if m["source"] == "program_span"}
    assert set(READS) == names - {"optimizer_host_ms.train"}
