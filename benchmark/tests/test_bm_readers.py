"""The per-layer readers on a reduced window: each returns its number
where the window has something to read, and nothing where it has not,
never 0 for a share of a bound."""

from pathlib import Path

import pytest

from benchmark import counts, tracing
from benchmark.registry import Registry
from benchmark.tests.test_bm_span_readers import READS

REG = Registry(Path(__file__).resolve().parents[2])
CONTEXT = {"unit_flops": 1e9, "features_bound_s": 1e-3, "osc_bound_s": 1e-4, "loss_bound_s": 2e-4}
# the program's span table, as ``tracing.summarise`` hands it to the window
SPANS = {span: {"count": 100, "host_s": 0.05, "device_s": 0.05} for span, _ in READS.values()}
STAGES = ("features", "controller", "oscillator", "noise", "reverb", "oscillator_bank", "loss",
          "backward", "optimizer", "filtered_noise")


def _window(device_s):
    return tracing.Window(window_s=2.0, busy_s=1.5, units=100, n_ops=50_000, device_s=device_s,
                          host_s={"optimizer": 0.3}, context=dict(CONTEXT, spans=SPANS))


@pytest.mark.parametrize("name", sorted(REG.listing()["metrics"]))
def test_reader(name):
    read = REG.reader(name)
    full = read(_window({s: 0.05 for s in STAGES}))
    assert full is not None and full > 0
    empty = read(tracing.Window(window_s=2.0, busy_s=1.5, units=100, n_ops=50_000,
                                context=dict(CONTEXT, spans={})))
    if name.split(".")[0] in ("idle_pct", "mfu_pct", "launches_per_hop", "launches_per_step"):
        assert empty is not None  # whole-window numbers
    else:
        assert empty is None


def test_shares_of_the_peak():
    w = _window({})
    assert REG.reader("mfu_pct.serve")(w) == pytest.approx(
        100 * 1e9 * 100 / (2.0 * counts.PEAK_FP32_FLOPS))
    assert REG.reader("idle_pct.train")(w) == pytest.approx(25.0)


def test_union_of_intervals():
    busy, gaps = tracing._union_ns([(0, 10), (5, 12), (20, 30), (25, 26)])
    assert busy == 22 and gaps == [(12, 20)]
