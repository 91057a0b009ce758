"""A run with its timed path broken underneath comes out not correct: the
rest of a run (past the card check) at narrow widths on the CPU, held to
the cells' own limits, sound and with each fault a cell can have."""

from pathlib import Path

import pytest

from benchmark import faults, judge
from benchmark.registry import Registry
from benchmark.tests import tiny

LIMITS = Registry(Path(__file__).resolve().parents[2])


def _verdict(mix, cell, tamper=None):
    res = tiny.drive(tiny.cpu_context(mix, tamper=tamper))
    return judge.verdict(res["numbers"], LIMITS.limits(cell))


@pytest.mark.parametrize("cell", ["serve_full_n128", "serve_tiny_n2048"])
def test_sound_serving_run_is_correct(cell):
    ok, rows = _verdict(tiny.SERVE_MIX, cell)
    assert ok, rows


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_caught(fault):
    ok, rows = _verdict(tiny.SERVE_MIX, "serve_full_n128", faults.SERVE[fault])
    assert not ok, rows


def test_sound_training_run_is_correct():
    ok, rows = _verdict(tiny.TRAIN_MIX, "train_tiny_b384")
    assert ok, rows


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_caught(fault):
    ok, rows = _verdict(tiny.TRAIN_MIX, "train_tiny_b384", faults.TRAIN[fault])
    assert not ok, rows


def test_a_missing_or_unfinite_number_fails():
    assert judge.verdict({"a": 1.0}, {"a": 2.0})[0]
    assert not judge.verdict({"a": 1.0}, {})[0]
    assert not judge.verdict({"a": float("nan")}, {"a": 2.0})[0]
    assert not judge.verdict({"a": float("inf")}, {"a": 2.0})[0]
    assert not judge.verdict({"a": 1.0}, {"a": None})[0]


def test_a_number_not_compared_is_reported_only():
    ok, rows = judge.verdict({"a": 1.0, "b": 5.0}, {"a": 2.0, "b": judge.NOT_COMPARED})
    assert ok and rows == [["a", 1.0, 2.0], ["b", 5.0, judge.NOT_COMPARED]]
    assert not judge.verdict({"a": 3.0, "b": 5.0}, {"a": 2.0, "b": judge.NOT_COMPARED})[0]
