"""The port's serving tools on CPU at a tiny width, as
``tests/test_torch_serving.py`` runs the server.

* ``utils/server_drive``: 3 clients, 2 sessions each, 2 slots, 3 hops:
  every session completes, finite and in order, slots are reused after
  reconnects, and each session equals its slot in a fresh
  ``MultiStreamServer`` (1e-5, the serving tests' criterion); with the
  server's slot reset disabled the drive reports the stale slots and fails.
* ``utils/multistream_frontier``: the largest N under the deadline, 0 when
  none fits, per-N minima over passes, from stubbed times; one real
  measurement on the CPU runs the chain the marginal timer asks for.
* Both print the JSON keys of ``scripts/server_drive.py`` and
  ``scripts/multistream_frontier.py`` in their order (read from those
  scripts' source), then the port's additions.

This file imports no jax.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import ast
import json
import os

import numpy as np
import pytest

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init
from ddsp_tpu_torch.utils import multistream_frontier as mf
from ddsp_tpu_torch.utils import server_drive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = Config(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16, reverb_length=300,
)


def _dumped_keys(script: str):
    """The keys, in order, of each dict literal passed to ``json.dumps`` in a
    script of the JAX package."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", script)).read())
    return [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


def _weights():
    return decoder_init(CONF, seed=0), crepe_init(seed=1)


def test_server_drive_completes_sessions_on_reused_slots():
    result = server_drive.drive(*_weights(), CONF, clients=3, slots=2, hops=3, sessions=2,
                                device="cpu", timeout=60.0)
    assert result["errors"] == [] and not server_drive.failed(result)
    assert result["sessions_completed"] == result["sessions_expected"] == 6
    assert result["all_finite_in_order"] and result["distinct_slots_used"] == 2
    assert result["sessions_on_reused_slots"] == 4
    assert result["fresh_slot_max_abs_err"] <= server_drive.FRESH_ATOL
    # the server's warm-up, a step or flush per engine round, and each fresh
    # server's warm-up, 3 hops and flush in each of at least 3 rounds
    assert result["device_steps"] >= 1 + 3 + 1 + 3 * 5
    # of them the flushes: one a fresh server, and one a live engine round
    # with a disconnect
    assert 3 + 1 <= result["device_flushes"] <= result["device_steps"] - 1 - 3 * 4
    (jax_keys,) = _dumped_keys("server_drive.py")
    assert list(result)[:len(jax_keys)] == jax_keys
    assert list(result)[len(jax_keys):] == ["sessions_on_reused_slots",
                                           "fresh_slot_max_abs_err", "device_steps",
                                           "device_flushes"]
    json.dumps(result)


def test_server_drive_reports_a_slot_that_was_not_reset(monkeypatch):
    from ddsp_tpu_torch.runtime import server

    monkeypatch.setattr(server, "reset_slots", lambda conf, state, slots: state)
    result = server_drive.drive(*_weights(), CONF, clients=2, slots=1, hops=3, sessions=2,
                                device="cpu", timeout=60.0)
    assert result["sessions_completed"] == 4 and result["all_finite_in_order"]
    stale = [e for e in result["errors"] if "from a fresh slot" in e[2]]
    assert len(stale) == 3 and server_drive.failed(result)


def _stub(times):
    """A measure function returning ``times[(rep, n)]`` as the wall ms."""
    calls = []

    def measure(n):
        rep = sum(1 for m in calls if m == n)
        calls.append(n)
        return {"wall_ms": times[(rep, n)], "chain_ms": times[(rep, n)] / 2, "hops_run": 7}

    return measure


@pytest.mark.parametrize("times,want", [
    ({(0, 256): 9.0, (0, 1024): 11.0, (0, 2048): 30.0,
      (1, 256): 10.0, (1, 1024): 12.5, (1, 2048): 22.0}, 1024),
    ({(0, 256): 12.0, (0, 1024): 20.0, (0, 2048): 11.0,
      (1, 256): 11.0, (1, 1024): 30.0, (1, 2048): 40.0}, 2048),
    ({(0, 256): 12.0, (0, 1024): 20.0, (0, 2048): 30.0,
      (1, 256): 11.7, (1, 1024): 19.0, (1, 2048): 25.0}, 0),
], ids=["middle", "per-n minimum", "none fits"])
def test_frontier_takes_the_largest_n_under_the_deadline(times, want):
    lines = []
    deadline = mf.deadline_ms(Config())
    result = mf.sweep((256, 1024, 2048), _stub(times), deadline, passes=2, emit=lines.append)
    assert result["frontier"] == want
    assert result["hops_ms"] == {n: min(times[(0, n)], times[(1, n)]) for n in (256, 1024, 2048)}
    assert result["hops_run"] == 6 * 7
    rows = [json.loads(line) for line in lines]
    assert [(r["rep"], r["slots"]) for r in rows] == [(r, n) for r in (0, 1)
                                                       for n in (256, 1024, 2048)]
    keys = {k[0]: k for k in _dumped_keys("multistream_frontier.py")}
    per_n, last = keys["slots"], keys["metric"]
    assert all(list(r)[:len(per_n)] == per_n and list(r)[len(per_n):] == ["chain_ms"]
               for r in rows)
    assert rows[0]["headroom"] == pytest.approx(deadline / times[(0, 256)])
    assert rows[0]["per_stream_us"] == pytest.approx(1e3 * times[(0, 256)] / 256)
    line = json.loads(mf.frontier_line(result, deadline, "cpu"))
    assert list(line)[:len(last)] == last and line["value"] == want
    assert line["hops_ms"] == {str(n): v for n, v in result["hops_ms"].items()}


def test_frontier_measure_runs_the_chain_on_cpu():
    trials, hops = 2, 8
    r = mf.measure(2, *_weights(), CONF, device="cpu", hops=hops, target_s=0.0, trials=trials)
    assert np.isfinite(r["wall_ms"]) and r["wall_ms"] > 0
    # the chain's marginal is a difference of two host times: on a shared
    # CPU at this size its sign is noise, so only its being a number is held
    assert np.isfinite(r["chain_ms"])
    # at target_s 0 the chains are 40 and 160 hops: the probe twice, both
    # warmed, then both each trial; plus the server's warm-up and the hops
    assert r["hops_run"] == 1 + hops + 2 * 40 + 200 + trials * 200
