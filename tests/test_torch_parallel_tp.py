"""The port's harmonic-sharded renders (``ddsp_tpu_torch.parallel.tp``) on
CPU gloo groups, against the JAX package's sharded functions on the
8-device virtual mesh and against the port's unsharded render, from the
same seeded numpy inputs (tests/torch_parallel_refs.py; the counterparts
of tests/test_parallel.py:128-160, :201-220 and
tests/test_parallel_pallas.py:108-135).  One spawn per world size (2, 4),
as in tests/test_torch_parallel.py.

Floors, each no lower than the JAX suite's, with the values measured
(tests/parallel_numerics_report.py --renders):

* ``render_controls_tp`` on 2 and 4 ranks and 17 harmonics over 4 (the
  bank zero-padded to 20) on 'xla', against the port's unsharded render:
  > 80 dB (measured 134.6-135.2 dB); every model rank's rows bit-equal;
* on a ('data', 'model') 2 x 2 mesh at B = 2 (one row a data rank, its
  noise drawn at its global row), ``render_controls_tp`` and
  ``decoder_apply_tp`` against the port's unsharded render and decode:
  > 80 dB (134.9 and 133.0 dB), the gathered batch the same on every rank;
* ``render_controls_time_tp`` on 2 x 2: > 70 dB (131.1 dB);
* the 'pallas' impl (the rotation fill at each shard's ``h_start``; the
  port's plain version of K1, JAX's Pallas kernel in interpret mode):
  model on 2 and 4, time x model on 2 x 2: > 70 dB (131.9-134.8 dB);
* against JAX's sharded function: >= 110 dB (measured 124.3-129.9 dB;
  128.4-129.2 dB on the 2 x 2 ('data', 'model') mesh),
  with JAX's phase carry made exact where the time axis is sharded (see
  tests/test_torch_parallel.py).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import pytest

import torch_parallel_refs as refs

RENDERS = ["tp2", "tp4", "tp17_4", "dp_tp_2x2", "dp_tp_decode_2x2", "time_tp_2x2",
           "pallas_tp2", "pallas_tp4", "pallas_time_tp_2x2"]


@pytest.fixture(scope="module")
def port():
    future = refs.spawn(RENDERS)
    yield future
    future.result()


@pytest.mark.parametrize("name", RENDERS)
def test_tp_render_matches_jax_and_unsharded(port, name, monkeypatch):
    from ddsp_tpu.parallel import render as jax_render

    case = refs.cases()[name]
    want = refs.port_unsharded(name)
    results = port.result()[name]
    got = results[0]
    if case["kind"] in ("tp", "tp_decode"):
        for r in results[1:]:  # the gathered rows: one value on every rank
            assert (r == got).all()
    else:
        monkeypatch.setattr(jax_render, "_local_delta_total", refs.exact_local_delta_total)
    want_jax = refs.jax_render(name)
    assert got.shape == want.shape == want_jax.shape, (got.shape, want.shape, want_jax.shape)
    floor = 80.0 if case["kind"] in ("tp", "tp_decode") and "impl" not in case else 70.0
    assert refs.snr(want, got) > floor, refs.snr(want, got)
    assert refs.snr(want_jax, got) >= 110.0, refs.snr(want_jax, got)
