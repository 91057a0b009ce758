"""The DDSP autoencoder's cell (``ddsp_autoencoder``, ``train_ae16k_b256``)
driven on the CPU at narrow widths and judged by the cell's own limits:
sound, and with z held at zero or the z encoder's leaves frozen; and the
readers of its three per-layer metrics."""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import counts, judge, tracing
from benchmark.registry import Registry
from benchmark.tests import tiny
from ddsp_tpu_torch.models import controller

REG = Registry(Path(__file__).resolve().parents[2])
CELL = "train_ae16k_b256"
# 24 frames of 16 samples at 16 kHz, the noise design (32 taps) twice the frame as in
# the configuration; z over 6 MFCC frames of 128 every 64
AE_FIELDS = dict(sample_rate=16000, hop_length=16, example_duration=0.024, n_fft=64, n_noise_filters=17,
                 reverb_length=256, mss_ffts=[128, 64], z_dims=4, z_time_steps=6, z_rnn_units=24)


def _run(tamper=None):
    model = REG.config_model(REG.cell(CELL)["config"])
    ctx = tiny.cpu_context(tiny.TRAIN_MIX, model=model, tamper=tamper, **AE_FIELDS)
    res = tiny.drive(ctx)
    assert res["attempted"] > 0
    return judge.verdict(res["numbers"], REG.limits(CELL))


def test_sound_autoencoder_run_is_correct():
    ok, rows = _run()
    assert ok, rows


def test_z_held_at_zero_is_caught(monkeypatch):
    """The decoder's z input zero: the encoder takes no gradient."""
    monkeypatch.setattr(controller, "z_encoder_apply",
                        lambda enc, audio, conf, frames: audio.new_zeros(
                            audio.shape[0], frames, conf.z_dims))
    ok, rows = _run()
    assert not ok, rows


def _frozen_encoder(step_fn):
    """The step runs, and the z encoder's leaves are put back as they were."""
    def frozen(state, batch):
        enc = state.params.z_encoder
        saved = [p.detach().clone() for p in enc.parameters()]
        new, metrics = step_fn(state, batch)
        with torch.no_grad():
            for p, s in zip(enc.parameters(), saved):
                p.copy_(s)
        return new, metrics

    return frozen


def test_frozen_z_encoder_is_caught():
    ok, rows = _run(_frozen_encoder)
    assert not ok, rows


def _window(device_s=None, context=None):
    return tracing.Window(window_s=2.0, busy_s=1.5, units=40, n_ops=1000,
                          device_s=device_s or {}, context=context or {})


def test_z_encoder_range_reader():
    read = REG.reader("z_encoder_ms.train")
    assert read(_window({"z_encoder": 0.2, "controller": 1.0})) == pytest.approx(5.0)
    assert read(_window({"controller": 1.0})) is None


def test_z_encoder_backward_span_reader():
    read = REG.reader("bwd_z_encoder_ms.train")
    table = {"backward.z_encoder": {"count": 40, "host_s": 0.1, "device_s": 0.4}}
    assert read(_window(context={"spans": table})) == pytest.approx(10.0)
    assert read(_window(context={"spans": {"backward.controller": table["backward.z_encoder"]}})) is None
    assert read(_window(context={"spans": {}})) is None


def test_gru_launch_reader():
    read = REG.reader("gru_steps_per_step.train")
    assert read(_window(context={"gru_fwd_launches_per_step": 1125.0})) == 1125.0
    assert read(_window(context={"unit_flops": 1.0})) is None


def test_cell_entries():
    """The cell reports the training metric and the new readers, which list it."""
    assert "train_audio_s_per_s" in REG.end_to_end(CELL)
    names = {m["name"] for m in REG.per_layer(CELL)}
    assert {"z_encoder_ms.train", "bwd_z_encoder_ms.train", "gru_steps_per_step.train",
            "mfu_pct.train", "launches_per_step.train", "osc_roofline.train",
            "loss_roofline.train"} <= names
    assert REG.config_model(REG.cell(CELL)["config"]).STAGES["train"][0] == "z_encoder"


def test_counts_give_the_oscillator_and_loss_bounds():
    """The rooflines of the oscillator and of the loss read their least
    seconds from the model's counts, at the cell's own size."""
    model = REG.config_model(REG.cell(CELL)["config"])
    cd = model.as_dict(model.config(REG.config(REG.cell(CELL)["config"])))
    ctx = SimpleNamespace(cd=cd, mix=REG.traffic(REG.cell(CELL)["traffic"]))
    got = model.train_counts(ctx)
    assert got["osc_bound_s"] == counts.osc_forward_bound_s(256, 1000, 64, 60)
    assert got["loss_bound_s"] == counts.mss_forward_bound_s(cd, 256, 64000)
    assert got["unit_flops"] > 0 and "gru_fwd_launches_per_step" not in got
