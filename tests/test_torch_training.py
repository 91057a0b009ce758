"""The training slice of ddsp_tpu_torch against ddsp_tpu, on CPU, and the
trainer's observable contracts (tests/test_training.py's, on the port).

Tolerances, each with its reason:

* ``split``: bit-equal (integer cipher).
* ``decoder_apply``: SNR > 110 dB against the JAX XLA path from the same
  weights and key; 129.0 dB measured on this config (float32 einsums,
  FFTs and GRU matmuls in another order).
* three train steps from the same weights, batch and key, with
  ``loss_matmul_dtype`` and ``reverb_grad_matmul_dtype`` pinned to
  'float32' on the JAX side: per-step loss within 1e-4 relative and
  grad_norm within 1e-3 relative (float32 sums over ~1e5 terms in another
  order; ~1e-6 and ~1e-5 measured), parameters after each step at
  ``allclose(rtol=2e-3, atol=3e-3)``, the repo's criterion for the same
  step on another layout (``__graft_entry__.py:48-64``).
* the same three steps with ``loss_matmul_dtype`` bf16 on the power-STFT
  route (``set_stft_impl('pallas')`` on both sides): the same criterion
  (K4's bf16 casts round the same values in both packages; measured in
  the test's docstring).
* the plateau schedule: equal to optax's ``reduce_on_plateau`` state,
  step for step.
"""

import json
import os

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.audio_io import write_wav
from ddsp_tpu_torch.models.convert import decoder_from_jax, decoder_to_jax
from ddsp_tpu_torch.models.controller import decoder_apply
from ddsp_tpu_torch.ops.fir import PRNGKey, split
from ddsp_tpu_torch.training import trainer

TINY = dict(
    sample_rate=4000, n_fft=256, hop_length=64, example_duration=0.5,
    n_harmonics=16, n_noise_filters=17, decoder_mlp_units=32,
    decoder_mlp_layers=1, decoder_gru_units=32, batch_size=4,
    mss_ffts=(256, 128, 64), checkpoint_every=0, log_every=5,
)
# the JAX side pinned to its exact-autodiff float32 paths
PINNED = dict(loss_matmul_dtype="float32", reverb_grad_matmul_dtype="float32",
              osc_impl="xla")
CONF = Config(**TINY)


def _batch(conf, n, seed=0):
    rng = np.random.default_rng(seed)
    t = conf.frames_per_example
    return {
        "f0": rng.uniform(100, 400, (n, t, 1)).astype(np.float32),
        "normalized_cents": rng.uniform(0, 1, (n, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0, 1, (n, t, 1)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((n, conf.example_length))).astype(np.float32),
    }


def _harmonic_features(conf, n=8, seed=0):
    """Harmonic targets the decoder can fit (tests/test_training.py's)."""
    rng = np.random.default_rng(seed)
    t = conf.frames_per_example
    ts = np.arange(conf.example_length) / conf.sample_rate
    audio = np.stack([
        sum((0.5 / k) * np.sin(2 * np.pi * 200.0 * k * ts + rng.uniform(0, 6))
            for k in range(1, 4))
        for _ in range(n)
    ]).astype(np.float32)
    return {
        "f0": np.full((n, t, 1), 200.0, np.float32),
        "normalized_cents": np.full((n, t, 1), 0.4, np.float32),
        "loudness": np.full((n, t, 1), 0.7, np.float32),
        "audio": audio,
    }


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_split_is_bit_equal_to_jax(seed):
    import jax

    key = jax.random.PRNGKey(seed)
    for num in (2, 3, 5):
        want = np.asarray(jax.random.split(key, num)).astype(np.int64)
        np.testing.assert_array_equal(split(PRNGKey(seed), num).numpy(), want)
    _, sub = jax.random.split(key)  # the trainer's per-step chain
    want = np.asarray(jax.random.split(sub)).astype(np.int64)
    np.testing.assert_array_equal(split(split(PRNGKey(seed))[1]).numpy(), want)


def test_decoder_apply_matches_jax():
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models import controller as jax_controller

    kw = dict(TINY, decoder_mlp_layers=2)
    jconf, conf = JaxConfig(**kw, **PINNED), Config(**kw)
    params = jax_controller.decoder_init(jax.random.PRNGKey(3), jconf)
    batch = _batch(conf, 3, seed=1)
    del batch["audio"]
    want = np.asarray(jax_controller.decoder_apply(params, batch, jconf, jax.random.PRNGKey(5)))
    decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, params), conf)
    with torch.no_grad():
        got = decoder_apply(decoder, _tensors(batch), conf, PRNGKey(5)).numpy()
    noise = want.astype(np.float64) - got
    assert 10 * np.log10(np.mean(want.astype(np.float64) ** 2) / np.mean(noise**2)) > 110.0


def test_three_train_steps_match_jax():
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.training import trainer as jax_trainer

    # An IR no longer than the 2000-sample example: taps past the example's
    # end have a true gradient of 0, and Adam normalises whatever float32
    # noise each FFT leaves there into a step of up to +-lr, so those taps
    # would drift apart by design; at 1024 taps every gradient is real.
    kw = dict(TINY, reverb_length=1024)
    jconf, conf = JaxConfig(**kw, **PINNED), Config(**kw)
    jstate = jax_trainer.init_state(jax.random.PRNGKey(0), jconf)
    decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), conf)
    state = trainer.TrainState(
        0, decoder, trainer.make_optimizer(conf).init(list(decoder.parameters())),
        torch.from_numpy(np.asarray(jstate.rng).astype(np.int64)),
    )
    jstep = jax.jit(jax_trainer.make_train_step(jconf))
    step = trainer.make_train_step(conf)
    batch = _batch(conf, conf.batch_size)
    for i in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tensors(batch))
        for name, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
            want, got = float(jm[name]), float(m[name])
            assert abs(got - want) <= rtol * abs(want), (i, name, got, want)
        assert state.step == i + 1
        np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jstate.rng).astype(np.int64))
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=2e-3, atol=3e-3),
            jstate.params, decoder_to_jax(state.params),
        )


@pytest.mark.parametrize("accumulation", [1, 3])
def test_plateau_schedule_equals_optax(accumulation):
    """A scripted loss that improves, then plateaus: the scale decays, and
    every field of the state equals optax's at every step."""
    import jax.numpy as jnp
    import optax

    patience, factor = 2, 0.1
    tx = optax.contrib.reduce_on_plateau(
        factor=factor, patience=patience, accumulation_size=accumulation
    )
    ours = trainer.AdamPlateau(1e-3, factor=factor, patience=patience,
                               accumulation_size=accumulation)
    params = {"w": jnp.zeros(3)}
    want = tx.init(params)
    got = ours.init([torch.zeros(3)]).plateau
    losses = [5.0, 4.0, 3.0] + [3.0, 3.1, 2.9999, 3.2] * 6 + [1.0] * 6
    scales = []
    for value in losses:
        _, want = tx.update(params, want, params, value=jnp.float32(value))
        got = ours.plateau_update(got, torch.tensor(value))
        for field in want._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
            )
        scales.append(float(got.scale))
    assert min(scales) <= factor**2 + 1e-9  # decayed more than once


def test_train_step_decreases_loss():
    feats = _harmonic_features(CONF)
    state = trainer.init_state(PRNGKey(0), CONF, device="cpu")
    step = trainer.make_train_step(CONF)
    batch = _tensors({k: v[:4] for k, v in feats.items()})
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(metrics["grad_norm"]))
    assert losses[-1] < losses[0] * 0.9, losses[::10]


def _params_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka


def test_fit_and_checkpoint_roundtrip(tmp_path):
    conf = CONF.replace(checkpoint_dir=str(tmp_path / "ckpt"))
    state, metrics = trainer.fit(
        conf, _harmonic_features(conf), num_steps=6,
        log_path=str(tmp_path / "metrics.jsonl"),
        dump_audio_dir=str(tmp_path / "audio"), device="cpu",
    )
    assert state.step == 6
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "metrics.jsonl").exists()
    assert list((tmp_path / "audio").glob("*.wav"))

    path = trainer.save_checkpoint(conf.checkpoint_dir, state, conf)
    trainer.wait_for_checkpoints()
    assert trainer.latest_checkpoint(conf.checkpoint_dir) == path
    assert json.loads((tmp_path / "ckpt" / "config.json").read_text())["n_harmonics"] == 16
    template = trainer.init_state(PRNGKey(99), conf, device="cpu")
    restored = trainer.restore_checkpoint(path, template)
    assert restored.step == 6
    _params_equal(restored.params, state.params)
    for a, b in zip(restored.opt_state.adam.mu, state.opt_state.adam.mu):
        assert torch.equal(a, b)
    for a, b in zip(restored.opt_state.plateau, state.opt_state.plateau):
        assert torch.equal(a, b)
    assert torch.equal(restored.rng, state.rng)


def test_fit_device_steps_with_remainder(tmp_path):
    """Device-resident minibatches: 22 steps in windows of 5 (a remainder
    window), a checkpoint every 10, dumps, and a window mean below the
    initial loss."""
    conf = CONF.replace(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=10)
    feats = _harmonic_features(conf)
    state, metrics = trainer.fit(
        conf, feats, num_steps=22, log_path=str(tmp_path / "metrics.jsonl"),
        dump_audio_dir=str(tmp_path / "audio"), device_steps=5, dump_every=4,
        device="cpu",
    )
    assert state.step == 22
    assert np.isfinite(metrics["loss"])
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [5, 10, 15, 20, 22]
    assert all("loss_mean" in r for r in rows)
    state0 = trainer.init_state(PRNGKey(0), CONF, device="cpu")
    with torch.no_grad():
        l0, _ = trainer.loss_fn(state0.params,
                                _tensors({k: v[:4] for k, v in feats.items()}),
                                CONF, PRNGKey(1))
    assert metrics["loss_mean"] < float(l0)
    assert trainer.latest_checkpoint(conf.checkpoint_dir).endswith("step_00000020")
    assert list((tmp_path / "audio").glob("*.wav"))


def test_cached_target_spectra_equal_the_plain_loss():
    batch = _tensors(_batch(CONF, 4, seed=3))
    state = trainer.init_state(PRNGKey(0), CONF, device="cpu")
    spectra = trainer._maybe_cache_target_spectra(CONF, batch["audio"])
    cached = {k: v for k, v in batch.items() if k != "audio"}
    cached.update(spectra)
    with torch.no_grad():
        want, _ = trainer.loss_fn(state.params, batch, CONF, PRNGKey(2))
        got, _ = trainer.loss_fn(state.params, cached, CONF, PRNGKey(2))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_fit_logs_eval_loss(tmp_path):
    conf = CONF.replace(log_every=2)
    log = str(tmp_path / "m.jsonl")
    for device_steps in (0, 2):  # host loop and device windows
        _, metrics = trainer.fit(
            conf, _batch(conf, 2 * conf.batch_size), num_steps=4, log_path=log,
            device_steps=device_steps,
            eval_features=_batch(conf, conf.batch_size // 2, seed=1),  # tiled
            device="cpu",
        )
        assert np.isfinite(metrics["eval_loss"]), metrics
    assert any("eval_loss" in json.loads(line) for line in open(log))


def test_checkpoint_retention_resave_and_temporary_dirs(tmp_path):
    conf = CONF.replace(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_keep=2)
    s1 = trainer.init_state(PRNGKey(0), conf, device="cpu")
    for step in (1, 2, 3, 4, 5):
        trainer.save_checkpoint(conf.checkpoint_dir, s1._replace(step=step), conf)
    trainer.wait_for_checkpoints()
    dirs = sorted(d for d in os.listdir(conf.checkpoint_dir) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]

    # a killed save leaves a temporary directory: never the latest
    (tmp_path / "ckpt" / "step_00000009.tmp-123").mkdir()
    assert trainer.latest_checkpoint(conf.checkpoint_dir).endswith("step_00000005")

    # a different state saved at an existing step overwrites it
    s2 = trainer.init_state(PRNGKey(7), conf, device="cpu")._replace(step=5)
    path = trainer.save_checkpoint(conf.checkpoint_dir, s2, conf, block=True)
    restored = trainer.restore_checkpoint(path, trainer.init_state(PRNGKey(3), conf, device="cpu"))
    _params_equal(restored.params, s2.params)
    with pytest.raises(FileNotFoundError, match="Orbax"):
        trainer.restore_checkpoint(str(tmp_path / "ckpt" / "step_00000009.tmp-123"), s1)


def test_train_cli_help(capsys):
    from ddsp_tpu_torch.training.train import main

    main(["--help"])
    out = capsys.readouterr().out
    assert "--num_steps" in out and "--data_dir" in out and "--device" in out


def _wav_dir(path, conf, seconds=(1.2, 0.9)):
    path.mkdir()
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * conf.sample_rate)) / conf.sample_rate
        f = 150.0 * (1 + i) * (1 + 0.2 * t)
        audio = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / conf.sample_rate)
        write_wav(str(path / f"tone{i}.wav"), audio.astype(np.float32), conf.sample_rate)
    return path


def test_train_cli_on_wav_files(tmp_path):
    from ddsp_tpu_torch.training.train import main

    data = _wav_dir(tmp_path / "data", CONF)
    ckpt = tmp_path / "ckpt"
    flags = [f"--{k}={json.dumps(list(v) if isinstance(v, tuple) else v)}"
             for k, v in TINY.items() if k not in ("checkpoint_every", "log_every")]
    main(flags + [f"--data_dir={data}", f"--checkpoint_dir={ckpt}", "--num_steps=4",
                  "--device_steps=2", "--checkpoint_every=2", "--log_every=2",
                  "--device=cpu"])
    rows = [json.loads(line) for line in open(ckpt / "metrics.jsonl")]
    assert rows[-1]["step"] == 4 and np.isfinite(rows[-1]["loss"])
    assert trainer.latest_checkpoint(str(ckpt)).endswith("step_00000004")

    # then CREPE finetuning: its metrics, and a checkpoint that a finetune
    # template restores, BatchNorm statistics included
    ft_ckpt = tmp_path / "ft_ckpt"
    state = main(flags + [f"--data_dir={data}", f"--checkpoint_dir={ft_ckpt}", "--num_steps=2",
                          "--device_steps=2", "--finetune_crepe=2", "--pitch_decode=weighted",
                          "--batch_size=2", "--log_every=1", "--device=cpu"])
    rows = [json.loads(line) for line in open(ft_ckpt / "finetune_metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
    latest = trainer.latest_checkpoint(str(ft_ckpt / "finetune"))
    assert latest.endswith("step_00000002") and state.step == 2
    template = trainer.init_finetune_state(
        PRNGKey(9), CONF.replace(pitch_decode="weighted", batch_size=2), device="cpu")
    restored = trainer.restore_checkpoint(latest, template)
    _params_equal(restored.params, state.params)
    assert "crepe.conv6_BN.running_var" in dict(restored.params.named_parameters())
    for a, b in zip(restored.opt_state.adam.nu, state.opt_state.adam.nu):
        assert torch.equal(a, b)

    # 'argmax' passes no gradient into CREPE: refused before any training
    before = (ckpt / "metrics.jsonl").read_text()
    with pytest.raises(ValueError, match="differentiable"):
        main(flags + [f"--data_dir={data}", f"--checkpoint_dir={ckpt}", "--num_steps=4",
                      "--finetune_crepe=5", "--device=cpu"])
    assert (ckpt / "metrics.jsonl").read_text() == before


def test_three_bf16_kernel_route_train_steps_match_jax():
    """``loss_matmul_dtype`` bf16 under ``set_stft_impl('pallas')`` on both
    sides: the decoder step's loss spectrograms on the power-STFT route
    (the plain versions of K3/K4 here, JAX's kernels in the Pallas
    interpreter), at the three-step criterion above."""
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.ops import spectral as jax_spectral
    from ddsp_tpu.training import trainer as jax_trainer
    from ddsp_tpu_torch.ops.spectral import set_stft_impl

    kw = dict(TINY, reverb_length=1024, loss_matmul_dtype="bfloat16")
    jconf = JaxConfig(**kw, reverb_grad_matmul_dtype="float32", osc_impl="xla")
    conf = Config(**kw)
    jstate = jax_trainer.init_state(jax.random.PRNGKey(0), jconf)
    decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), conf)
    state = trainer.TrainState(
        0, decoder, trainer.make_optimizer(conf).init(list(decoder.parameters())),
        torch.from_numpy(np.asarray(jstate.rng).astype(np.int64)),
    )
    batch = _batch(conf, conf.batch_size)
    jax_spectral.set_stft_impl("pallas")
    set_stft_impl("pallas")
    try:
        jstep = jax.jit(jax_trainer.make_train_step(jconf))
        step = trainer.make_train_step(conf)
        for i in range(3):
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, _tensors(batch))
            for name, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
                want, got = float(jm[name]), float(m[name])
                assert abs(got - want) <= rtol * abs(want), (i, name, got, want)
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=2e-3, atol=3e-3),
                jstate.params, decoder_to_jax(state.params),
            )
    finally:
        jax_spectral.set_stft_impl("auto")
        set_stft_impl("auto")


def test_server_serves_what_the_port_trained(tmp_path):
    """Train 2 steps, then the serving host's loader restores the same
    decoder from the checkpoint directory."""
    from ddsp_tpu_torch.runtime.server import load_decoder

    conf = CONF.replace(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    state, _ = trainer.fit(conf, _harmonic_features(conf), num_steps=2, device="cpu")
    _params_equal(load_decoder(conf), state.params)
    orbax = tmp_path / "orbax" / "step_00000002"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="JAX package"):
        load_decoder(conf.replace(checkpoint_dir=str(tmp_path / "orbax")))
