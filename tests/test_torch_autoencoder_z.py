"""The DDSP autoencoder's z(t) in the port (``Config.z_dims`` above 0; the
port's own, so held against the benchmark's plain reference,
``benchmark/reference/autoencoder.py``, and not the JAX package), on the
same seeded weights at a narrow size: 2 examples of 24 frames of 16
samples at 16 kHz, z over 6 MFCC frames, 32 units.

* the MFCCs, and z upsampled to the frames: float32 FFTs by another route
  (``torch.stft`` against the rDFT of unfolded frames) and the mel and
  DCT matrices rounded from float64 by each side, through a log: 2e-5
  absolute on MFCCs of magnitude ~10 and on z;
* ``decoder_apply``'s audio: the reference's float64 oscillator phase
  against the port's float32 fill: 2e-5 of the output's RMS;
* every leaf's first gradient, the z encoder's included, within a share
  of its norm: through a smooth loss of the audio 5e-5 (the forward's
  float32 rounding against the float64 phase: 1.9e-5 at most on five
  seeds); through the MSS loss 2e-2 (its log2 term takes 1 / S_p times a
  sign, so its smallest and closest bins turn that rounding into up to
  8.2e-3 on the 40 seeds tried at this narrow size; the cases below are
  the first seed and the two worst);
* three ``make_train_step`` losses against the reference's Adam steps:
  the first 2e-6 relative (the forward's rounding: 1.4e-6 at most on the
  40 seeds tried), the later two 3e-4 (Adam moves a weight by about the
  learning rate whatever its gradient's size, so gradient elements near
  zero, whose sign float32 rounding decides, move them: up to 1.13e-4 on
  the 40 seeds; the cases below are the first seed and the two worst);
* the z encoder's span and its backward's in a profiler window;
* without z the decoder is kureta's: its keys, and its output against
  ``benchmark/reference/train.decode``; a default ``Config``'s JSON has no
  z key and z-less JSON round-trips;
* the entry points without a z path (serving, real time, reconstruction,
  the parallel steps, the JAX conversions) refuse a z configuration.
The test marked ``cuda`` counts the GRU's gate-kernel launches of a step
on the card (this file imports no jax: ``python -m pytest --noconftest -m
cuda tests/test_torch_autoencoder_z.py``).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import autoencoder as rae
from benchmark.reference import threefry
from benchmark.reference import train as rtrain
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models import convert
from ddsp_tpu_torch.models.controller import decoder_apply, decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init
from ddsp_tpu_torch.models.z_encoder import z_encoder_apply
from ddsp_tpu_torch.ops.spectral import mfcc
from ddsp_tpu_torch.parallel import sp, tp
from ddsp_tpu_torch.parallel import train as ptrain
from ddsp_tpu_torch.reconstruct import reconstruct_file
from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer, make_synth_stream_step
from ddsp_tpu_torch.training import trainer
from ddsp_tpu_torch.utils import profiling

SMALL = dict(
    sample_rate=16000, example_duration=0.024, hop_length=16, n_fft=64, n_harmonics=20,
    reverb_length=256, decoder_mlp_units=32, decoder_gru_units=32, mss_ffts=(128, 64),
)
Z_CONF = Config(n_noise_filters=17, z_dims=4, z_time_steps=6, z_rnn_units=32, **SMALL)
PLAIN_CONF = Config(n_noise_filters=9, **SMALL)  # a 16-tap design: dsp.py pads it
B = 2


def _cd(conf):
    return dict(dataclasses.asdict(conf), frames=conf.frames_per_example)


def _batch(conf, seed=0):
    rng = np.random.default_rng(seed)
    t, length = conf.frames_per_example, conf.example_length
    f0 = rng.uniform(100.0, 600.0, (B, 1, 1)) * np.ones((1, t, 1))
    n = np.arange(length) / conf.sample_rate
    audio = 0.3 * np.sin(2 * np.pi * f0[:, :1, 0] * n) + 0.02 * rng.standard_normal((B, length))

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    return {"audio": f32(audio), "f0": f32(f0), "normalized_cents": f32(rng.uniform(0, 1, (B, t, 1))),
            "loudness": f32(rng.uniform(0, 1, (B, t, 1)))}


def _decoder(conf, seed=1):
    dec = decoder_init(conf, seed)
    if dec.z_encoder is not None:  # a norm away from its identity start
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            dec.z_encoder.norm_scale.uniform_(0.5, 1.5, generator=gen)
            dec.z_encoder.norm_shift.uniform_(-0.5, 0.5, generator=gen)
    return dec


def _weights(dec):
    return {k: v.detach().clone() for k, v in dec.state_dict().items()}


def test_mfcc_and_z_match_the_reference():
    batch, dec = _batch(Z_CONF), _decoder(Z_CONF)
    cd, w = _cd(Z_CONF), _weights(dec)
    got = mfcc(batch["audio"], 16000, 128, 64, 128, 30, 20.0, 8000.0)
    want = rae.mfcc(batch["audio"], cd)
    assert got.shape == (B, 6, 30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    with torch.no_grad():
        z = z_encoder_apply(dec.z_encoder, batch["audio"], Z_CONF, 24)
        z_ref = rae.encode_z(w, cd, batch["audio"], 24)
    assert z.shape == (B, 24, 4)
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), atol=2e-5)
    # frame t between z frames t // 4 and t // 4 + 1; the last z frame held
    ups = rae.upsample(torch.arange(6.0)[None, :, None], 24)[0, :, 0]
    assert ups[:4].tolist() == [0.0, 0.25, 0.5, 0.75] and ups[-4:].tolist() == [5.0] * 4


def _loss(dec, conf, batch, key):
    return trainer.loss_fn(dec, batch, conf, key)[0]


@pytest.mark.parametrize("seed", [1, 2, 18])
def test_decoder_audio_and_first_gradient_match_the_reference(seed):
    batch, dec = _batch(Z_CONF, seed), _decoder(Z_CONF, seed + 1)
    cd, w = _cd(Z_CONF), _weights(dec)
    key = threefry.seed_key(seed + 6)
    with torch.no_grad():
        got = decoder_apply(dec, batch, Z_CONF, key)
        want = rae.decode(w, cd, batch, slice(0, B), key)
    rms = float(want.square().mean().sqrt())
    assert float((got - want).square().mean().sqrt()) < 2e-5 * rms
    names = [k for k, _ in dec.named_parameters()]
    params = [p for _, p in dec.named_parameters()]
    leaves = {k: v.requires_grad_(True) for k, v in w.items()}
    proj = torch.randn(B, Z_CONF.example_length, generator=torch.Generator().manual_seed(0))

    def smooth(audio):
        return (audio * proj).sum() + 0.5 * audio.square().sum()

    for (got_loss, ref_loss), tol in (
            ((smooth(decoder_apply(dec, batch, Z_CONF, key)),
              smooth(rae.decode(leaves, cd, batch, slice(0, B), key))), 5e-5),
            ((_loss(dec, Z_CONF, batch, key),
              rae.block_loss(leaves, cd, batch, slice(0, B), key)), 2e-2)):
        grads = torch.autograd.grad(got_loss, params)
        ref_grads = torch.autograd.grad(ref_loss, [leaves[k] for k in names])
        for name, g, r in zip(names, grads, ref_grads):
            assert float(r.norm()) > 0, name
            assert float((g - r).norm()) <= tol * float(r.norm()), name
    assert any(k.startswith("z_encoder.") for k in names)


@pytest.mark.parametrize("seed", [0, 21, 38])
def test_three_train_steps_match_the_reference(seed):
    batches = [_batch(Z_CONF, seed + s) for s in (3, 4, 5)]
    dec = _decoder(Z_CONF, seed + 3)
    w = _weights(dec)
    key = threefry.seed_key(seed + 11)
    step = trainer.make_train_step(Z_CONF)
    opt = trainer.make_optimizer(Z_CONF)
    state = trainer.TrainState(0, dec, opt.init(list(dec.parameters())), key.clone())
    got = []
    for batch in batches:
        state, metrics = step(state, batch)
        got.append(float(metrics["loss"]))
    ref = rtrain.steps(w, _cd(Z_CONF), batches, key, block=B, block_loss=rae.block_loss)
    np.testing.assert_allclose(got[0], ref["loss"][0], rtol=2e-6)
    np.testing.assert_allclose(got[1:], ref["loss"][1:], rtol=3e-4)


def test_the_z_encoder_has_its_spans():
    profiling.reset_spans()
    dec, batch = _decoder(Z_CONF), _batch(Z_CONF)
    step = trainer.make_train_step(Z_CONF)
    state = trainer.TrainState(0, dec, trainer.make_optimizer(Z_CONF).init(
        list(dec.parameters())), threefry.seed_key(1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch)
    names = [r[0] for r in profiling.span_records()]
    profiling.reset_spans()
    assert names.index("z_encoder") < names.index("controller")
    backward = [n for n in names if n.startswith("backward.")]
    assert backward[-2:] == ["backward.controller", "backward.z_encoder"]


def test_without_z_the_decoder_and_json_are_kuretas():
    dec = _decoder(PLAIN_CONF, 4)
    assert dec.z_encoder is None
    assert not any("z" in k.split(".")[1] for k in dec.state_dict() if k.startswith("controller."))
    assert not any(k.startswith("z_encoder") for k in dec.state_dict())
    assert dec.controller.gru.weight_ih_l0.shape[1] == 2 * 32
    batch, key = _batch(PLAIN_CONF, 2), threefry.seed_key(3)
    with torch.no_grad():
        got = decoder_apply(dec, batch, PLAIN_CONF, key)
        want = rtrain.decode(_weights(dec), _cd(PLAIN_CONF), batch["f0"],
                             batch["normalized_cents"], batch["loudness"], key, torch.arange(B))
    rms = float(want.square().mean().sqrt())
    assert float((got - want).square().mean().sqrt()) < 2e-5 * rms
    assert "z_" not in Config().to_json()
    assert Config.from_json(PLAIN_CONF.to_json()) == PLAIN_CONF
    assert Config.from_json(Z_CONF.to_json()) == Z_CONF
    assert '"z_dims": 4' in Z_CONF.to_json()


def test_fit_checkpoints_and_finetuning_take_z(tmp_path):
    """``fit`` (per-step and device-resident with cached target spectra, the
    audio kept for z), a checkpoint's round trip, and a finetune step."""
    conf = Z_CONF.replace(checkpoint_dir=str(tmp_path / "ckpt"), batch_size=2)
    feats = {k: v.numpy() for k, v in _batch(conf).items()}
    for device_steps in (0, 2):
        state, metrics = trainer.fit(conf, feats, num_steps=2, device_steps=device_steps,
                                     dump_audio_dir=str(tmp_path / "audio"), device="cpu")
        assert state.step == 2 and np.isfinite(metrics["loss"])
    path = trainer.save_checkpoint(conf.checkpoint_dir, state, conf)
    trainer.wait_for_checkpoints()
    assert '"z_dims": 4' in (tmp_path / "ckpt" / "config.json").read_text()
    restored = trainer.restore_checkpoint(path, trainer.init_state(torch.tensor([0, 9]), conf,
                                                                   device="cpu"))
    for (ka, a), (kb, b) in zip(restored.params.state_dict().items(),
                                state.params.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    # CREPE's aligned hop needs some 2,000 samples: 128 frames, z over 6 MFCC frames of 682
    ft_conf = conf.replace(pitch_decode="weighted", example_duration=0.128)
    ft_state = trainer.init_finetune_state(torch.tensor([0, 3]), ft_conf, device="cpu")
    before = ft_state.params["decoder"].z_encoder.dense_z.weight.detach().clone()
    ft_state, metrics = trainer.make_finetune_step(ft_conf)(ft_state, {"audio": _batch(ft_conf)["audio"]})
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(ft_state.params["decoder"].z_encoder.dense_z.weight, before)


def _state(conf):
    return trainer.init_state(torch.tensor([0, 5]), conf, device="cpu")


REFUSALS = {
    "MultiStreamServer": lambda c: MultiStreamServer(
        decoder_init(c), crepe_init("tiny", 1), c, 2, device="cpu"),
    "BlockSynthesizer": lambda c: BlockSynthesizer(decoder_init(c), crepe_init("tiny", 1), c,
                                                   device="cpu"),
    "make_synth_stream_step": lambda c: make_synth_stream_step(decoder_init(c), c,
                                                               torch.tensor([0, 1])),
    "reconstruct_file": lambda c: reconstruct_file("in.wav", "out.wav", c,
                                                   decoder=decoder_init(c), device="cpu"),
    "make_parallel_train_step": lambda c: ptrain.make_parallel_train_step(c, None, device="cpu"),
    "make_sp_train_step": lambda c: sp.make_sp_train_step(c, None, device="cpu"),
    "make_tp_train_step": lambda c: tp.make_tp_train_step(c, None, device="cpu"),
    "decoder_from_jax": lambda c: convert.decoder_from_jax({}, c),
    "decoder_to_jax": lambda c: convert.decoder_to_jax(decoder_init(c)),
    "train_state_from_jax": lambda c: convert.train_state_from_jax({}, _state(c)),
    "train_state_to_jax": lambda c: convert.train_state_to_jax(_state(c)),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_entry_points_without_z_refuse_it(name):
    with pytest.raises(ValueError, match=f"{name} does not support a z encoder"):
        REFUSALS[name](Z_CONF)


@pytest.mark.cuda
def test_gate_kernels_run_both_recurrences_on_card():
    """On the card the encoder's recurrence is on the GRU's gate kernels
    too: a step launches one forward and one backward gate kernel a frame
    of each sequence (24 decoder frames and 6 z frames)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ddsp_tpu_torch.ops.cuda import gru

    dev = torch.device("cuda", 0)
    dec = _decoder(Z_CONF).to(dev)
    batch = {k: v.to(dev) for k, v in _batch(Z_CONF).items()}
    step = trainer.make_train_step(Z_CONF)
    state = trainer.TrainState(0, dec, trainer.make_optimizer(Z_CONF).init(
        list(dec.parameters())), threefry.seed_key(1, dev))
    fwd, bwd = gru.FWD_LAUNCHES, gru.BWD_LAUNCHES
    state, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    assert (gru.FWD_LAUNCHES - fwd, gru.BWD_LAUNCHES - bwd) == (30, 30)
