"""The port's offline reconstruction (``ddsp_tpu_torch.reconstruct``)
against the JAX package's (``ddsp_tpu.reconstruct``) on the same files and
weights, at the small width of tests/test_multistream.py, on the CPU; the
Lightning export both ways; the JAX trainer's Orbax checkpoints read by the
port; and, on the card (``cuda`` marker), one K1 launch a file.  jax and
the JAX package are imported inside the tests, so the card machine (no
jax) can collect this file."""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from ddsp_tpu_torch import reconstruct
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
from ddsp_tpu_torch.models import convert
from ddsp_tpu_torch.models.controller import decoder_init
from ddsp_tpu_torch.models.convert import (
    decoder_to_jax,
    find_latest_lightning_checkpoint,
    load_lightning_decoder,
)
from ddsp_tpu_torch.models.crepe import crepe_init, save_torch_checkpoint
from ddsp_tpu_torch.models.lightning_export import save_torch_decoder
from ddsp_tpu_torch.runtime import server
from ddsp_tpu_torch.training import trainer

SMALL = dict(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16, reverb_length=300,
    crepe_window=1024, crepe_sample_rate=16000,
)
CONF = Config(**SMALL)
CREPE_SEED = 2
# the port's float audio against the JAX package's, the exact fill on both
# CPUs: measured 118.6 dB; the floor leaves a margin under it
RECON_FLOOR_DB = 100.0
JSON_KEYS = {"seconds", "wall_s", "rms_in", "rms_out"}


def snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return float(10 * np.log10(np.sum(ref**2) / max(np.sum((ref - est) ** 2), 1e-300)))


def _glide_wav(path, rate, seconds, channels, seed):
    """A seeded gliding tone plus noise, ``channels`` channels."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    f = np.geomspace(110.0, 440.0, n)
    tone = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / rate)
    audio = tone[None] + 0.02 * rng.standard_normal((channels, n))
    write_wav(path, audio.astype(np.float32) * np.linspace(0.6, 1.0, channels)[:, None], rate)


def _jconf():
    from ddsp_tpu.config import Config as JConfig

    return JConfig(**SMALL)


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _params_equal(a, b):
    import jax

    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One seeded decoder as a Lightning .ckpt and a CREPE .pth, and a 1 s
    8 kHz stereo WAV, written once for the module."""
    d = tmp_path_factory.mktemp("recon")
    decoder = decoder_init(CONF, seed=0)
    with warnings.catch_warnings():  # the small width's reverb is not 1 s long
        warnings.simplefilter("ignore")
        save_torch_decoder(decoder, CONF, str(d / "dec.ckpt"))
    save_torch_checkpoint(crepe_init("tiny", seed=CREPE_SEED), str(d / "crepe.pth"))
    _glide_wav(str(d / "in.wav"), 8000, 1.0, 2, seed=5)
    return d, decoder


@pytest.fixture(scope="module")
def both_clis(files):
    """Both packages' CLIs on the same file, weights and flags, each with
    --export_torch: their JSON lines, the float audio each handed to its
    ``write_wav``, and the export paths."""
    import contextlib
    import io

    from ddsp_tpu import reconstruct as jax_reconstruct
    from ddsp_tpu.data import audio_io as jax_audio_io

    d, _ = files
    flags = [f"--{k}={json.dumps(v)}" for k, v in SMALL.items()]
    common = [f"--lightning_ckpt={d / 'dec.ckpt'}", f"--crepe_checkpoint={d / 'crepe.pth'}"]
    out = {}
    for name, main, module, extra in (
        ("jax", jax_reconstruct.main, jax_audio_io, []),
        ("torch", reconstruct.main, reconstruct, ["--device=cpu"]),
    ):
        written, write = [], module.write_wav

        def recorded(path, audio, rate, written=written, write=write):
            written.append(np.array(audio))
            write(path, audio, rate)

        buf = io.StringIO()
        module.write_wav = recorded
        try:
            with contextlib.redirect_stdout(buf):
                main([str(d / "in.wav"), str(d / f"out_{name}.wav"), *common,
                      f"--export_torch={d / f'export_{name}.ckpt'}", *flags, *extra])
        finally:
            module.write_wav = write
        line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("{"))
        out[name] = (json.loads(line), written[0], str(d / f"out_{name}.wav"),
                     str(d / f"export_{name}.ckpt"))
    return out


def test_prepare_audio_matches_jax(tmp_path):
    """A 22.05 kHz stereo WAV: mono mix, 22.05 -> 4 kHz resample, the n_fft
    and hop padding; the port's ops/resample against the JAX package's, 1e-6
    absolute (measured 1.5e-7)."""
    from ddsp_tpu import reconstruct as jax_reconstruct

    path = str(tmp_path / "in.wav")
    _glide_wav(path, 22050, 0.7, 2, seed=3)
    got = reconstruct.prepare_audio(path, CONF)
    want = jax_reconstruct.prepare_audio(path, _jconf())
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.shape[1] % CONF.hop_length == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a file shorter than n_fft is padded to it first
    write_wav(path, np.full(100, 0.25, np.float32), CONF.sample_rate)
    short = reconstruct.prepare_audio(path, CONF)
    np.testing.assert_array_equal(short, jax_reconstruct.prepare_audio(path, _jconf()))
    assert short.shape == (1, CONF.n_fft)


def test_reconstruct_cli_matches_jax(both_clis):
    """The same converted decoder and CREPE .pth through both CLIs: the
    float audio agrees at RECON_FLOOR_DB, the WAVs have one length and
    rate, and the JSON carries the JAX package's keys plus the device."""
    (j_stats, want, j_out, _) = both_clis["jax"]
    (t_stats, got, t_out, _) = both_clis["torch"]
    assert set(j_stats) == JSON_KEYS
    assert set(t_stats) == JSON_KEYS | {"device"} and t_stats["device"] == "cpu"
    assert got.shape == want.shape and got.dtype == np.float32
    db = snr_db(want, got)
    assert db > RECON_FLOOR_DB, db
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    (wav, sr), (wav_jax, sr_jax) = read_wav(t_out), read_wav(j_out)
    assert sr == sr_jax == CONF.sample_rate and wav.shape == wav_jax.shape == (1, got.size)
    for key in ("seconds", "rms_in", "rms_out"):
        assert t_stats[key] == pytest.approx(j_stats[key], rel=1e-5)


def test_long_file_aligns_crepe_frames(tmp_path):
    """A 4 s file at 44.1 kHz: the integer CREPE hop gives 346 windows for
    345 STFT frames, and the JAX package's reconstruction fails to join f0
    and loudness (a defect of the reference, not followed).  The port
    places the windows at the exact hop: one f0 frame per loudness frame."""
    from ddsp_tpu import reconstruct as jax_reconstruct
    from ddsp_tpu.config import Config as JConfig
    from ddsp_tpu.models.controller import decoder_init as jax_decoder_init

    from ddsp_tpu_torch.models.autoencoder import feature_pad
    from ddsp_tpu_torch.models.encoder import aligned_crepe_frames, encoder_apply

    wide = {k: v for k, v in SMALL.items()
            if k not in ("sample_rate", "n_fft", "hop_length", "reverb_length")}
    conf = Config(**wide, reverb_length=300)
    path = str(tmp_path / "in.wav")
    _glide_wav(path, 44100, 4.0, 1, seed=7)
    jconf = JConfig(**wide, reverb_length=300)
    import jax

    with pytest.raises(TypeError, match="concatenat"):
        jax_reconstruct.reconstruct_file(path, str(tmp_path / "j.wav"), jconf,
                                         decoder_params=jax_decoder_init(
                                             jax.random.PRNGKey(0), jconf))
    audio = feature_pad(torch.from_numpy(reconstruct.prepare_audio(path, conf)), conf)
    crepe = crepe_init("tiny", seed=CREPE_SEED)
    with torch.no_grad():
        feats = encoder_apply(crepe, audio, conf)
    assert feats["loudness"].shape[1] == feats["f0"].shape[1] == 345
    # the windows span the 16 kHz signal: the first at 0, the last within
    # one exact hop of its end, in steps of the hop's floor or ceiling
    length = int(np.ceil(audio.shape[1] * 16000 / 44100))
    starts = aligned_crepe_frames(torch.arange(length, dtype=torch.float64)[None],
                                  audio.shape[1], 345, conf)[0, :, 0].numpy()
    exact = conf.hop_length * (length - conf.crepe_window) / (audio.shape[1] - conf.n_fft)
    steps = np.diff(starts)
    assert starts[0] == 0 and length - conf.crepe_window - exact < starts[-1]
    assert starts[-1] <= length - conf.crepe_window
    assert set(steps) <= {np.floor(exact), np.ceil(exact)}
    stats = reconstruct.reconstruct_file(path, str(tmp_path / "o.wav"), conf,
                                         crepe_checkpoint="", decoder=decoder_init(conf),
                                         device="cpu")
    assert stats["seconds"] == pytest.approx(345 * 512 / 44100)


def test_export_matches_jax_both_ways(both_clis, files):
    """--export_torch: the same keys and bit-equal tensors as the JAX
    package's export, and each package's loader reads the other's file."""
    from ddsp_tpu.models.torch_import import load_lightning_decoder as jax_load

    _, decoder = files
    want = decoder_to_jax(decoder)
    j_file, t_file = both_clis["jax"][3], both_clis["torch"][3]
    j_blob = torch.load(j_file, weights_only=True)
    t_blob = torch.load(t_file, weights_only=True)
    assert set(t_blob) == set(j_blob)
    assert set(t_blob["state_dict"]) == set(j_blob["state_dict"])
    for k, v in j_blob["state_dict"].items():
        assert t_blob["state_dict"][k].dtype == v.dtype, k
        assert torch.equal(t_blob["state_dict"][k], v), k
    _params_equal(_numpy(jax_load(t_file, _jconf())), want)
    _params_equal(decoder_to_jax(load_lightning_decoder(j_file, CONF)), want)


def test_save_torch_decoder_bare_and_warning(tmp_path, files):
    from ddsp_tpu.models.torch_export import save_torch_decoder as jax_save

    _, decoder = files
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        save_torch_decoder(decoder, CONF, str(tmp_path / "bare.pt"), lightning=False, step=3)
        jax_save(decoder_to_jax(decoder), _jconf(), str(tmp_path / "bare_jax.pt"),
                 lightning=False)
    got, want = (torch.load(str(tmp_path / f), weights_only=True)
                 for f in ("bare.pt", "bare_jax.pt"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    # a reverb that is not 1 s long: the reference's strict load would fail
    with pytest.warns(UserWarning, match="reverb IR length 300"):
        save_torch_decoder(decoder, CONF, str(tmp_path / "w.ckpt"))


def test_find_latest_lightning_checkpoint(tmp_path):
    ckdir = tmp_path / "lightning_logs" / "version_3" / "checkpoints"
    ckdir.mkdir(parents=True)
    for name in ("epoch=2-step=30.ckpt", "epoch=11-step=120.ckpt", "epoch=9-step=90.ckpt",
                 "last.ckpt"):
        (ckdir / name).write_bytes(b"")
    from ddsp_tpu.models.torch_import import find_latest_lightning_checkpoint as jax_find_latest

    logs = str(tmp_path / "lightning_logs")
    got = find_latest_lightning_checkpoint(logs, 3)
    assert got == jax_find_latest(logs, 3) and got.endswith("epoch=11-step=120.ckpt")
    with pytest.raises(FileNotFoundError):
        find_latest_lightning_checkpoint(logs, 4)


@pytest.fixture(scope="module")
def orbax_dir(tmp_path_factory):
    """A JAX trainer checkpoint directory: ``save_checkpoint(block=True)``
    of a seeded TrainState, written with Orbax."""
    import jax

    from ddsp_tpu.training.trainer import init_state, save_checkpoint

    d = tmp_path_factory.mktemp("orbax")
    state = init_state(jax.random.PRNGKey(4), _jconf())
    save_checkpoint(str(d / "ckpt"), state._replace(step=7), _jconf(), block=True)
    return str(d / "ckpt"), _numpy(state.params)


def test_orbax_checkpoint_read_bit_equal(orbax_dir):
    """The port's loaders read the JAX trainer's step_* directory: the
    decoder bit-equal to the JAX state's parameters."""
    ckpt_dir, want = orbax_dir
    conf = CONF.replace(checkpoint_dir=ckpt_dir)
    step = trainer.latest_checkpoint(ckpt_dir)
    assert step.endswith("step_00000007") and convert.is_orbax_checkpoint(step)
    for decoder in (reconstruct.load_decoder_params(conf), server.load_decoder(conf),
                    trainer.load_checkpoint_decoder(step, conf)):
        _params_equal(decoder_to_jax(decoder), want)
    # the optimizer state is not read: resuming training from it raises
    template = trainer.init_state(torch.tensor([0, 0]), CONF, device="cpu")
    with pytest.raises(FileNotFoundError, match="Orbax checkpoint of the JAX package"):
        trainer.restore_checkpoint(step, template)


def test_reconstruct_from_orbax_checkpoint_dir(orbax_dir, files, capsys):
    """``--checkpoint_dir`` on a JAX Orbax directory: its config.json is the
    base config, and the run writes finite audio."""
    ckpt_dir, _ = orbax_dir
    d, _ = files
    reconstruct.main([str(d / "in.wav"), str(d / "out_orbax.wav"),
                      f"--checkpoint_dir={ckpt_dir}", f"--crepe_checkpoint={d / 'crepe.pth'}",
                      "--device=cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    audio, sr = read_wav(str(d / "out_orbax.wav"))
    assert sr == CONF.sample_rate and stats["device"] == "cpu"
    assert np.isfinite(audio).all() and audio.shape[1] == round(stats["seconds"] * sr)


def test_port_checkpoints_give_their_decoder(tmp_path):
    """The port's own step_* directories: a decoder state's and a finetune
    state's (its 'decoder.' entries) load bit-equal through the serving
    host's loader."""
    from ddsp_tpu_torch.ops.fir import PRNGKey

    train = trainer.init_state(PRNGKey(2), CONF, device="cpu")
    finetune = trainer.init_finetune_state(PRNGKey(3), CONF.replace(pitch_decode="weighted"),
                                           device="cpu")
    for name, state, decoder in (("train", train, train.params),
                                 ("finetune", finetune, finetune.params["decoder"])):
        conf = CONF.replace(checkpoint_dir=str(tmp_path / name))
        trainer.save_checkpoint(conf.checkpoint_dir, state, conf, block=True)
        got = server.load_decoder(conf)
        _params_equal(decoder_to_jax(got), decoder_to_jax(decoder))


def test_missing_tensorstore_raises_naming_it(orbax_dir, monkeypatch):
    ckpt_dir, _ = orbax_dir
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import fails
    with pytest.raises(ImportError, match="'tensorstore'"):
        server.load_decoder(CONF.replace(checkpoint_dir=ckpt_dir))


def test_non_checkpoint_directory_raises(tmp_path):
    (tmp_path / "step_00000001").mkdir()
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        server.load_decoder(CONF.replace(checkpoint_dir=str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="no finalized checkpoint"):
        reconstruct.load_decoder_params(CONF.replace(checkpoint_dir=str(tmp_path / "none")))


def test_non_finite_output_raises(files, tmp_path, monkeypatch):
    d, decoder = files
    monkeypatch.setattr(reconstruct, "autoencoder_apply",
                        lambda *a, **k: torch.full((1, 64), float("nan")))
    with pytest.raises(ValueError, match="non-finite"):
        reconstruct.reconstruct_file(str(d / "in.wav"), str(tmp_path / "o.wav"), CONF,
                                     crepe_checkpoint=str(d / "crepe.pth"), decoder=decoder,
                                     device="cpu")
    assert not os.path.exists(tmp_path / "o.wav")


def test_help_names_the_flags(capsys):
    reconstruct.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--checkpoint_dir", "--lightning_ckpt", "--crepe_checkpoint",
                 "--export_torch", "--device", "tensorstore", "PRNGKey(1)"):
        assert flag in out


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_reconstruct_file_launches_k1_once(cuda_device, files, tmp_path, monkeypatch):
    """On the card one file is one K1 launch (on the rotation fill) and no
    other hand kernel; the float audio it writes agrees with the CPU's
    plain path."""
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts

    d, decoder = files
    written, write = [], reconstruct.write_wav

    def recorded(path, audio, rate):
        written.append(np.array(audio))
        write(path, audio, rate)

    monkeypatch.setattr(reconstruct, "write_wav", recorded)
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        reconstruct.reconstruct_file(str(d / "in.wav"), str(tmp_path / f"{dev}.wav"), CONF,
                                     crepe_checkpoint=str(d / "crepe.pth"),
                                     decoder=decoder, device=dev)
        if dev == "cuda":
            counts, by_variant = launch_counts(), dict(osc_frames.VARIANT_LAUNCHES)
    assert by_variant == {osc_frames.variant_name("osc_frames_fwd", "rot"): 1}
    assert {k: v for k, v in counts.items() if v} == {"osc_frames_fwd": 1}
    out = dict(zip(("cuda", "cpu"), written))
    # measured 125.73 dB (float audio; H100 80GB HBM3, 700.00 W)
    assert snr_db(out["cpu"], out["cuda"]) > 90.0
