"""The data pipeline and frozen encoder of ddsp_tpu_torch against
ddsp_tpu, same WAV files and weights, on CPU.

Tolerances, as the feature tests of the serving slice set them
(tests/test_torch_features.py): CREPE pitch bins equal, since a bin is
what the controller sees; loudness and CREPE probabilities at atol 1e-5
(float32 convolutions and FFTs summed in another order).  Examples loaded
from 16-bit WAV files at the configured rate are bit-equal: both packages
decode, mono-mix by the channel mean and cut windows with the same
arithmetic.
"""

import shutil

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data import dataset
from ddsp_tpu_torch.data.audio_io import UnsupportedAudioFormat, write_wav
from ddsp_tpu_torch.models.convert import crepe_from_jax

KW = dict(sample_rate=16000, n_fft=2048, hop_length=512, example_duration=1.0,
          example_overlap=0.5, batch_size=4)
CONF = Config(**KW)


def _tones(data_dir, seconds=(2.3, 1.6)):
    """Gliding harmonic tones as WAV files, the second one in stereo.

    A little noise (-50 dB) keeps every STFT bin far above the float32
    rounding of the transforms: in the spectral valleys of a pure tone a
    bin's dB value, and so the loudness, would compare rounding noise."""
    data_dir.mkdir()
    sr = CONF.sample_rate
    rng = np.random.default_rng(0)
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * sr)) / sr
        phase = 2 * np.pi * np.cumsum(180.0 * (1 + i) * (1 + 0.3 * t)) / sr
        audio = sum((0.4 / k) * np.sin(k * phase) for k in range(1, 4))
        audio = audio + 0.003 * rng.standard_normal(t.size)
        if i == 1:
            audio = np.stack([audio, 0.5 * audio[::-1]])
        write_wav(str(data_dir / f"tone{i}.wav"), audio.astype(np.float32), sr)
    return data_dir


@pytest.fixture(scope="module")
def crepes():
    """The same random CREPE tiny weights in both packages."""
    import jax

    from ddsp_tpu.models import crepe as jax_crepe

    params = jax_crepe.crepe_init(jax.random.PRNGKey(4), "tiny")
    return params, crepe_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _assert_features_equal(got, want):
    assert sorted(got) == sorted(want)
    bins_got = np.rint(got["normalized_cents"] * 359)
    bins_want = np.rint(np.asarray(want["normalized_cents"]) * 359)
    np.testing.assert_array_equal(bins_got, bins_want)
    np.testing.assert_allclose(got["f0"], np.asarray(want["f0"]), rtol=1e-6)
    for key in ("loudness", "probabilities", "harmonicity"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_load_examples_equal_jax(tmp_path):
    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.data import dataset as jax_dataset

    ours = _tones(tmp_path / "ours")
    theirs = tmp_path / "theirs"  # a copy: both packages name their caches alike
    shutil.copytree(ours, theirs)
    got = dataset.load_examples(CONF.replace(data_dir=str(ours)))
    want = jax_dataset.load_examples(JaxConfig(**KW, data_dir=str(theirs)))
    assert got.shape == want.shape and got.shape[1] == CONF.example_length
    np.testing.assert_array_equal(got, want)
    # the cache is read back
    np.testing.assert_array_equal(dataset.load_examples(CONF.replace(data_dir=str(ours))), got)


def test_encoder_apply_matches_jax(crepes):
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models.autoencoder import feature_pad as jax_feature_pad
    from ddsp_tpu.models.encoder import encoder_apply as jax_encoder_apply
    from ddsp_tpu_torch.models.autoencoder import encode

    jparams, crepe = crepes
    rng = np.random.default_rng(0)
    t = np.arange(CONF.example_length) / CONF.sample_rate
    audio = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 600, (3, 1)) * t)
             + 0.02 * rng.standard_normal((3, t.size))).astype(np.float32)
    jconf = JaxConfig(**KW)
    want = jax_encoder_apply(jparams, jax_feature_pad(jnp.asarray(audio), jconf), jconf)
    got = encode({"crepe": crepe}, torch.from_numpy(audio), CONF)
    assert got["f0"].shape == (3, CONF.frames_per_example, 1)
    _assert_features_equal({k: v.numpy() for k, v in got.items()}, want)


def test_extract_features_matches_jax_and_caches(tmp_path, crepes):
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.data import dataset as jax_dataset

    jparams, crepe = crepes
    ours = _tones(tmp_path / "ours")
    theirs = tmp_path / "theirs"
    shutil.copytree(ours, theirs)
    conf = CONF.replace(data_dir=str(ours))
    got = dataset.extract_features(crepe, conf, device="cpu")
    want = jax_dataset.extract_features(jparams, JaxConfig(**KW, data_dir=str(theirs)))
    _assert_features_equal({k: v for k, v in got.items() if k != "audio"},
                           {k: v for k, v in want.items() if k != "audio"})
    np.testing.assert_array_equal(got["audio"], want["audio"])
    assert len(list(ours.glob("features_tiny_*.npz"))) == 1
    cached = dataset.extract_features(crepe, conf, device="cpu")
    for key, value in got.items():
        np.testing.assert_array_equal(cached[key], value)
    # other CREPE weights: another cache file, not the stale features
    other = crepe_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x) * 1.01, jparams))
    dataset.extract_features(other, conf, device="cpu", include_probabilities=False)
    assert len(list(ours.glob("features_tiny_*.npz"))) == 2


def test_compressed_audio_raises(tmp_path, monkeypatch):
    """Without a decoder backend, a directory of compressed audio only
    raises (with one, it is listed: tests/test_torch_audio_io.py)."""
    monkeypatch.setattr(dataset, "have_compressed_backend", lambda: False)
    (tmp_path / "a.mp3").write_bytes(b"\xff\xfb\x90\x00")
    with pytest.raises(UnsupportedAudioFormat, match="convert to wav"):
        dataset.list_audio_files(str(tmp_path))
    with pytest.raises(ValueError, match="No valid audio"):
        dataset.list_audio_files(str(tmp_path / "missing"))


def test_batch_iterator_covers_each_row_once_and_is_deterministic():
    data = {"x": np.arange(22, dtype=np.float32)[:, None], "y": np.arange(22)}
    epochs = []
    for seed in (5, 5, 6):
        gen = torch.Generator().manual_seed(seed)
        batches = list(dataset.batch_iterator(data, 4, gen))
        assert len(batches) == 5 and all(b["x"].shape == (4, 1) for b in batches)
        rows = torch.cat([b["y"] for b in batches]).numpy()
        assert len(set(rows.tolist())) == 20  # each row at most once; 2 dropped
        np.testing.assert_array_equal(torch.cat([b["x"] for b in batches])[:, 0].numpy(), rows)
        epochs.append(rows)
    np.testing.assert_array_equal(epochs[0], epochs[1])
    assert not np.array_equal(epochs[0], epochs[2])
    full = list(dataset.batch_iterator(data, 4, torch.Generator(), shuffle=False,
                                       drop_last=False))
    np.testing.assert_array_equal(torch.cat([b["y"] for b in full]).numpy(), np.arange(22))
