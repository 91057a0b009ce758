"""The port's compressed-audio readers (``ddsp_tpu_torch.data.audio_io``)
against the JAX package's: the container header probes on synthetic
headers (those of tests/test_compressed_ingest.py), pygame's bundled mp3
and ogg fixtures decoded bit-equal to ``ddsp_tpu.data.audio_io.read_audio``
(skipped where pygame or the fixtures are absent), and the error when no
decoder backend is installed."""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import builtins
import importlib.util
import os
import shutil

import numpy as np
import pytest

from ddsp_tpu.data import audio_io as jax_audio_io
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data import audio_io, dataset
from ddsp_tpu_torch.data.audio_io import (
    UnsupportedAudioFormat,
    probe_flac,
    probe_mp3,
    probe_ogg_vorbis,
    read_audio,
)

def _pygame_example(name: str) -> str:
    """A sound file bundled with pygame's examples ('' without pygame)."""
    spec = importlib.util.find_spec("pygame")
    if spec is None or spec.origin is None:
        return ""
    return os.path.join(os.path.dirname(spec.origin), "examples", "data", name)


MP3_FIXTURE, OGG_FIXTURE = _pygame_example("house_lo.mp3"), _pygame_example("house_lo.ogg")


def _have_pygame_and_fixtures():
    return os.path.exists(MP3_FIXTURE) and os.path.exists(OGG_FIXTURE)


needs_pygame = pytest.mark.skipif(not _have_pygame_and_fixtures(),
                                  reason="pygame backend / fixtures not present")

ID3 = b"ID3\x04\x00\x00\x00\x00\x00\x05" + b"x" * 5
HEADERS = {  # name: (bytes, the port's probe, the JAX package's, (rate, channels))
    "mp3_mpeg1_stereo": (bytes([0xFF, 0xFA, 0x10, 0x40]) + b"\x00" * 8, probe_mp3,
                         jax_audio_io.probe_mp3, (44100, 2)),
    "mp3_mpeg2_mono": (bytes([0xFF, 0xF2, 0x14, 0xC0]), probe_mp3, jax_audio_io.probe_mp3,
                       (24000, 1)),
    "mp3_id3_skipped": (ID3 + bytes([0xFF, 0xFA, 0x10, 0xC0]), probe_mp3,
                        jax_audio_io.probe_mp3, (44100, 1)),
    "ogg_vorbis": (b"OggS" + b"\x00" * 24 + b"\x01vorbis" + b"\x00" * 4 + bytes([2])
                   + (48000).to_bytes(4, "little"), probe_ogg_vorbis,
                   jax_audio_io.probe_ogg_vorbis, (48000, 2)),
    "flac": (b"fLaC" + bytes([0x80, 0, 0, 34]) + bytes(10) + bytes([0x0A, 0xC4, 0x40])
             + bytes(21), probe_flac, jax_audio_io.probe_flac, (44100, 1)),
}
BAD = {  # name: (bytes, the port's probe, the JAX package's)
    "mp3": (b"\x00" * 64, probe_mp3, jax_audio_io.probe_mp3),
    "ogg": (b"RIFFxxxx", probe_ogg_vorbis, jax_audio_io.probe_ogg_vorbis),
    "flac": (b"OggS", probe_flac, jax_audio_io.probe_flac),
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_probe_matches_jax(name):
    data, probe, jax_probe, want = HEADERS[name]
    assert probe(data) == jax_probe(data) == want
    assert audio_io._probe_compressed(data) == jax_audio_io._probe_compressed(data) == want


@pytest.mark.parametrize("name", sorted(BAD))
def test_probe_rejects_what_jax_rejects(name):
    data, probe, jax_probe = BAD[name]
    with pytest.raises(jax_audio_io.UnsupportedAudioFormat):
        jax_probe(data)
    with pytest.raises(UnsupportedAudioFormat):
        probe(data)


@needs_pygame
@pytest.mark.parametrize("fixture", [MP3_FIXTURE, OGG_FIXTURE])
def test_fixture_decodes_bit_equal_to_jax(fixture):
    got, sr = read_audio(fixture)
    want, want_sr = jax_audio_io.read_audio(fixture)
    assert sr == want_sr == 11025  # the native rate from the header
    assert got.dtype == np.float32 and got.shape[0] == 1 and got.shape[1] > 5 * sr
    np.testing.assert_array_equal(got, want)


@needs_pygame
def test_oversized_id3_tag_reads_past_the_probe_head(tmp_path):
    """An ID3v2 tag larger than the 1 MB probe head (embedded album art):
    the reader extends the head past the tag, as the JAX package's does."""
    n = 1_500_000
    tag = b"ID3\x04\x00\x00" + bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                                      (n >> 7) & 0x7F, n & 0x7F]) + bytes(n)
    with open(MP3_FIXTURE, "rb") as f:
        (tmp_path / "big.mp3").write_bytes(tag + f.read())
    got, sr = audio_io.read_via_pygame(str(tmp_path / "big.mp3"))
    want, want_sr = jax_audio_io.read_via_pygame(str(tmp_path / "big.mp3"))
    assert sr == want_sr == 11025
    np.testing.assert_array_equal(got, want)


@needs_pygame
def test_mp3_corpus_flows_into_examples(tmp_path):
    """With a backend, an mp3-only corpus is listed and chunked, as the JAX
    package's dataset does: the same examples, bit for bit."""
    from ddsp_tpu.config import Config as JConfig
    from ddsp_tpu.data import dataset as jax_dataset

    shutil.copy(MP3_FIXTURE, tmp_path / "tune.mp3")
    assert audio_io.have_compressed_backend()
    files = dataset.list_audio_files(str(tmp_path))
    assert files == jax_dataset.list_audio_files(str(tmp_path))
    got = dataset.load_examples(Config(data_dir=str(tmp_path)), clear=True)
    want = jax_dataset.load_examples(JConfig(data_dir=str(tmp_path)), clear=True)
    assert got.shape == want.shape and got.shape[0] >= 9
    np.testing.assert_array_equal(got, want)


def test_no_backend_raises(tmp_path, monkeypatch):
    """Without soundfile, torchaudio, librosa and pygame, a compressed file
    raises UnsupportedAudioFormat naming the file and the backends."""
    real_import = builtins.__import__

    def no_backends(name, *args, **kwargs):
        if name.split(".")[0] in ("soundfile", "torchaudio", "librosa", "pygame"):
            raise ImportError(f"no module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_backends)
    path = str(tmp_path / "a.ogg")
    (tmp_path / "a.ogg").write_bytes(HEADERS["ogg_vorbis"][0])
    with pytest.raises(UnsupportedAudioFormat, match="a.ogg.*none installed"):
        read_audio(path)
