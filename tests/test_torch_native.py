"""The port's native host runtime (``ddsp_tpu_torch.native``): the SPSC ring
buffer in its native and Python modes, as tests/test_native.py holds the
JAX package's, the PCM conversions bit-equal to ``ddsp_tpu.native``'s, and
the parallel WAV corpus decoder bit-equal to ``ddsp_tpu.native``'s and to
``read_wav``.  A build that cannot run raises; it never falls back to the
Python ring or decoder."""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import struct
import threading

import numpy as np
import pytest

from ddsp_tpu_torch import native
from ddsp_tpu_torch.data.audio_io import UnsupportedAudioFormat, read_wav
from ddsp_tpu_torch.native import RingBuffer, f32_to_pcm16, load_corpus_mono, pcm16_to_f32


@pytest.fixture(params=["native", "python"])
def force_python(request):
    return request.param == "python"


def test_ring_basic(force_python):
    rb = RingBuffer(100, force_python=force_python)
    assert rb.capacity == 128
    assert rb.write(np.arange(10, dtype=np.float32)) == 10
    assert rb.readable() == 10 and rb.writable() == 118
    np.testing.assert_array_equal(rb.peek(4), np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(rb.read(6), np.arange(6, dtype=np.float32))
    assert rb.readable() == 4
    np.testing.assert_array_equal(rb.read(10), np.arange(6, 10, dtype=np.float32))
    assert rb.read(3).shape == (0,)


def test_ring_wraparound_and_overflow(force_python):
    rb = RingBuffer(8, force_python=force_python)
    assert rb.write(np.ones(6, np.float32)) == 6
    rb.read(6)
    x = np.arange(8, dtype=np.float32)  # wraps the storage
    assert rb.write(x) == 8
    assert rb.write(np.ones(3, np.float32)) == 0  # full
    np.testing.assert_array_equal(rb.read(8), x)


def test_ring_threaded_stream(force_python):
    """Producer and consumer on two threads: every sample arrives, in order."""
    rb = RingBuffer(1 << 12, force_python=force_python)
    total = 200_000
    src = np.random.default_rng(0).standard_normal(total).astype(np.float32)
    received = []

    def producer():
        pos = 0
        while pos < total:
            pos += rb.write(src[pos : pos + 777])

    def consumer():
        got = 0
        while got < total:
            chunk = rb.read(1024)
            got += len(chunk)
            if len(chunk):
                received.append(chunk)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    np.testing.assert_array_equal(np.concatenate(received), src)


def test_pcm_conversions_bit_equal_to_jax_package():
    from ddsp_tpu import native as jax_native

    rng = np.random.default_rng(3)
    audio = np.concatenate([rng.uniform(-1.2, 1.2, 5000), [0.0, -0.0, 1.0, -1.0, 2.0, -2.0,
                                                          0.99999, -0.99999]]).astype(np.float32)
    pcm = f32_to_pcm16(audio)
    want = jax_native.f32_to_pcm16(audio)
    assert pcm.dtype == np.int16
    np.testing.assert_array_equal(pcm, want)
    assert pcm[-4] == 32767 and pcm[-3] == -32768  # clipping
    ints = np.concatenate([rng.integers(-32768, 32768, 5000), [-32768, 32767, 0]]).astype(np.int16)
    back = pcm16_to_f32(ints)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, jax_native.pcm16_to_f32(ints))
    # any shape, the same values
    np.testing.assert_array_equal(f32_to_pcm16(audio[:5000].reshape(2, -1)),
                                  want[:5000].reshape(2, -1))


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    bad = tmp_path / "ringbuffer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on ringbuffer.cpp"):
        RingBuffer(16)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        f32_to_pcm16(np.zeros(4, np.float32))
    assert native._lib is None
    assert RingBuffer(16, force_python=True).capacity == 16  # the only way round


def _write_test_wav(path, audio, rate, bits, fmt="pcm"):
    """(channels, n) float audio as a WAV of ``bits`` (PCM, or IEEE float
    with fmt 'f32' / 'f64'), interleaved (tests/test_native.py's writer)."""
    ch = audio.shape[0]
    inter = audio.T.reshape(-1)
    if fmt == "f32":
        raw, tag = inter.astype("<f4").tobytes(), 3
    elif fmt == "f64":
        raw, tag = inter.astype("<f8").tobytes(), 3
    elif bits == 8:
        raw, tag = (np.clip(inter, -1, 1) * 127 + 128).astype(np.uint8).tobytes(), 1
    elif bits == 16:
        raw, tag = np.clip(inter * 32768, -32768, 32767).astype("<i2").tobytes(), 1
    elif bits == 24:
        i32 = np.clip(inter * (1 << 23), -(1 << 23), (1 << 23) - 1).astype(np.int32)
        b = np.zeros((len(i32), 3), np.uint8)
        b[:, 0], b[:, 1], b[:, 2] = i32 & 0xFF, (i32 >> 8) & 0xFF, (i32 >> 16) & 0xFF
        raw, tag = b.tobytes(), 1
    else:
        raw = np.clip(inter * (1 << 31), -(2**31), 2**31 - 1).astype("<i4").tobytes()
        tag = 1
    block = ch * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, tag, ch, rate, rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(raw)) + raw)


@pytest.mark.parametrize(
    "bits,fmt,ch",
    [(8, "pcm", 1), (16, "pcm", 2), (24, "pcm", 1), (32, "pcm", 2),
     (32, "f32", 2), (64, "f64", 1)],
)
def test_corpus_decoder_matches_jax_and_read_wav(tmp_path, bits, fmt, ch):
    """Native decode + mono mix == the JAX package's native decoder == the
    port's read_wav and channel mean, bit for bit."""
    from ddsp_tpu import native as jax_native

    rng = np.random.default_rng(bits + ch)
    audio = (0.8 * rng.standard_normal((ch, 1000))).clip(-1, 0.999).astype(np.float32)
    p = str(tmp_path / f"t{bits}{fmt}.wav")
    _write_test_wav(p, audio, 22050, bits, fmt)
    (got, sr), = load_corpus_mono([p])
    (want, want_sr), = jax_native.load_corpus_mono([p])
    wav, wav_sr = read_wav(p)
    assert sr == want_sr == wav_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, wav.mean(axis=0) if ch > 1 else wav[0])
    np.testing.assert_array_equal(got, load_corpus_mono([p], force_python=True)[0][0])


def test_corpus_decoder_many_files_threaded(tmp_path):
    """Twelve files of different lengths on 4 threads, in input order."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        p = str(tmp_path / f"f{i}.wav")
        _write_test_wav(p, (0.5 * rng.standard_normal((1 + i % 2, 300 + 17 * i))
                            ).astype(np.float32), 16000, 16)
        paths.append(p)
    got = load_corpus_mono(paths, n_threads=4)
    ref = load_corpus_mono(paths, force_python=True)
    assert [len(y) for y, _ in got] == [300 + 17 * i for i in range(12)]
    for (ga, gr), (ra, rr) in zip(got, ref):
        assert gr == rr == 16000
        np.testing.assert_array_equal(ga, ra)


def test_corpus_decoder_bad_file_raises_read_audio_error(tmp_path):
    """A file the native decoder rejects goes to read_audio, whose own
    error the caller sees."""
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"not a wav at all")
    with pytest.raises(UnsupportedAudioFormat, match="not a WAV file"):
        load_corpus_mono([p])


def test_corpus_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "wavloader.cpp"
    bad.write_text("this is not C++ either\n")
    monkeypatch.setattr(native, "CORPUS_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_corpus_lib", None)
    p = str(tmp_path / "a.wav")
    _write_test_wav(p, np.zeros((1, 10), np.float32), 8000, 16)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on wavloader.cpp"):
        load_corpus_mono([p])
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found: the native corpus decoder"):
        load_corpus_mono([p])
    assert native._corpus_lib is None
    assert load_corpus_mono([p], force_python=True)[0][1] == 8000  # the only way round
