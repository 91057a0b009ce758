"""The port's native host runtime (``ddsp_tpu_torch.native``): the SPSC ring
buffer in its native and Python modes, as tests/test_native.py holds the
JAX package's, and the PCM conversions bit-equal to ``ddsp_tpu.native``'s.
A build that cannot run raises; it never falls back to the Python ring."""

import threading

import numpy as np
import pytest

from ddsp_tpu_torch import native
from ddsp_tpu_torch.native import RingBuffer, f32_to_pcm16, pcm16_to_f32


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
