"""The port's single-stream real-time path on the CPU, against the JAX
package's, and within the port.

Tolerances, each with its reason (measured on this config, CPU):

* ``oscillator_live`` against ``ddsp_tpu``'s, with and without context,
  two blocks with the phase carried: SNR >= 100 dB (measured 140.4-141.7
  dB on the audio; the carried phase equal, held within 1e-6 cycles);
  both run the exact fill in float32, the sums in another order.
* ``BlockSynthesizer`` against ``ddsp_tpu``'s, 40 blocks of a 220 Hz tone
  plus seeded noise and the flush: the CREPE bin of every frame equal and
  SNR >= 80 dB, the multi-stream test's floor (measured 81.5 dB: the
  float32 features, controller, noise filter and reverb differ in their
  last bits between the libraries, and the seeded reverb's peak |audio|
  of 4.7 carries them).
  Within the port the same run equals ``utils/slot_parity.lone_stream``
  plus the flush step bit for bit.
* ``run_file_loopback``: the JAX package's block count and output length;
  the output WAV bit-equal to the port's own BlockSynthesizer run, peak
  limited and quantised as the loopback writes it; and against the
  offline ``decoder_apply`` render of the streamed features, the JAX
  suite's floors (> 55 dB, the tail hop > 40 dB; measured 84.7 and 85.4
  dB, bounded by the WAV's 16-bit quantisation).
* ``run_jack`` through ``tests/jack_double.py``: blocksize, port names and
  auto-wiring as the JAX suite asserts them, output bit-equal to a
  BlockSynthesizer run.
* ``ThreadedSynthesizer``: what the worker writes, read back from the
  output ring past the latency pre-fill, bit-equal to a BlockSynthesizer
  over the same hops.

The card test (``cuda`` marker) holds BlockSynthesizer on CUDA to one K5
launch a hop on the rotation fill, and each hop's K5 output (N = 1)
against its plain version on the same operands at SNR > 90 dB, the
kernel floor of ``chip_smoke.py``.  jax is imported inside the tests, so
the card machine (no jax) can collect this file.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import importlib
import sys
import time

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
from ddsp_tpu_torch.models.controller import decoder_apply, decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init
from ddsp_tpu_torch.models.synths import oscillator_live
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.runtime.streaming import (
    BlockSynthesizer,
    feature_stream_init,
    make_feature_stream_step,
)
from ddsp_tpu_torch.utils.slot_parity import lone_stream

# tests/test_streaming.py's config
SMALL = dict(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16,
    reverb_length=300, crepe_window=1024, crepe_sample_rate=16000,
)
CONF = Config(**SMALL)
HOP = CONF.hop_length
N_BLOCKS = 40


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = np.mean((want - np.asarray(got, np.float64)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(want**2) / noise))


def _tone(n_blocks, seed, freq=220.0):
    """(n_blocks, hop) float32: a tone plus seeded noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * HOP) / CONF.sample_rate
    sig = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    sig += (0.01 * rng.standard_normal(sig.size)).astype(np.float32)
    return sig.reshape(n_blocks, HOP)


@pytest.fixture(scope="module")
def jax_weights():
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models.controller import decoder_init as jax_decoder_init
    from ddsp_tpu.models.crepe import crepe_init as jax_crepe_init

    return (jax_decoder_init(jax.random.PRNGKey(0), JaxConfig(**SMALL)),
            jax_crepe_init(jax.random.PRNGKey(1), "tiny"))


@pytest.fixture
def weights(jax_weights):
    """Fresh port modules with the JAX weights (a BlockSynthesizer moves its
    modules to its device in place)."""
    import jax

    from ddsp_tpu_torch.models.convert import crepe_from_jax, decoder_from_jax

    params, crepe = (jax.tree_util.tree_map(np.asarray, w) for w in jax_weights)
    return decoder_from_jax(params, CONF), crepe_from_jax(crepe)


def _live_controls(seed, b=2, t=5):
    rng = np.random.default_rng(seed)
    return {
        "f0": rng.uniform(80.0, 400.0, (b, t, 1)).astype(np.float32),
        "c": rng.uniform(0.01, 1.0, (b, t, CONF.n_harmonics)).astype(np.float32),
        "a": rng.uniform(0.0, 1.0, (b, t, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("with_context", [False, True])
def test_oscillator_live_matches_jax(with_context):
    """Two consecutive blocks, the second starting from the first's final
    phase (and from a non-zero phase before that)."""
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models.synths import oscillator_live as jax_live

    jconf = JaxConfig(**SMALL, osc_impl="xla")
    blocks = [_live_controls(seed) for seed in (1, 2)]
    edges = [_live_controls(seed, t=1) for seed in (3, 4, 5)]
    jphase = jnp.asarray([0.25, 0.7], jnp.float32)
    phase = torch.tensor([0.25, 0.7])
    for i, block in enumerate(blocks):
        ctx = ({"prev": edges[i], "next": edges[i + 1]} if with_context else None)
        want, jphase = jax_live(
            {k: jnp.asarray(v) for k, v in block.items()}, jconf, jphase,
            None if ctx is None else {s: {k: jnp.asarray(v) for k, v in c.items()}
                                      for s, c in ctx.items()})
        got, phase = oscillator_live(
            {k: torch.from_numpy(v) for k, v in block.items()}, CONF, phase,
            None if ctx is None else {s: {k: torch.from_numpy(v) for k, v in c.items()}
                                      for s, c in ctx.items()})
        assert got.shape == (2, 5 * HOP)
        assert np.abs(np.asarray(want)).max() > 1e-2
        assert _snr(want, got.numpy()) >= 100.0, (i, _snr(want, got.numpy()))
        np.testing.assert_allclose(phase.numpy(), np.asarray(jphase), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_block_run(jax_weights):
    """The JAX package's BlockSynthesizer over N_BLOCKS tone blocks and its
    flush, and its feature stream's pitch bin of every frame."""
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.runtime import streaming as jax_streaming

    jconf = JaxConfig(**SMALL, osc_impl="xla")
    blocks = _tone(N_BLOCKS, seed=7)
    synth = jax_streaming.BlockSynthesizer(*jax_weights, jconf, noise_seed=3)
    outs = [synth.process(b) for b in blocks] + [synth.flush()]
    step = jax_streaming.make_feature_stream_step(jax_weights[1], jconf)
    state = jax_streaming.feature_stream_init(jconf)
    bins = []
    for b in blocks:
        frame, state = step(state, jnp.asarray(b).reshape(1, -1))
        bins.append(round(float(frame["normalized_cents"][0, 0, 0]) * 359))
    return blocks, np.stack(outs), np.array(bins)


def test_block_synthesizer_matches_jax_and_the_lone_stream(weights, jax_block_run):
    blocks, want, want_bins = jax_block_run
    synth = BlockSynthesizer(*weights, CONF, noise_seed=3, device="cpu")
    got = np.stack([synth.process(b) for b in blocks] + [synth.flush()])
    assert synth.blocks == N_BLOCKS and synth.missed_deadlines >= 0
    assert got.shape == want.shape == (N_BLOCKS + 1, HOP)
    assert np.abs(want[2:]).max() > 1e-3  # the comparison is of real audio
    lone, bins = lone_stream(*weights, CONF, PRNGKey(3), blocks, torch.device("cpu"),
                             flush=True)
    np.testing.assert_array_equal(bins, want_bins)
    assert _snr(want, got) >= 80.0, _snr(want, got)
    np.testing.assert_array_equal(got, lone)


def _loopback_wav(path, n_blocks):
    write_wav(path, _tone(n_blocks, seed=11, freq=180.0).reshape(-1), CONF.sample_rate)
    return read_wav(path)[0][0]  # what the loopback consumes


def test_run_file_loopback_matches_jax_and_the_block_synthesizer(weights, jax_weights,
                                                                 tmp_path):
    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.runtime.jack_io import run_file_loopback as jax_loopback
    from ddsp_tpu_torch.runtime.jack_io import run_file_loopback

    n_blocks = 24
    in_path = str(tmp_path / "in.wav")
    mono = _loopback_wav(in_path, n_blocks)
    want_stats = jax_loopback(*jax_weights, JaxConfig(**SMALL, osc_impl="xla"), in_path,
                              str(tmp_path / "jax.wav"))
    stats = run_file_loopback(*weights, CONF, in_path, str(tmp_path / "out.wav"),
                              device="cpu")
    assert stats["blocks"] == want_stats["blocks"] == n_blocks
    assert stats["missed_deadlines"] >= 0 and stats["realtime_factor"] > 0
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == CONF.sample_rate
    assert out.shape == read_wav(str(tmp_path / "jax.wav"))[0].shape == (1, n_blocks * HOP)
    assert np.abs(out[0, -HOP:]).max() > 1e-3  # the flushed tail hop carries signal

    synth = BlockSynthesizer(*weights, CONF, device="cpu")
    rendered = [synth.process(b) for b in mono.reshape(n_blocks, HOP)]
    rendered = np.concatenate(rendered[1:] + [synth.flush()])
    wav = str(tmp_path / "want.wav")
    write_wav(wav, rendered / max(1.0, np.abs(rendered).max() / 0.9), CONF.sample_rate)
    np.testing.assert_array_equal(out, read_wav(wav)[0])

    # and, as tests/test_streaming.py holds the JAX loopback, to the offline
    # render of the streamed features (every frame, the tail included),
    # after unit-peak normalisation (the WAV is peak-limited and 16-bit)
    feat_step = make_feature_stream_step(weights[1], CONF)
    state, frames = feature_stream_init(CONF), []
    for b in mono.reshape(n_blocks, HOP):
        frame, state = feat_step(state, torch.from_numpy(b).reshape(1, -1))
        frames.append(frame)
    feats = {k: torch.cat([f[k] for f in frames], dim=1) for k in frames[0]}
    with torch.no_grad():
        offline = decoder_apply(weights[0], feats, CONF, PRNGKey(0))[0].numpy()
    o, g = offline / np.abs(offline).max(), out[0] / np.abs(out[0]).max()
    assert _snr(o, g) > 55.0 and _snr(o[-HOP:], g[-HOP:]) > 40.0, (_snr(o, g), _snr(o[-HOP:], g[-HOP:]))


def test_run_jack_through_fake_server(weights):
    import jack_double

    import ddsp_tpu_torch.runtime.jack_io as jack_io

    blocks = _tone(6, seed=7)
    jack_double.configure(blocks)
    sys.modules["jack"] = jack_double
    try:
        importlib.reload(jack_io)
        assert jack_io.HAS_JACK
        jack_io.run_jack(*weights, CONF, device="cpu")  # returns on the fake shutdown
        client = jack_double.last_client
    finally:
        sys.modules.pop("jack", None)
        importlib.reload(jack_io)
    assert not jack_io.HAS_JACK
    assert client.blocksize == HOP
    assert [p.name for p in client.inports] == ["input_1"]
    assert [p.name for p in client.outports] == ["output_1"]
    assert client.connections[0] == ("system:capture_1", client.inports[0])
    assert client.connections[1] == (client.outports[0], "system:playback_1")
    got = np.stack(client.captured_out)
    oracle = BlockSynthesizer(*weights, CONF, device="cpu")
    np.testing.assert_array_equal(got, np.stack([oracle.process(b) for b in blocks]))


@pytest.mark.parametrize("force_python_ring", [False, True])
def test_threaded_synthesizer_writes_the_block_synthesizer_stream(weights, force_python_ring):
    """Hops pushed at a steady pace; the samples read from the output ring
    (pulls plus the drained rest, without underrun fill) are the latency
    pre-fill and then exactly the BlockSynthesizer's blocks."""
    from ddsp_tpu_torch.runtime.threaded import ThreadedSynthesizer

    n, latency = 20, 3
    blocks = _tone(n, seed=13)
    oracle = BlockSynthesizer(*weights, CONF, device="cpu")
    want = np.concatenate([oracle.process(b) for b in blocks])
    with ThreadedSynthesizer(*weights, CONF, latency_hops=latency, device="cpu",
                             force_python_ring=force_python_ring) as synth:
        read, real = synth._out.read, []
        synth._out.read = lambda k: real.append(read(k)) or real[-1]
        for b in blocks:
            synth.push(b)
            time.sleep(0.002)
            assert synth.pull(HOP).shape == (HOP,)
        deadline = time.monotonic() + 60.0  # the worker drains the input ring
        while synth._synth.blocks < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert synth._synth.blocks == n, synth._synth.blocks
        real.append(read(synth._out.readable()))
    stream = np.concatenate(real)
    assert synth.underruns >= 0 and not synth._thread.is_alive()
    assert stream.shape == ((n + latency) * HOP,)
    np.testing.assert_array_equal(stream[: latency * HOP], 0.0)
    np.testing.assert_array_equal(stream[latency * HOP :], want)


def test_profile_realtime_rows_on_cpu():
    """``utils/profile_realtime`` at the small width: every row timed, the
    BlockSynthesizer and the one-slot server equal to their lone streams,
    and the modules' synthesizer class restored after each timed run."""
    from ddsp_tpu_torch.runtime import jack_io, threaded
    from ddsp_tpu_torch.utils.profile_realtime import profile

    result = profile(3, device="cpu", conf=CONF, loopback_seconds=0.1)
    for when in ("before_profiler", "after_profiler"):
        rows = result[when]
        assert set(rows) == {"lone_steps", "block", "loopback", "threaded", "multistream_1"}
        assert rows["block"]["calls"] == rows["threaded"]["calls"] == 3
        assert rows["loopback"]["calls"] == rows["loopback"]["blocks"] == 6
    assert all(v["bit_equal"] for v in result["vs_lone"].values()), result["vs_lone"]
    assert jack_io.BlockSynthesizer is threaded.BlockSynthesizer is BlockSynthesizer


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_block_synthesizer_launches_k5_once_a_hop_on_card(cuda_device, monkeypatch):
    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda

    conf = CONF
    params, crepe = decoder_init(conf, seed=0), crepe_init(seed=1)
    blocks = _tone(12, seed=5)
    calls, launch = [], osc_cuda.osc_hop_slots

    def recorded(*args, **kwargs):
        calls.append((args, kwargs, launch(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(osc_cuda, "osc_hop_slots", recorded)
    osc_cuda.VARIANT_LAUNCHES.clear()
    synth = BlockSynthesizer(params, crepe, conf, device=cuda_device)
    got = np.stack([synth.process(b) for b in blocks] + [synth.flush()])
    assert dict(osc_cuda.VARIANT_LAUNCHES) == {osc_cuda.variant_name("rot"): 12 + 2}
    assert len(calls) == 12 + 2 and all(c[0][0].shape == (1, conf.hop_length) for c in calls)
    k5 = torch.cat([c[2] for c in calls]).cpu().numpy()
    plain = torch.cat([osc_cuda.render_hop_slots_plain(*a, **kw) for a, kw, _ in calls])
    assert _snr(plain.cpu().numpy(), k5) > 90.0
    monkeypatch.undo()
    lone, _ = lone_stream(params, crepe, conf, PRNGKey(0, cuda_device), blocks, cuda_device,
                          flush=True)
    np.testing.assert_array_equal(got, lone)
    assert np.isfinite(got).all() and np.abs(got[2:]).max() > 1e-3
