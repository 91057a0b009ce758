"""The port's serving path on CPU: against ddsp_tpu's multi-stream step, and
per-slot equivalence with a lone stream inside the port.

Floors:
* port vs ddsp_tpu (same weights, noise seed and blocks): SNR >= 80 dB per
  slot.  Both run float32 on the CPU but in different libraries (CREPE
  convolutions, FFTs, matmul summation order); the measured agreement is
  far above the floor, which leaves room for library changes.
* slot vs lone stream within the port: atol 1e-5, as the JAX contract
  (tests/test_multistream.py) -- the same code on a batch of N rows and on
  a batch of one.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ddsp_tpu.config import Config as JaxConfig
from ddsp_tpu.models.controller import decoder_init as jax_decoder_init
from ddsp_tpu.models.crepe import crepe_init as jax_crepe_init
from ddsp_tpu.runtime.multistream import make_multistream_flush as jax_flush
from ddsp_tpu.runtime.multistream import make_multistream_step as jax_step
from ddsp_tpu.runtime.multistream import multistream_init as jax_init
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.convert import crepe_from_jax, decoder_from_jax
from ddsp_tpu_torch.ops.fir import PRNGKey, fold_in
from ddsp_tpu_torch.runtime.multistream import (
    MultiStreamServer,
    make_multistream_flush,
    make_multistream_step,
    multistream_init,
    reset_slots,
)
from ddsp_tpu_torch.runtime.server import StreamServer, stream_blocks
from ddsp_tpu_torch.runtime.streaming import (
    feature_stream_init,
    make_feature_stream_step,
    make_synth_stream_flush,
    make_synth_stream_step,
    synth_stream_init,
)

SMALL = dict(
    sample_rate=4000,
    n_fft=256,
    hop_length=64,
    n_harmonics=12,
    n_noise_filters=9,
    decoder_mlp_units=16,
    decoder_mlp_layers=1,
    decoder_gru_units=16,
    reverb_length=300,
    crepe_window=1024,
    crepe_sample_rate=16000,
)
CONF = Config(**SMALL)
N = 3


@pytest.fixture(scope="module")
def jax_weights():
    return (
        jax_decoder_init(jax.random.PRNGKey(0), JaxConfig(**SMALL)),
        jax_crepe_init(jax.random.PRNGKey(1), "tiny"),
    )


@pytest.fixture(scope="module")
def weights(jax_weights):
    params, crepe = (jax.tree_util.tree_map(np.asarray, w) for w in jax_weights)
    return decoder_from_jax(params, CONF), crepe_from_jax(crepe)


def _blocks(n_blocks, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * CONF.hop_length) / CONF.sample_rate
    sig = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)).astype(np.float32)
    sig += (0.01 * rng.standard_normal(sig.size)).astype(np.float32)
    return sig.reshape(n_blocks, CONF.hop_length)


def _run_port(weights, per_slot, key):
    step = make_multistream_step(*weights, CONF, key)
    state = multistream_init(CONF, len(per_slot))
    outs = []
    for j in range(per_slot[0].shape[0]):
        out, state = step(state, torch.from_numpy(np.stack([p[j] for p in per_slot])))
        outs.append(out.numpy())
    return np.stack(outs, axis=1), state


def _run_single(weights, key, blocks):
    """The lone-stream oracle over one slot's blocks."""
    params, crepe = weights
    feat_step = make_feature_stream_step(crepe, CONF)
    synth_step = make_synth_stream_step(params, CONF, key)
    fs, ss = feature_stream_init(CONF), synth_stream_init(CONF)
    outs = []
    for b in blocks:
        frame, fs = feat_step(fs, torch.from_numpy(b).reshape(1, -1))
        out, ss = synth_step(ss, frame)
        outs.append(out.numpy()[0])
    return np.stack(outs), ss


def test_multistream_step_matches_jax(jax_weights, weights, snr):
    n_blocks = 7
    per_slot = [_blocks(n_blocks, seed=10 + i) for i in range(N)]
    jparams, jcrepe = jax_weights
    jconf = JaxConfig(**SMALL, osc_impl="xla")
    step = jax_step(jparams, jcrepe, jconf, jax.random.PRNGKey(5))
    state = jax_init(jconf, N)
    want = []
    for j in range(n_blocks):
        out, state = step(state, jnp.asarray(np.stack([p[j] for p in per_slot])))
        want.append(np.asarray(out))
    want = np.stack(want, axis=1)
    want_tail = np.asarray(jax_flush(jparams, jconf, jax.random.PRNGKey(5))(state)[0])

    got, tstate = _run_port(weights, per_slot, PRNGKey(5))
    got_tail = make_multistream_flush(weights[0], CONF, PRNGKey(5))(tstate)[0].numpy()
    assert np.abs(want).max() > 1e-3  # the comparison is of real audio
    for i in range(N):
        assert snr(want[i], got[i]) >= 80.0, i
        assert snr(want_tail[i], got_tail[i]) >= 80.0, i
    np.testing.assert_array_equal(tstate.n_seen.numpy(), np.asarray(state.n_seen))


def test_slot_equals_lone_stream_and_flush(weights):
    key = PRNGKey(5)
    per_slot = [_blocks(6, seed=20 + i) for i in range(N)]
    got, state = _run_port(weights, per_slot, key)
    tail = make_multistream_flush(weights[0], CONF, key)(state)[0].numpy()
    for i in range(N):
        want, ss = _run_single(weights, fold_in(key, i), per_slot[i])
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5, err_msg=f"slot {i}")
        want_tail, _ = make_synth_stream_flush(weights[0], CONF, fold_in(key, i))(ss)
        np.testing.assert_allclose(tail[i], want_tail.numpy()[0], rtol=0, atol=1e-5)


def test_reset_slot_replays_fresh_stream(weights):
    key = PRNGKey(5)
    pre = [_blocks(3, seed=30 + i) for i in range(N)]
    post = [_blocks(4, seed=40 + i) for i in range(N)]
    step = make_multistream_step(*weights, CONF, key)
    state = multistream_init(CONF, N)
    for j in range(3):
        _, state = step(state, torch.from_numpy(np.stack([p[j] for p in pre])))
    state = reset_slots(CONF, state, 1)
    got = []
    for j in range(4):
        out, state = step(state, torch.from_numpy(np.stack([p[j] for p in post])))
        got.append(out.numpy())
    got = np.stack(got, axis=1)
    want1, _ = _run_single(weights, fold_in(key, 1), post[1])
    np.testing.assert_allclose(got[1], want1, rtol=0, atol=1e-5)
    want0, _ = _run_single(weights, fold_in(key, 0), np.concatenate([pre[0], post[0]]))
    np.testing.assert_allclose(got[0], want0[3:], rtol=0, atol=1e-5)


def test_masked_step_freezes_inactive_rows(weights):
    key = PRNGKey(5)
    step = make_multistream_step(*weights, CONF, key, masked=True)
    state = multistream_init(CONF, N)
    blocks = [_blocks(3, seed=50 + i) for i in range(N)]
    active = torch.tensor([True, False, True])
    for j in range(3):
        new = step(state, torch.from_numpy(np.stack([b[j] for b in blocks])), active)[1]
        for old_t, new_t in zip(jax.tree_util.tree_leaves(state),
                                jax.tree_util.tree_leaves(new)):
            row = 1 if old_t.dim() == 3 and old_t.shape[1] == N and old_t.shape[0] != N else 0
            assert torch.equal(old_t.select(row, 1), new_t.select(row, 1))
        state = new
    assert state.n_seen.tolist() == [3, 0, 3]


def test_stream_server_matches_multistream_server(weights, tmp_path):
    """Two concurrent socket clients get what their slots give when the
    same blocks go through MultiStreamServer in lockstep."""
    n_blocks = 5
    per_client = [_blocks(n_blocks, seed=60 + i) for i in range(2)]
    address = str(tmp_path / "serve.sock")
    server = StreamServer(*weights, CONF, address, n_streams=2, noise_seed=3,
                          device="cpu").start()
    results = {}

    def client(i):
        results[i] = stream_blocks(address, per_client[i], timeout=60)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()

    ref = MultiStreamServer(*weights, CONF, n_streams=2, noise_seed=3, device="cpu")
    by_slot = {slot: per_client[i] for i, (_, slot) in results.items()}
    assert sorted(by_slot) == [0, 1]
    want = [ref.process(np.stack([by_slot[0][j], by_slot[1][j]])) for j in range(n_blocks)]
    want = np.stack(want + [ref.flush()], axis=1)  # (2, n_blocks + 1, hop)
    for i, (audio, slot) in results.items():
        assert audio.shape == (n_blocks + 1, CONF.hop_length)
        np.testing.assert_allclose(audio, want[slot], rtol=0, atol=1e-5)


def test_stream_file_through_server(weights, tmp_path):
    """A WAV file at another rate streams through the socket host: resampled
    to the server's rate, padded to whole hops, one flush tail at the end."""
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.runtime.server import stream_file

    src = tmp_path / "in.wav"
    t = np.arange(3000) / 8000
    write_wav(str(src), 0.5 * np.sin(2 * np.pi * 220 * t), 8000)
    address = str(tmp_path / "serve.sock")
    server = StreamServer(*weights, CONF, address, n_streams=1, device="cpu").start()
    try:
        audio = stream_file(address, str(src), str(tmp_path / "out.wav"), timeout=60)
    finally:
        server.close()
    n_hops = -(-1500 // CONF.hop_length)  # 3000 samples at 8 kHz -> 1500 at 4 kHz
    assert audio.shape == ((n_hops + 1) * CONF.hop_length,)
    assert np.isfinite(audio).all()
    back, rate = read_wav(str(tmp_path / "out.wav"))
    assert rate == CONF.sample_rate and back.shape == (1, audio.size)
