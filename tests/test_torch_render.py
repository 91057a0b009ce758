"""The frame oscillator of ddsp_tpu_torch (the counterparts of K1 and K2)
against ddsp_tpu's, same numpy inputs, on CPU.

On the CPU the port's ``render_from_phase`` is its plain version with
ordinary autograd; it is held against the XLA path, ``jax.grad`` of it, and
the Pallas kernels K1 (``_pallas_forward(impl="banked2", fill="rot")``) and
K2 (``_pallas_backward(impl="banked2", fill="rot")``) run by the Pallas
interpreter, as tests/test_pallas_oscillator.py runs them.  The shape
B=2, T=18 (not a multiple of the TPU's 16-frame block), hop 128, H=40 is
that file's ragged shape.

Floors, as the JAX suite sets them (tests/test_pallas_oscillator.py):
renders > 80 dB SNR, final phase within 1e-6 cycles; gradients at
rtol 1e-3, atol 1e-4.

jax is imported inside the tests that compare with it, so the tests marked
``cuda`` also run on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_render.py``.
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import oscillator as osc
from ddsp_tpu_torch.ops.cuda import osc_frames

B, T, HOP, H, SR = 2, 18, 128, 40, 16000


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = want - np.asarray(got, np.float64)
    return float(10 * np.log10(np.mean(want**2) / np.mean(noise**2)))


def _controls(seed):
    """(B, T+2, .) padded controls and an initial phase."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(80.0, 600.0, (B, T + 2, 1)).astype(np.float32)
    amps = rng.uniform(0.01, 1.0, (B, T + 2, H)).astype(np.float32)
    loud = rng.uniform(0.0, 1.0, (B, T + 2, 1)).astype(np.float32)
    phase0 = rng.uniform(0.0, 1.0, (B,)).astype(np.float32)
    return f0, amps, loud, phase0


def _operands(seed, h_start, b=B, t=T, hop=HOP, h=H):
    """The kernels' operands as the path makes them: phase in cycles,
    Nyquist-normalised amplitude rows, loudness in [0, 1], and an audio
    gradient."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(80.0, 600.0, (b, t + 2, 1)).astype(np.float32)
    amps = torch.from_numpy(rng.uniform(0.01, 1.0, (b, t + 2, h)).astype(np.float32))
    amps = osc.nyquist_normalized_amps(torch.from_numpy(f0), amps, SR, h_start=h_start)
    return (
        rng.uniform(0.0, 1.0, (b, t, hop)).astype(np.float32),
        amps.numpy(),
        rng.uniform(0.0, 1.0, (b, t + 2)).astype(np.float32),
        rng.standard_normal((b, t * hop)).astype(np.float32),
    )


@pytest.mark.parametrize("h_start,normalize", [(0, True), (8, True), (8, False)])
def test_render_padded_matches_xla_path(h_start, normalize):
    """``normalize_amps=False`` takes amplitudes normalised by the caller
    (here over a wider bank), as a slice of the harmonics would."""
    import jax.numpy as jnp

    from ddsp_tpu.ops import oscillator as jax_osc

    f0, amps, loud, phase0 = _controls(seed=h_start)
    if not normalize:
        amps = amps / (2.0 * amps.sum(-1, keepdims=True))
    want, wphase = jax_osc.render_padded(
        jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(loud), sample_rate=SR,
        hop=HOP, initial_phase=jnp.asarray(phase0), h_start=h_start,
        normalize_amps=normalize,
    )
    t = torch.from_numpy
    got, gphase = osc.render_padded(
        t(f0), t(amps), t(loud), sample_rate=SR, hop=HOP,
        initial_phase=t(phase0), h_start=h_start, normalize_amps=normalize,
    )
    assert got.shape == (B, T * HOP)
    assert _snr(want, got.numpy()) > 80.0
    np.testing.assert_allclose(gphase.numpy(), np.asarray(wphase), atol=1e-6)


def test_oscillator_bank_matches_xla_path():
    import jax.numpy as jnp

    from ddsp_tpu.ops import oscillator as jax_osc

    f0, amps, loud, _ = _controls(seed=5)
    want, wphase = jax_osc.oscillator_bank(
        jnp.asarray(f0[:, 1:-1]), jnp.asarray(amps[:, 1:-1]),
        jnp.asarray(loud[:, 1:-1]), sample_rate=SR, hop=HOP,
    )
    t = torch.from_numpy
    got, gphase = osc.oscillator_bank(
        t(f0[:, 1:-1]), t(amps[:, 1:-1]), t(loud[:, 1:-1]), sample_rate=SR, hop=HOP
    )
    assert _snr(want, got.numpy()) > 80.0
    np.testing.assert_allclose(gphase.numpy(), np.asarray(wphase), atol=1e-6)


@pytest.fixture
def interpret():
    """Run Pallas kernels through the interpreter, as the JAX suite does."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("h_start", [0, 8])
def test_forward_matches_interpreted_k1(interpret, h_start):
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.oscillator import _pallas_forward

    phase, amps, loud, _ = _operands(seed=1 + h_start, h_start=h_start)
    want = _pallas_forward(
        jnp.asarray(phase), jnp.asarray(amps), jnp.asarray(loud), None,
        impl="banked2", fill="rot", h_start=h_start,
    )
    t = torch.from_numpy
    got = osc_frames.render_from_phase(t(phase), t(amps), t(loud), h_start)
    assert got.shape == (B, T * HOP)
    assert _snr(want, got.numpy()) > 80.0


@pytest.mark.parametrize("h_start", [0, 8])
def test_gradients_match_interpreted_k2_and_jax_grad(interpret, h_start):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.ops import oscillator as jax_osc
    from ddsp_tpu.ops.pallas.oscillator import _pallas_backward

    phase, amps, loud, g = _operands(seed=2 + h_start, h_start=h_start)
    j = [jnp.asarray(x) for x in (phase, amps, loud)]
    k2 = _pallas_backward(*j, jnp.asarray(g), None, impl="banked2", fill="rot",
                          h_start=h_start)
    _, vjp = jax.vjp(
        lambda p, a, l: jax_osc._render_from_phase(p, a, l, H, h_start), *j
    )
    xla = vjp(jnp.asarray(g))
    t = torch.from_numpy
    got = osc_frames.render_from_phase_bwd_plain(t(g), t(phase), t(amps), t(loud), h_start)
    for name, a, b, c in zip(("dphase", "d amps_pad", "d loud_pad"), k2, xla, got):
        assert c.shape == a.shape, name
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name} vs K2")
        np.testing.assert_allclose(c.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name} vs jax.grad")


def test_oscillator_bank_gradients_match_jax_grad():
    """Through the phase stage too: d/d(amps, loudness, f0) of sum(audio^2)."""
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.ops import oscillator as jax_osc

    f0, amps, loud, _ = _controls(seed=7)
    f0, amps, loud = f0[:1, 1:5], amps[:1, 1:5, :12], loud[:1, 1:5]

    def jax_loss(a, l, f):
        audio, _ = jax_osc.oscillator_bank(f, a, l, sample_rate=SR, hop=64)
        return jnp.sum(audio**2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(amps, loud, f0)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (amps, loud, f0)]
    audio, _ = osc.oscillator_bank(ts[2], ts[0], ts[1], sample_rate=SR, hop=64)
    got = torch.autograd.grad(audio.pow(2).sum(), ts)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-4)


def test_frame_chunk_equals_unchunked():
    """torch.utils.checkpoint chunks (6 frames of 18) give the same render
    and gradients; float32 einsums of another size may round differently,
    hence 1e-6 absolute."""
    f0, amps, loud, phase0 = _controls(seed=3)
    outs = []
    for chunk in (None, 6):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (f0, amps, loud)]
        audio, _ = osc.render_padded(*ts, sample_rate=SR, hop=HOP,
                                     initial_phase=torch.from_numpy(phase0),
                                     frame_chunk=chunk)
        grads = torch.autograd.grad(audio.pow(2).sum(), ts[1:])
        outs.append((audio.detach(), *grads))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        osc.render_padded(*(torch.from_numpy(x) for x in (f0, amps, loud)),
                          sample_rate=SR, hop=HOP, frame_chunk=5)


def test_cpu_takes_plain_version_and_launchers_refuse_cpu():
    phase, amps, loud, g = (torch.from_numpy(x) for x in _operands(seed=4, h_start=0))
    before = (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES)
    out = osc_frames.render_from_phase(phase, amps, loud)
    assert out.shape == (B, T * HOP)
    assert (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_frames_fwd(phase, amps, loud)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_frames_bwd(g, phase, amps, loud)
    with pytest.raises(ValueError, match="amps_pad must be"):
        osc_frames.osc_frames_fwd(phase, amps[:, 1:], loud)
    with pytest.raises(ValueError, match="outside"):
        osc_frames.osc_frames_fwd(phase, amps, loud, h_start=2048)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hop,h,h_start", [(2, 18, 128, 40, 8), (4, 172, 512, 180, 0)])
def test_kernel_pair_matches_plain_version_on_card(cuda_device, b, t, hop, h, h_start):
    """OscFrames against the plain version and its autograd on the card:
    forward > 90 dB, each gradient > 80 dB, two backward runs bit-equal."""
    ops = [torch.from_numpy(x).to(cuda_device)
           for x in _operands(seed=b + t, h_start=h_start, b=b, t=t, hop=hop, h=h)]
    phase, amps, loud, g = ops
    before = (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES)
    leaves = [x.clone().requires_grad_(True) for x in (phase, amps, loud)]
    got = osc_frames.render_from_phase(*leaves, h_start)
    grads = torch.autograd.grad(got, leaves, g)
    torch.cuda.synchronize()
    assert (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = osc_frames.render_from_phase_plain(phase, amps, loud, h_start)
    assert _snr(want.cpu().numpy(), got.detach().cpu().numpy()) > 90.0
    want_grads = osc_frames.render_from_phase_bwd_plain(g, phase, amps, loud, h_start)
    for a, c in zip(want_grads, grads):
        assert _snr(a.cpu().numpy(), c.cpu().numpy()) > 80.0
    again = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start)
    for a, c in zip(grads, again):
        assert torch.equal(a, c)
