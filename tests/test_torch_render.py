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

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
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


def test_backward_launchers_refuse_cpu_and_bad_window_shapes():
    phase, amps, loud, g = (torch.from_numpy(x) for x in _operands(seed=5, h_start=0))
    da_win, dl_win = torch.zeros((B, T, 3, H)), torch.zeros((B, T, 3))
    before = (osc_frames.BWD_LAUNCHES, osc_frames.OVERLAP_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_frames_bwd_windows(g, phase, amps, loud)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_overlap_add(da_win, dl_win, T)
    with pytest.raises(ValueError, match="window gradients"):
        osc_frames.osc_overlap_add(da_win, dl_win, T + 1)
    with pytest.raises(ValueError, match="window gradients"):
        osc_frames.osc_overlap_add(da_win[:, :, :2], dl_win, T)
    assert (osc_frames.BWD_LAUNCHES, osc_frames.OVERLAP_LAUNCHES) == before


def test_overlap_add_plain_version_sums_windows_in_k_order():
    """The plain overlap-add (the CPU path, and what the card's kernel must
    equal bit for bit): row r = ((0 + win0[r]) + win1[r-1]) + win2[r-2]."""
    rng = np.random.default_rng(6)
    da_win = torch.from_numpy(rng.standard_normal((B, T, 3, H)).astype(np.float32))
    dl_win = torch.from_numpy(rng.standard_normal((B, T, 3)).astype(np.float32))
    d_amps, d_loud = osc_frames.overlap_add_windows(da_win, dl_win, T)
    for got, win in ((d_amps, da_win), (d_loud, dl_win)):
        for r in range(T + 2):
            want = torch.zeros_like(win[:, 0, 0])
            for k in range(3):
                if 0 <= r - k < T:
                    want = want + win[:, r - k, k]
            assert torch.equal(got[:, r], want)


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


# Shapes the kernels' ownership makes awkward: H of 1 and 7 (one ragged
# tile), the last harmonic at 2048 (h_start + H = 2048; at H = 301 the
# backward keeps one partial row a warp), hops that are no multiple of a
# block's samples (100, 200), a lone frame (B = T = 1), and the training
# width.
AWKWARD_SHAPES = [
    (1, 1, 100, 1, 0),
    (2, 3, 100, 7, 5),
    (1, 2, 64, 24, 2024),
    (1, 2, 64, 301, 1747),
    (3, 4, 200, 41, 8),
    (2, 5, 512, 180, 0),
]


def _raw_operands(seed, b, t, hop, h):
    """Operands without the Nyquist mask, which would zero every harmonic
    near 2048: amplitudes uniform / H (the sweep's operands)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (b, t, hop)).astype(np.float32),
            (rng.uniform(0.0, 1.0, (b, t + 2, h)) / h).astype(np.float32),
            rng.uniform(0.0, 1.0, (b, t + 2)).astype(np.float32),
            rng.standard_normal((b, t * hop)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["exact", "rot"])
@pytest.mark.parametrize("b,t,hop,h,h_start", AWKWARD_SHAPES)
def test_kernel_pair_at_awkward_shapes_on_card(cuda_device, b, t, hop, h, h_start, fill):
    """K1 and K2 (with its overlap-add) against their plain versions of the
    same fill: forward > 90 dB, each gradient > 80 dB, two backward runs
    bit-equal, one launch of each kernel per call."""
    phase, amps, loud, g = (torch.from_numpy(x).to(cuda_device)
                            for x in _raw_operands(b * t + h, b, t, hop, h))
    before = (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES, osc_frames.OVERLAP_LAUNCHES)
    got = osc_frames.osc_frames_fwd(phase, amps, loud, h_start, fill=fill)
    grads = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill=fill)
    again = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill=fill)
    torch.cuda.synchronize()
    assert (osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES,
            osc_frames.OVERLAP_LAUNCHES) == (before[0] + 1, before[1] + 2, before[2] + 2)
    want = osc_frames.render_from_phase_variant_plain(phase, amps, loud, h_start, fill)
    assert got.shape == want.shape
    assert _snr(want.cpu().numpy(), got.cpu().numpy()) > 90.0
    want_grads = osc_frames.render_from_phase_bwd_variant_plain(
        g, phase, amps, loud, h_start, fill)
    for a, c, c2 in zip(want_grads, grads, again):
        assert c.shape == a.shape
        assert _snr(a.cpu().numpy(), c.cpu().numpy()) > 80.0
        assert torch.equal(c, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [(1, 1, 1), (2, 3, 7), (3, 5, 41), (16, 172, 180)])
def test_overlap_add_kernel_is_bit_equal_to_plain_version(cuda_device, b, t, h):
    """The overlap-add kernel against overlap_add_windows on the same card
    tensors, bit for bit (signed zeros included)."""
    rng = np.random.default_rng(b + t + h)
    da = rng.standard_normal((b, t, 3, h)).astype(np.float32)
    dl = rng.standard_normal((b, t, 3)).astype(np.float32)
    da[rng.uniform(size=da.shape) < 0.1] = -0.0
    dl[..., 0] = -0.0
    da_win, dl_win = torch.from_numpy(da).to(cuda_device), torch.from_numpy(dl).to(cuda_device)
    before = osc_frames.OVERLAP_LAUNCHES
    got = osc_frames.osc_overlap_add(da_win, dl_win, t)
    want = osc_frames.overlap_add_windows(da_win, dl_win, t)
    torch.cuda.synchronize()
    assert osc_frames.OVERLAP_LAUNCHES == before + 1
    for a, c in zip(want, got):
        assert c.shape == a.shape
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
