"""The training loss and the offline reverb of ddsp_tpu_torch against
ddsp_tpu, same numpy inputs, on CPU.

Tolerances, each with its reason:

* ``spectrogram``: rtol 1e-3, atol 1e-3, the JAX suite's own floor for a
  spectrogram against torch (tests/test_spectral.py:42); the JAX side runs
  its float32 DFT matmuls (``matmul_dtype=None``), the port ``torch.stft``.
* MSS loss terms, plain and cached: rtol 1e-4 (float32 sums over ~1e5
  bins in another order).
* ``rfft_convolve_same`` / ``reverb_apply`` outputs within 1e-5 of the
  output's peak (two float32 FFT algorithms); gradients at rtol 1e-3, atol
  1e-4 (tests/test_pallas_oscillator.py's gradient floor), with the JAX
  reverb backward pinned to float32 (``reverb_grad_matmul_dtype``).
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch import losses
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.synths import Reverb, reverb_apply
from ddsp_tpu_torch.ops.fft import rfft_convolve_same
from ddsp_tpu_torch.ops.spectral import reflect_pad, spectrogram

FFTS = (2048, 1024, 512, 256, 128, 64)  # the default MSS sizes
CONF = Config(sample_rate=4000, reverb_length=700, reverb_grad_matmul_dtype="float32")


def _audio(n, length, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((n, length))).astype(np.float32)


def test_reflect_pad_matches_jax():
    from ddsp_tpu.ops.spectral import reflect_pad as jax_reflect_pad

    x = _audio(3, 50, seed=0)
    np.testing.assert_array_equal(
        reflect_pad(torch.from_numpy(x), 16).numpy(), np.asarray(jax_reflect_pad(x, 16))
    )


@pytest.mark.parametrize("n_fft", FFTS)
def test_spectrogram_matches_jax(n_fft):
    from ddsp_tpu.ops.spectral import spectrogram as jax_spectrogram

    hop = n_fft // 4
    x = _audio(2, 4096, seed=n_fft)
    want = np.asarray(jax_spectrogram(x, n_fft, hop, matmul_dtype=None))
    got = spectrogram(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 4096 // hop + 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_mss_loss_plain_and_cached_match_jax():
    from ddsp_tpu import losses as jax_losses

    pred, true = _audio(2, 4096, seed=1), _audio(2, 4096, seed=2)
    want = jax_losses.mss_loss_per_scale(pred, true, FFTS, 1.0, 0.75, matmul_dtype=None)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(true)
    got = losses.mss_loss_per_scale(tp, tt, FFTS, 1.0, 0.75)
    cached = losses.mss_loss_per_scale_cached(
        tp, losses.target_spectrograms(tt, FFTS, 0.75), FFTS, 1.0, 0.75
    )
    assert sorted(got) == sorted(want) == sorted(cached)
    for key, value in want.items():
        assert float(got[key]) == pytest.approx(float(value), rel=1e-4), key
        assert float(cached[key]) == pytest.approx(float(value), rel=1e-4), key
    total = jax_losses.mss_loss(pred, true, FFTS, matmul_dtype=None)
    assert float(losses.mss_loss(tp, tt, FFTS)) == pytest.approx(float(total), rel=1e-4)


def test_mss_loss_gradient_matches_jax():
    import jax

    from ddsp_tpu import losses as jax_losses

    ffts = (256, 64)
    pred, true = _audio(2, 1024, seed=3), _audio(2, 1024, seed=4)
    want = jax.grad(
        lambda p: sum(jax_losses.mss_loss_per_scale(p, true, ffts, matmul_dtype=None).values())
    )(pred)
    tp = torch.from_numpy(pred).requires_grad_(True)
    loss = sum(losses.mss_loss_per_scale(tp, torch.from_numpy(true), ffts).values())
    (got,) = torch.autograd.grad(loss, [tp])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("length,kernel_len", [(1000, 300), (257, 700)])
def test_rfft_convolve_same_matches_jax(length, kernel_len):
    import jax

    from ddsp_tpu.ops.fft import rfft_convolve_same as jax_conv

    signal, kernel = _audio(3, length, seed=5), _audio(1, kernel_len, seed=6)
    want = np.asarray(jax_conv(signal, kernel, kernel_len))
    ts = torch.from_numpy(signal).requires_grad_(True)
    tk = torch.from_numpy(kernel).requires_grad_(True)
    got = rfft_convolve_same(ts, tk, kernel_len)
    assert got.shape == (3, length)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * np.abs(want).max())

    g = _audio(3, length, seed=7)
    _, vjp = jax.vjp(lambda s, k: jax_conv(s, k, kernel_len), signal, kernel)
    for a, b in zip(vjp(g), torch.autograd.grad(got, [ts, tk], torch.from_numpy(g))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-4)


def test_reverb_apply_matches_jax():
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models import synths as jax_synths

    jconf = JaxConfig(sample_rate=4000, reverb_length=700, reverb_grad_matmul_dtype="float32")
    params = jax_synths.reverb_init(jax.random.PRNGKey(0), jconf, initial_wet=0.5)
    x = _audio(2, 2000, seed=8)
    g = _audio(2, 2000, seed=9)
    want, vjp = jax.vjp(lambda p, a: jax_synths.reverb_apply(p, a, jconf), params, x)
    want_grads = vjp(g)

    reverb = Reverb(CONF)
    with torch.no_grad():
        for name in ("noise", "decay", "wet"):
            getattr(reverb, name).copy_(torch.tensor(np.asarray(params[name])))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = reverb_apply(reverb, tx, CONF)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * np.abs(want).max())
    grads = torch.autograd.grad(got, [reverb.noise, reverb.decay, reverb.wet, tx],
                                torch.from_numpy(g))
    wants = [want_grads[0][k] for k in ("noise", "decay", "wet")] + [want_grads[1]]
    for name, a, b in zip(("noise", "decay", "wet", "x"), wants, grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
