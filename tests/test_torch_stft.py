"""The loss spectrogram's kernel route (the counterparts of K3 and K4)
against ddsp_tpu's, same numpy inputs, on CPU.

On the CPU, ``set_stft_impl('pallas')`` with ``matmul_dtype=torch.bfloat16``
sends the spectrogram through ``StftPower`` with the kernels' plain
versions; it is held against the JAX package's XLA hop-blocked bf16 path
and against its Pallas kernels K3 / K4 run by the Pallas interpreter, as
tests/test_pallas_stft.py runs them.  The interpreter is used only at
shapes whose frame tile ``_pick_tiles`` makes a multiple of 8
(ROADMAP.md §3: other tiles read the wrong rows); the rest are held
against XLA only.

Floors, as the JAX suite sets them (tests/test_pallas_stft.py:21-58):
forward within 1e-6 of the spectrogram's peak (the same bf16 products,
float32 sums in another order); gradients within 5e-3 of the largest and
cosine > 0.9999 (the backward's bf16 casts of dmag and of 2 re dmag).

jax is imported inside the tests that compare with it, so the test marked
``cuda`` also runs on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_stft.py``.
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import spectral
from ddsp_tpu_torch.ops.cuda import stft as stft_cuda
from ddsp_tpu_torch.ops.spectral import set_stft_impl, spectrogram


@pytest.fixture
def pallas_route():
    set_stft_impl("pallas")
    yield
    set_stft_impl("auto")


def _audio(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n_fft", [64, 256, 2048])
def test_kernel_route_matches_jax_xla_bf16(pallas_route, n_fft):
    import jax.numpy as jnp

    from ddsp_tpu.ops.spectral import spectrogram as jax_spectrogram

    hop = n_fft // 4
    x = _audio((2, 8192), seed=n_fft)
    want = np.asarray(jax_spectrogram(jnp.asarray(x), n_fft, hop, matmul_dtype=jnp.bfloat16))
    got = spectrogram(torch.from_numpy(x), n_fft, hop, matmul_dtype=torch.bfloat16).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 8192 // hop + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_fft", [64, 256])
def test_kernel_route_matches_jax_pallas_interpret(pallas_route, n_fft):
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.stft import spectrogram_power_pallas

    hop = n_fft // 4
    x = _audio((2, 8192), seed=n_fft + 1)
    want = np.asarray(spectrogram_power_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    got = spectrogram(torch.from_numpy(x), n_fft, hop, matmul_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_fft", [64, 256])
def test_kernel_route_gradient_matches_both_jax_routes(pallas_route, n_fft):
    """Autograd through StftPower (the plain backward with K4's casts)
    against jax.grad of the XLA bf16 path and of the Pallas custom_vjp."""
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.stft import spectrogram_power_pallas
    from ddsp_tpu.ops.spectral import spectrogram as jax_spectrogram

    hop = n_fft // 4
    x = _audio((2, 8192), seed=n_fft + 2)
    target = np.array(jax_spectrogram(jnp.asarray(x), n_fft, hop, matmul_dtype=jnp.bfloat16))
    y = x + 0.01
    routes = {
        "xla": lambda p: jax_spectrogram(p, n_fft, hop, matmul_dtype=jnp.bfloat16),
        "pallas": lambda p: spectrogram_power_pallas(p, n_fft, hop, interpret=True),
    }
    ty = torch.from_numpy(y).requires_grad_(True)
    spec = spectrogram(ty, n_fft, hop, matmul_dtype=torch.bfloat16)
    (got,) = torch.autograd.grad((spec - torch.from_numpy(target)).abs().mean(), [ty])
    got = got.numpy()
    for name, route in routes.items():
        want = np.asarray(jax.grad(lambda p: jnp.mean(jnp.abs(route(p) - target)))(jnp.asarray(y)))
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max(), name
        cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos > 0.9999, (name, cos)


@pytest.mark.parametrize("impl,dtype,n_fft,hop", [
    ("auto", torch.bfloat16, 256, 64),    # 'auto' is the float32 torch.stft
    ("xla", torch.bfloat16, 256, 64),
    ("pallas", None, 256, 64),            # no bf16: the kernels' precondition
    ("pallas", torch.bfloat16, 256, 96),  # hop does not divide n_fft
])
def test_switch_keeps_torch_stft_off_the_kernel_route(impl, dtype, n_fft, hop):
    x = torch.from_numpy(_audio((2, 3000), seed=5))
    want = spectrogram(x, n_fft, hop)  # the 'auto' default: float32 torch.stft
    set_stft_impl(impl)
    try:
        got = spectrogram(x, n_fft, hop, matmul_dtype=dtype)
    finally:
        set_stft_impl("auto")
    assert torch.equal(got, want)


def test_switch_takes_the_kernel_route_and_rejects_unknown_names(pallas_route):
    x = torch.from_numpy(_audio((2, 3000), seed=6))
    got = spectrogram(x, 256, 64, matmul_dtype=torch.bfloat16)
    assert torch.equal(got, spectral.spectrogram_power_blocked(x, 256, 64))
    assert not torch.equal(got, spectrogram(x, 256, 64))  # bf16 inputs differ
    with pytest.raises(ValueError, match="unknown STFT impl"):
        set_stft_impl("cufft")


def test_dft_mats_are_the_jax_packages_bf16_blocks():
    """float64 -> float32 -> bf16, entry for entry as ddsp_tpu's."""
    import jax.numpy as jnp

    from ddsp_tpu.ops.spectral import _hann_rdft_blocks

    wc, ws = stft_cuda.dft_mats(512, "cpu")
    cos_b, sin_b = _hann_rdft_blocks(512, 128)
    for got, blocks in ((wc, cos_b), (ws, sin_b)):
        want = np.asarray(jnp.asarray(np.concatenate(blocks)).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_kernel_wrappers_check_their_inputs():
    xb = torch.zeros(2, 10, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        stft_cuda.stft_power_fwd(xb, 64, 16, 7)
    with pytest.raises(ValueError, match="hop"):
        stft_cuda.stft_power_fwd(xb, 72, 16, 7)
    with pytest.raises(ValueError, match="exceed"):
        stft_cuda.stft_power_fwd(xb, 64, 16, 8)
    with pytest.raises(ValueError, match="dmag must be"):
        stft_cuda.stft_power_bwd(xb, torch.zeros(2, 7, 32), 64, 16, 7)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,n_fft", [(3, 5000, 256), (3, 5000, 64), (2, 88064, 2048)])
def test_kernel_pair_matches_plain_version_on_card(cuda_device, b, length, n_fft):
    """StftPower on the card against the plain versions: forward > 90 dB
    SNR, the backward within the bf16 criterion above, two backward runs
    bit-equal, one launch each."""
    hop = n_fft // 4
    xb, n_frames = spectral.hop_blocks(torch.from_numpy(_audio((b, length), seed=b)), n_fft, hop)
    xb = xb.contiguous().to(cuda_device)
    dmag = torch.from_numpy(_audio((b, n_frames, n_fft // 2 + 1), seed=7)).to(cuda_device)
    before = (stft_cuda.FWD_LAUNCHES, stft_cuda.BWD_LAUNCHES)
    leaf = xb.clone().requires_grad_(True)
    got = stft_cuda.StftPower.apply(leaf, n_fft, hop, n_frames)
    (grad,) = torch.autograd.grad(got, [leaf], dmag)
    again = stft_cuda.stft_power_bwd(xb, dmag, n_fft, hop, n_frames)
    torch.cuda.synchronize()
    assert (stft_cuda.FWD_LAUNCHES, stft_cuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    want = stft_cuda.stft_power_plain(xb, n_fft, hop, n_frames).double()
    noise = (want - got.detach().double()).pow(2).mean()
    assert 10 * torch.log10(want.pow(2).mean() / noise) > 90.0
    want_grad = stft_cuda.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames)
    assert (grad - want_grad).abs().max() <= 5e-3 * want_grad.abs().max()
    assert float((grad * want_grad).sum() / (grad.norm() * want_grad.norm())) > 0.9999
    assert torch.equal(grad, again)
