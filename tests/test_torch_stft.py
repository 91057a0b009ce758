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

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
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


def _frames_bf16(xb: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """(B, n_frames, n_fft) float32 frames of the bf16-rounded hop blocks:
    the kernels' A operand, frame t at t*hop of the flat row."""
    flat = xb.to(torch.bfloat16).float().reshape(xb.shape[0], -1)
    return flat.unfold(1, n_fft, hop)[:, :n_frames]


def _spectrum_groups(xb, n_fft, hop, n_frames):
    """The forward GEMM on the cached K-major layout, as the kernels run it
    (one sum over all of n_fft): (re, im), each (B, n_frames, bins_pad)."""
    wt = stft_cuda.wt_layout(n_fft, "cpu")[:, :n_fft].float()
    s = _frames_bf16(xb, n_fft, hop, n_frames) @ wt.T
    groups = s.reshape(*s.shape[:2], -1, 2, stft_cuda.GROUP)
    return groups[..., 0, :].flatten(2), groups[..., 1, :].flatten(2)


def _recompute_d(xb, dmag, n_fft, hop, n_frames) -> torch.Tensor:
    """Launch (a) emulated: D (B, n_frames, 2 bins_pad) bf16, dre | dim of
    each group of 64 bins with the TPU kernel's two casts."""
    re, im = _spectrum_groups(xb, n_fft, hop, n_frames)
    bins, bp = n_fft // 2 + 1, stft_cuda.bins_pad(n_fft)
    dm = torch.nn.functional.pad(dmag, (0, bp - bins)).to(torch.bfloat16).float()
    dre, dim = ((2.0 * v * dm).to(torch.bfloat16) for v in (re, im))
    g = stft_cuda.GROUP
    return torch.stack([dre.unflatten(2, (-1, g)), dim.unflatten(2, (-1, g))], 3).flatten(2)


def _shifted_sum(d, n_fft, hop, n_blocks) -> torch.Tensor:
    """Launch (b) emulated: dxb[r, j] = sum_i D[r - i] . Wcat[i*hop + j]."""
    wcat = stft_cuda.wcat_layout(n_fft, "cpu").float()
    n_frames = d.shape[1]
    dxb = torch.zeros(d.shape[0], n_blocks, hop)
    for i in range(n_fft // hop):
        dxb[:, i : i + n_frames] += d.float() @ wcat[i * hop : (i + 1) * hop].T
    return dxb


LAYOUT_CASES = [(64, 16), (256, 64), (2048, 512), (60, 12)]


@pytest.mark.parametrize("n_fft,hop", LAYOUT_CASES)
def test_cached_layouts_regroup_the_bf16_matrices(n_fft, hop):
    """Wt: group g's 64 Wc^T rows, then its Ws^T rows, bins padded with
    zeros to 64; Wcat its (n_fft, 2 bins_pad) transpose.  Every entry is a
    dft_mats entry or an exact zero."""
    wc, ws = stft_cuda.dft_mats(n_fft, "cpu")
    wt, wcat = stft_cuda.wt_layout(n_fft, "cpu"), stft_cuda.wcat_layout(n_fft, "cpu")
    bins, bp, g = n_fft // 2 + 1, stft_cuda.bins_pad(n_fft), stft_cuda.GROUP
    assert bp % g == 0 and bins <= bp < bins + g
    assert wt.shape == (2 * bp, -(-n_fft // 8) * 8) and wt.dtype == torch.bfloat16
    assert torch.equal(wcat, wt[:, :n_fft].T) and wcat.is_contiguous()
    groups = wt.reshape(bp // g, 2, g, -1)
    for part, w in enumerate((wc, ws)):
        got = groups[:, part].reshape(bp, -1)
        assert torch.equal(got[:bins, :n_fft], w.T)
        assert not got[bins:].any() and not got[:, n_fft:].any()


@pytest.mark.parametrize("n_fft,hop", LAYOUT_CASES)
def test_forward_on_cached_layout_matches_plain_version(n_fft, hop):
    """The forward GEMM on Wt (re | im groups, one sum over n_fft) against
    stft_power_plain: the same bf16 products, float32 sums in another
    order, so within 1e-6 of the peak; padded bins exactly zero."""
    xb, n_frames = spectral.hop_blocks(torch.from_numpy(_audio((2, 8192), seed=n_fft)), n_fft, hop)
    re, im = _spectrum_groups(xb, n_fft, hop, n_frames)
    bins = n_fft // 2 + 1
    assert not re[..., bins:].any() and not im[..., bins:].any()
    got = (re * re + im * im)[..., :bins]
    want = stft_cuda.stft_power_plain(xb, n_fft, hop, n_frames)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("n_fft,hop", LAYOUT_CASES)
def test_two_stage_backward_on_cached_layouts_matches_plain_version(n_fft, hop):
    """Launch (a) (D in bf16) then launch (b) (the sum over shifts on
    Wcat), emulated on the padded layouts, against stft_power_bwd_plain at
    the backward's bf16 criterion (the re/im sums run in another order, so
    a cast may round the other way); D is exactly zero at padded bins."""
    xb, n_frames = spectral.hop_blocks(torch.from_numpy(_audio((3, 5000), seed=n_fft)), n_fft, hop)
    bins = n_fft // 2 + 1
    dmag = torch.from_numpy(_audio((3, n_frames, bins), seed=n_fft + 9))
    d = _recompute_d(xb, dmag, n_fft, hop, n_frames)
    assert d.shape == (3, n_frames, 2 * stft_cuda.bins_pad(n_fft)) and d.dtype == torch.bfloat16
    groups = d.reshape(3, n_frames, -1, 2, stft_cuda.GROUP)
    for part in (0, 1):
        assert not groups[..., part, :].flatten(2)[..., bins:].any()
    got = _shifted_sum(d, n_fft, hop, xb.shape[1])
    want = stft_cuda.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames)
    assert (got - want).abs().max() <= 5e-3 * want.abs().max()
    assert float((got * want).sum() / (got.norm() * want.norm())) > 0.9999


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
@pytest.mark.parametrize("b,length,n_fft,hop", [
    pytest.param(3, 5000, 256, 64, id="3-5000-256"),
    pytest.param(3, 5000, 64, 16, id="3-5000-64"),
    pytest.param(2, 88064, 2048, 512, id="2-88064-2048"),
    pytest.param(3, 5000, 256, 32, id="3-5000-256-hop32"),   # kb 8
    pytest.param(3, 5000, 64, 64, id="3-5000-64-hop64"),     # kb 1
    pytest.param(2, 20000, 4096, 1024, id="2-20000-4096"),   # DIRECT_MAX
    pytest.param(3, 5000, 60, 12, id="3-5000-60-hop12"),     # hop % 8 != 0
])
def test_kernel_pair_matches_plain_version_on_card(cuda_device, b, length, n_fft, hop):
    """StftPower on the card against the plain versions: forward > 90 dB
    SNR, the backward within the bf16 criterion above, two backward runs
    bit-equal; one forward launch, one backward call (a recompute and a
    shifted-product launch) each."""
    xb, n_frames = spectral.hop_blocks(torch.from_numpy(_audio((b, length), seed=b)), n_fft, hop)
    xb = xb.contiguous().to(cuda_device)
    dmag = torch.from_numpy(_audio((b, n_frames, n_fft // 2 + 1), seed=7)).to(cuda_device)
    counters = ("FWD_LAUNCHES", "BWD_LAUNCHES", "BWD_RECOMPUTE_LAUNCHES")
    before = [getattr(stft_cuda, c) for c in counters]
    leaf = xb.clone().requires_grad_(True)
    got = stft_cuda.StftPower.apply(leaf, n_fft, hop, n_frames)
    (grad,) = torch.autograd.grad(got, [leaf], dmag)
    again = stft_cuda.stft_power_bwd(xb, dmag, n_fft, hop, n_frames)
    torch.cuda.synchronize()
    assert [getattr(stft_cuda, c) - n for c, n in zip(counters, before)] == [1, 2, 2]
    want = stft_cuda.stft_power_plain(xb, n_fft, hop, n_frames).double()
    noise = (want - got.detach().double()).pow(2).mean()
    assert 10 * torch.log10(want.pow(2).mean() / noise) > 90.0
    want_grad = stft_cuda.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames)
    assert grad.dtype == torch.float32 and grad.shape == xb.shape
    assert (grad - want_grad).abs().max() <= 5e-3 * want_grad.abs().max()
    assert float((grad * want_grad).sum() / (grad.norm() * want_grad.norm())) > 0.9999
    assert torch.equal(grad, again)
