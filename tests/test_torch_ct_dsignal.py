"""The reverb's fused bf16 d/dsignal and its saved-spectrum d/dkernel, on CPU.

* ``ops/cuda/ct_conv.ct_conv_dsignal``'s plain version gathers the packed
  overlap-save blocks of flip(g) and scatters S1's outputs back with index
  tensors; it equals today's unfused route, ``flip(rfft_convolve_same(
  flip(g), kernel, kernel_len, bfloat16))``, bit for bit: on an odd batch
  (a zero row packed), with one block a row (k = 1) and with two and three
  overlap-save chunks, with a kernel shorter than ``kernel_len``; and so
  does the d/dsignal of ``fft_convolve(grad_matmul_dtype='bfloat16')``,
  which takes it where the plan's rows take S1's cluster path
  (``on_chip``) and the unfused route elsewhere.
* ``overlap_save_plan`` follows ``rfft_convolve_same``'s dispatch: None
  where that stays on float32 ``torch.fft``; ``shared_kernel_spectrum``
  (the real kernel's bf16 permuted spectrum in half the products) equals
  ``_ct_fwd_permuted`` of it with a zero imaginary part.
* d/dkernel from the spectrum the forward kept equals the one recomputed
  from the signal, bit for bit, and the forward equals the float32 route.
* On the card (tests marked ``cuda``): the fused entry, one S1 launch, is
  held against its plain version at the reverb's training shape (16 rows
  of 88,064 samples, a 44,100-tap IR: two chunks of 98,304) and a small
  one, >= 70 dB (S1's floor against its plain version), bit-equal on
  rerun; S1 on rows too large for a cluster (2 x 262,144, (512, 512)),
  which take the three-launch path, >= 66 dB (its sums run 512 deep).

``python -m pytest --noconftest -m cuda tests/test_torch_ct_dsignal.py``
runs the tests marked ``cuda`` on a GPU machine without jax.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import fft
from ddsp_tpu_torch.ops.cuda import ct_conv as s1
from ddsp_tpu_torch.ops.fir import fft_convolve

# (B, L, kernel taps, kernel_len, chunks): n = 6144 for every block
CASES = [
    (3, 2000, 2100, 2100, 1),
    (2, 4500, 3700, 3700, 2),
    (3, 4500, 3700, 3700, 2),
    (3, 9500, 2800, 2800, 3),
    (3, 4500, 2500, 3700, 2),  # a kernel shorter than kernel_len
]


def _operands(b, length, taps, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((b, length)).astype(np.float32))
    h = torch.from_numpy((0.1 * rng.standard_normal((1, taps))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, length)).astype(np.float32))
    return g, h, x


def _unfused(g, h, kernel_len):
    return fft.rfft_convolve_same(g.flip(-1), h, kernel_len, torch.bfloat16).flip(-1)


@pytest.mark.parametrize("b,length,taps,kernel_len,chunks", CASES)
def test_fused_plain_dsignal_equals_unfused_route(b, length, taps, kernel_len, chunks):
    g, h, _ = _operands(b, length, taps, seed=b + chunks)
    plan = fft.overlap_save_plan(b, length, kernel_len)
    assert plan is not None and plan.chunks == chunks and plan.n == 6144
    assert plan.rows == (b * chunks + 1) // 2
    before = s1.LAUNCHES
    got = s1.ct_conv_dsignal(g, h, kernel_len)
    assert s1.LAUNCHES == before  # the CPU takes the plain version
    assert torch.equal(got, _unfused(g, h, kernel_len))


@pytest.mark.parametrize("b,length,taps,kernel_len,chunks", CASES[1:3])
def test_fft_convolve_bf16_dsignal_takes_fused_entry(b, length, taps, kernel_len, chunks):
    g, h, x = _operands(b, length, taps, seed=7)
    xs, hs = x.clone().requires_grad_(True), h.clone().requires_grad_(True)
    y = fft_convolve(xs, hs, kernel_len, grad_matmul_dtype="bfloat16")
    dx, dh = torch.autograd.grad(y, [xs, hs], g)
    assert torch.equal(dx, _unfused(g, h, kernel_len))
    # d/dkernel from the kept spectrum equals the one from the signal
    n = fft.next_fft_size(length + kernel_len - 1)
    spec = (torch.fft.rfft(g, n=n) * torch.fft.rfft(x, n=n).conj()).sum(0, keepdim=True)
    width = min(kernel_len, taps)
    want_dh = torch.nn.functional.pad(torch.fft.irfft(spec, n=n)[..., :width], (0, taps - width))
    assert torch.equal(dh, want_dh)
    assert torch.equal(y.detach(), fft.rfft_convolve_same(x, h, kernel_len))


def test_bf16_dsignal_takes_fused_entry_only_on_cluster_rows(monkeypatch):
    """The backward calls the fused entry when the plan's rows take S1's
    cluster path (``on_chip``), else the unfused route; both give the
    same values on the CPU."""
    b, length, taps, kernel_len, _ = CASES[1]
    g, h, x = _operands(b, length, taps, seed=11)
    calls = []
    fused = s1.ct_conv_dsignal
    monkeypatch.setattr(s1, "ct_conv_dsignal", lambda *a: calls.append(a[-1]) or fused(*a))

    def dsignal():
        xs = x.clone().requires_grad_(True)
        y = fft_convolve(xs, h, kernel_len, grad_matmul_dtype="bfloat16")
        return torch.autograd.grad(y, [xs], g)[0]

    assert torch.equal(dsignal(), _unfused(g, h, kernel_len))
    assert calls == [fft.overlap_save_plan(b, length, kernel_len)]
    monkeypatch.setattr(s1, "on_chip", lambda n1, n2: False)
    assert torch.equal(dsignal(), _unfused(g, h, kernel_len))
    assert len(calls) == 1


def test_per_row_kernel_dkernel_from_kept_spectrum():
    """A kernel per row (no batch sum) on the bf16 route: d/dkernel from the
    kept spectrum, d/dsignal on the unfused route (S1 takes shared kernels
    only)."""
    g, _, x = _operands(2, 3000, 1200, seed=3)
    h = torch.from_numpy(0.1 * np.random.default_rng(4).standard_normal((2, 1200)).astype(
        np.float32))
    xs, hs = x.clone().requires_grad_(True), h.clone().requires_grad_(True)
    y = fft_convolve(xs, hs, 1200, grad_matmul_dtype="bfloat16")
    dx, dh = torch.autograd.grad(y, [xs, hs], g)
    n = fft.next_fft_size(3000 + 1199)
    spec = torch.fft.rfft(g, n=n) * torch.fft.rfft(x, n=n).conj()
    assert torch.equal(dh, torch.fft.irfft(spec, n=n)[..., :1200])
    assert torch.equal(dx, _unfused(g, h, 1200))


def test_signal_only_gradient_keeps_no_spectrum():
    g, h, x = _operands(2, 4500, 3700, seed=5)
    xs = x.clone().requires_grad_(True)
    y = fft_convolve(xs, h, 3700, grad_matmul_dtype="bfloat16")
    (dx,) = torch.autograd.grad(y, [xs], g)
    assert torch.equal(dx, _unfused(g, h, 3700))


@pytest.mark.parametrize("n,kernel_len,taps", [(6144, 1200, 1200), (6144, 3700, 2500),
                                              (12288, 4000, 4000)])
def test_shared_kernel_spectrum_equals_the_complex_transform(n, kernel_len, taps):
    """The real-input spectrum equals ``_ct_fwd_permuted`` of the padded
    kernel with a zero imaginary part, value for value."""
    h = torch.from_numpy((0.1 * np.random.default_rng(n).standard_normal((1, taps))).astype(
        np.float32))
    k = torch.nn.functional.pad(h[..., :kernel_len], (0, n - min(taps, kernel_len)))
    for got, want in zip(fft.shared_kernel_spectrum(h, kernel_len, n, torch.bfloat16),
                         fft._ct_fwd_permuted(k, torch.zeros_like(k), n, torch.bfloat16)):
        assert torch.equal(got, want)


def test_plan_follows_the_dispatch():
    # n <= 4096: float32 torch.fft, no plan; chunks of <= 4096 points: none
    assert fft.overlap_save_plan(2, 2000, 500) is None
    plan = fft.overlap_save_plan(16, 88064, 44100)
    assert (plan.n, plan.chunks, plan.c, plan.lead, plan.rows) == (98304, 2, 44032, 44099, 16)
    with pytest.raises(ValueError, match="plan"):
        s1.ct_conv_dsignal(torch.zeros(2, 2000), torch.zeros(1, 500), 500)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _snr(ref, est) -> float:
    ref = np.asarray(ref, np.float64)
    noise = np.mean((ref - np.asarray(est, np.float64)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(ref**2) / noise))


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,taps", [(16, 88064, 44100), (3, 4500, 3700)])
def test_fused_kernel_matches_plain_dsignal_on_card(cuda_device, b, length, taps):
    g, h, _ = (t.to(cuda_device) for t in _operands(b, length, taps, seed=b))
    plan = fft.overlap_save_plan(b, length, taps)
    before, fused = s1.LAUNCHES, s1.DSIGNAL_LAUNCHES
    got = s1.ct_conv_dsignal(g, h, taps, plan)
    again = s1.ct_conv_dsignal(g, h, taps, plan)
    torch.cuda.synchronize()
    assert (s1.LAUNCHES, s1.DSIGNAL_LAUNCHES) == (before + 2, fused + 2)
    assert torch.equal(got, again)
    kr, ki = fft.shared_kernel_spectrum(h, taps, plan.n, torch.bfloat16)
    want = s1.ct_conv_dsignal_plain(g, kr.contiguous(), ki.contiguous(), plan)
    assert np.isfinite(got.cpu().numpy()).all()
    assert _snr(want.cpu().numpy(), got.cpu().numpy()) >= 70.0


@pytest.mark.cuda
def test_three_launch_path_matches_plain_version_on_card(cuda_device):
    """Rows too large for a cluster take the three-launch path, whose sums
    run 512 deep here: >= 66 dB against the plain version (69.71 dB
    measured on an H100 at these operands, under the 70 dB of the
    cluster path's 384-deep sums), >= 44 dB against float64."""
    from ddsp_tpu_torch.utils import ct_conv_ab

    rows, n = 2, 262144
    assert not s1.on_chip(*fft._split_factors(n))
    zr, zi, kr, ki, k = ct_conv_ab.operands(rows, n, cuda_device, seed=rows)
    before = s1.LAUNCHES
    yr, yi = s1.ct_conv(zr, zi, kr, ki, n)
    again = s1.ct_conv(zr, zi, kr, ki, n)
    torch.cuda.synchronize()
    assert s1.LAUNCHES == before + 2
    assert torch.equal(yr, again[0]) and torch.equal(yi, again[1])
    pr, pi = s1.ct_conv_plain(zr, zi, kr, ki, n)
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    want = pr.cpu().numpy() + 1j * pi.cpu().numpy()
    assert np.isfinite(got).all()
    assert ct_conv_ab.snr_db(want, got) >= 66.0
    z64 = zr.double().cpu().numpy() + 1j * zi.double().cpu().numpy()
    oracle = np.fft.ifft(np.fft.fft(z64) * np.fft.fft(k.astype(np.float64)))
    assert ct_conv_ab.snr_db(oracle, got) >= 44.0
