"""The permuted-CT layer of the port and S1's plain version against
ddsp_tpu, same numpy inputs, on CPU; S1's CUDA kernel against its plain
version on the card.

* ``_split_factors``, ``_dft_mats`` and ``_twiddle``: equal to the JAX
  package's, bit for bit, as float32 and after the bf16 cast.
* ``ct_conv_plain`` (``ops/cuda/ct_conv.py``) against S1 itself,
  ``ct_conv_pallas`` of ``scripts/ab_ct_conv_kernel.py`` run by the Pallas
  interpreter, and against that script's XLA pipeline ``ct_conv_xla``:
  >= 80 dB at n = 6144 (measured 99.6 dB) and >= 70 dB at n = 98,304
  (74.5 dB).  All three round the same values to bf16 at the same points;
  float32 sums in another order flip a few of those roundings by one bf16
  ulp, more often over the longer sums of the larger size.
* Against a float64 FFT convolution: >= 44 dB (47.4-47.5 dB measured; one
  bf16 pass).
* The kernel (test marked ``cuda``): >= 70 dB against the plain version on
  the same card, >= 44 dB against float64 on two rows, reruns bit-equal,
  one launch a call.

jax is imported inside the tests that compare with it, so the test marked
``cuda`` also runs on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_ct_conv.py``.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import importlib.util
import os

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import fft
from ddsp_tpu_torch.ops.cuda import ct_conv as s1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snr(ref, est) -> float:
    ref = np.asarray(ref, np.complex128)
    noise = np.mean(np.abs(ref - np.asarray(est, np.complex128)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(np.abs(ref) ** 2) / noise))


def _operands(rows: int, n: int, seed: int = 0):
    """Complex rows and the permuted spectrum of a full-length random
    kernel x 0.1, as the TPU script makes them (``:133-144``), formed in
    float64 and cast: P[k1, k2] = X[k1 + n1 k2]."""
    rng = np.random.default_rng(seed)
    zr = rng.standard_normal((rows, n)).astype(np.float32)
    zi = rng.standard_normal((rows, n)).astype(np.float32)
    k = (0.1 * rng.standard_normal(n)).astype(np.float32)
    n1, n2 = fft._split_factors(n)
    spec = np.fft.fft(k.astype(np.float64)).reshape(n2, n1).T
    kr = np.ascontiguousarray(spec.real, np.float32).reshape(1, n)
    ki = np.ascontiguousarray(spec.imag, np.float32).reshape(1, n)
    return zr, zi, k, kr, ki


def _oracle(zr, zi, k):
    """Float64 circular convolution of the complex rows with k."""
    z = zr.astype(np.float64) + 1j * zi
    return np.fft.ifft(np.fft.fft(z) * np.fft.fft(k.astype(np.float64)))


@pytest.mark.parametrize("n", [6144, 98304])
def test_tables_equal_jax(n):
    import jax.numpy as jnp

    from ddsp_tpu.ops import fft as jax_fft

    n1, n2 = fft._split_factors(n)
    assert (n1, n2) == jax_fft._split_factors(n)
    for ours, theirs in ((fft._dft_mats(n1), jax_fft._dft_mats(n1)),
                         (fft._dft_mats(n2), jax_fft._dft_mats(n2)),
                         (fft._twiddle(n1, n2), jax_fft._twiddle(n1, n2))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    tables = fft.ct_tables(n, torch.device("cpu"), torch.bfloat16)
    for got, want in zip(tables[:4], (*jax_fft._dft_mats(n1), *jax_fft._dft_mats(n2))):
        want_bf16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want_bf16)
    for got, want in zip(tables[4:], jax_fft._twiddle(n1, n2)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,floor_db", [(6144, 80.0), (98304, 70.0)])
def test_plain_matches_s1_and_xla_pipeline(n, floor_db):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "ab_ct_conv_kernel", os.path.join(ROOT, "scripts", "ab_ct_conv_kernel.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    zr, zi, k, kr, ki = _operands(2, n)
    yr, yi = s1.ct_conv(*(torch.from_numpy(a) for a in (zr, zi, kr, ki)), n)
    got = yr.numpy() + 1j * yi.numpy()
    args = [jnp.asarray(a) for a in (zr, zi, kr, ki)]
    with pltpu.force_tpu_interpret_mode():
        pr, pi = script.ct_conv_pallas(*args, n)
    xr, xi = script.ct_conv_xla(*args, n)
    assert _snr(np.asarray(pr) + 1j * np.asarray(pi), got) >= floor_db
    assert _snr(np.asarray(xr) + 1j * np.asarray(xi), got) >= floor_db
    assert _snr(_oracle(zr, zi, k), got) >= 44.0


def test_shared_path_is_s1_on_packed_rows():
    """``rfft_convolve_same`` at bf16 on an odd batch (a zero row padded)
    equals S1's plain version on the packed rows, and holds >= 44 dB
    against a float64 causal convolution."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 3000)).astype(np.float32)
    h = (0.1 * rng.standard_normal((1, 1200))).astype(np.float32)
    got = fft.rfft_convolve_same(torch.from_numpy(x), torch.from_numpy(h), 1200,
                                 matmul_dtype=torch.bfloat16).numpy()
    n = 6144
    pad = np.zeros((4, n), np.float32)
    pad[:3, :3000] = x
    k = np.zeros(n, np.float32)
    k[:1200] = h[0]
    n1, n2 = fft._split_factors(n)
    spec = np.fft.fft(k.astype(np.float64)).reshape(n2, n1).T.reshape(1, n)
    # the shared path's spectrum is itself a bf16 transform of the kernel
    kr, ki = fft._ct_fwd_permuted(torch.from_numpy(k[None]), torch.zeros(1, n), n,
                                  torch.bfloat16)
    assert _snr(spec, (kr + 1j * ki).numpy().reshape(1, n)) >= 44.0
    yr, yi = s1.ct_conv_plain(torch.from_numpy(pad[0::2].copy()),
                              torch.from_numpy(pad[1::2].copy()), kr, ki, n)
    want = torch.stack([yr, yi], 1).reshape(4, n)[:3, :3000].numpy()
    np.testing.assert_array_equal(got, want)
    oracle = np.stack([np.convolve(r.astype(np.float64), h[0])[:3000] for r in x])
    assert _snr(oracle, got) >= 44.0


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(16, 98304), (3, 6144), (2, 12288)])
def test_kernel_matches_plain_version_on_card(cuda_device, rows, n):
    zr, zi, k, kr, ki = _operands(rows, n, seed=rows)
    args = [torch.from_numpy(a).to(cuda_device) for a in (zr, zi, kr, ki)]
    before = s1.LAUNCHES
    yr, yi = s1.ct_conv(*args, n)
    again = s1.ct_conv(*args, n)
    torch.cuda.synchronize()
    assert s1.LAUNCHES == before + 2
    assert torch.equal(yr, again[0]) and torch.equal(yi, again[1])
    pr, pi = s1.ct_conv_plain(*args, n)
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    assert np.isfinite(got).all()
    assert _snr(pr.cpu().numpy() + 1j * pi.cpu().numpy(), got) >= 70.0
    assert _snr(_oracle(zr[:2], zi[:2], k), got[:2]) >= 44.0
    with pytest.raises(ValueError, match="contiguous"):
        s1.ct_conv(args[0].t().contiguous().t(), *args[1:], n)
