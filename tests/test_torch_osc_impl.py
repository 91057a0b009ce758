"""``Config.osc_impl`` in the port: the sine fill it resolves, held against
the JAX package's dispatch on the same numpy inputs, on CPU.

* ``models/synths.osc_fill``: 'pallas', and 'auto' on the card, take the
  TPU kernels' rotation fill; 'xla', and 'auto' on the CPU, the exact
  fill, as ``ddsp_tpu/models/synths.py:28-42`` chooses Pallas or XLA.
* ``oscillator_apply`` with ``osc_impl='pallas'`` on the CPU against JAX's
  ``oscillator_apply`` run as ``tests/test_pallas_oscillator.py`` runs it
  (``force_tpu_interpret_mode``: K1 and K2 on the rotation fill), B=2,
  T=8, hop 64, H=40: the audio > 120 dB SNR (measured 140.6 dB) and closer
  to JAX's than the exact fill is (132.8 dB: the fills differ by about an
  ulp a rotation);
  the gradients of the controls at the JAX suite's rtol 1e-3, atol 1e-4.
  'xla' and 'auto' on the CPU render with the exact fill, bit-equal to
  each other.
* K5's plain version on the rotation fill (``render_hop_slots_plain(...,
  fill='rot')``) against ``_kernel_banked`` in interpret mode over frame
  rows with ``h_start`` (``_pallas_forward(impl='banked', h_start)``):
  > 120 dB (measured 138.3 and 139.4 dB at h_start 0 and 8).
* The K5 kernel on the rotation fill against its plain version on the
  card (marked ``cuda``): > 90 dB, the other fills' floor.

jax is imported inside the tests that compare with it, so the test marked
``cuda`` also runs on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_osc_impl.py``.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models import synths
from ddsp_tpu_torch.ops.cuda import oscillator as osc_slots
from ddsp_tpu_torch.ops.cuda import osc_variants
from ddsp_tpu_torch.ops.interp import hop_weights

B, T, HOP, H, SR = 2, 8, 64, 40, 16000


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = np.mean((want - np.asarray(got, np.float64)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(want**2) / noise))


def _controls(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f0": rng.uniform(80.0, 600.0, (B, T, 1)).astype(np.float32),
        "c": rng.uniform(0.01, 1.0, (B, T, H)).astype(np.float32),
        "a": rng.uniform(0.0, 1.0, (B, T, 1)).astype(np.float32),
    }


@pytest.mark.parametrize("impl,device,fill", [
    ("auto", "cuda", "rot"), ("auto", "cpu", "exact"),
    ("pallas", "cuda", "rot"), ("pallas", "cpu", "rot"),
    ("xla", "cuda", "exact"), ("xla", "cpu", "exact"),
])
def test_osc_fill_resolves_as_the_jax_dispatch(impl, device, fill):
    assert synths.osc_fill(impl, device) == fill
    assert synths.osc_fill(impl, torch.device(device)) == fill


def test_osc_fill_refuses_unknown_impl():
    with pytest.raises(ValueError, match="osc_impl"):
        synths.osc_fill("triton", "cuda")


@pytest.fixture
def interpret():
    """Run Pallas kernels through the interpreter, as the JAX suite does."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _port_apply(controls, impl, with_grad=False):
    conf = Config(sample_rate=SR, hop_length=HOP, n_harmonics=H, osc_impl=impl)
    leaves = {k: torch.from_numpy(v).requires_grad_(with_grad) for k, v in controls.items()}
    audio, phase = synths.oscillator_apply(leaves, conf)
    if not with_grad:
        return audio.detach().numpy(), phase.detach().numpy()
    grads = torch.autograd.grad((audio * audio).sum(), [leaves[k] for k in ("f0", "c", "a")])
    return audio.detach().numpy(), [g.numpy() for g in grads]


def test_pallas_impl_matches_jax_interpreted_kernels(interpret):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models.synths import oscillator_apply as jax_apply

    controls = _controls(seed=3)
    jconf = JaxConfig(sample_rate=SR, hop_length=HOP, n_harmonics=H, osc_impl="pallas")

    def loss(f0, c, a):
        audio, _ = jax_apply({"f0": f0, "c": c, "a": a}, jconf)
        return (audio * audio).sum(), audio

    j = [jnp.asarray(controls[k]) for k in ("f0", "c", "a")]
    (_, want), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*j)
    want = np.asarray(want)
    got, got_grads = _port_apply(controls, "pallas", with_grad=True)
    exact, _ = _port_apply(controls, "xla")
    assert got.shape == (B, T * HOP)
    snr_rot, snr_exact = _snr(want, got), _snr(want, exact)
    assert snr_rot > 120.0
    assert snr_rot > snr_exact, (snr_rot, snr_exact)
    for name, a, c in zip(("f0", "c", "a"), want_grads, got_grads):
        assert c.shape == a.shape, name
        np.testing.assert_allclose(c, np.asarray(a), rtol=1e-3, atol=1e-4,
                                   err_msg=f"d/d{name} vs JAX's Pallas VJP")


def test_auto_and_xla_take_the_exact_fill_on_cpu():
    controls = _controls(seed=4)
    auto, auto_phase = _port_apply(controls, "auto")
    xla, xla_phase = _port_apply(controls, "xla")
    rot, _ = _port_apply(controls, "pallas")
    np.testing.assert_array_equal(auto, xla)
    np.testing.assert_array_equal(auto_phase, xla_phase)
    assert not np.array_equal(auto, rot)


def _frame_rows(seed, h_start, hop=HOP, h=H):
    """Frame-row operands of ``_pallas_forward(impl='banked')``: phase
    (B, T, hop) in cycles, renormalised amps_pad (B, T+2, H), loud_pad."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 1.0, (B, T, hop)).astype(np.float32)
    amps = rng.uniform(0.0, 1.0, (B, T + 2, h))
    amps = (amps / amps.sum(-1, keepdims=True)).astype(np.float32)
    loud = rng.uniform(0.0, 1.0, (B, T + 2)).astype(np.float32)
    return phase, amps, loud


@pytest.mark.parametrize("h_start", [0, 8])
def test_k5_rot_plain_matches_interpreted_kernel_banked(interpret, h_start):
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.oscillator import _pallas_forward

    phase, amps, loud = _frame_rows(seed=5 + h_start, h_start=h_start)
    want = np.asarray(_pallas_forward(
        jnp.asarray(phase), jnp.asarray(amps), jnp.asarray(loud), None,
        impl="banked", h_start=h_start))
    t = torch.from_numpy
    got = osc_variants.render_rows(t(phase), t(amps), t(loud), h_start, plain=True)
    assert got.shape == (B, T * HOP)
    assert _snr(want, got.numpy()) > 120.0
    rows = lambda x: t(np.ascontiguousarray(x.reshape(B * T, -1)))  # noqa: E731
    loud3 = np.stack([loud[:, :-2], loud[:, 1:-1], loud[:, 2:]], -1)
    args = (rows(phase), rows(amps[:, :-2]), rows(amps[:, 1:-1]), rows(amps[:, 2:]),
            rows(loud3), torch.as_tensor(hop_weights(HOP)), h_start)
    direct = osc_slots.render_hop_slots_plain(*args, fill="rot")
    np.testing.assert_array_equal(direct.reshape(B, T * HOP).numpy(), got.numpy())
    assert osc_slots.osc_hop_slots(*args, fill="rot").equal(direct)
    with pytest.raises(ValueError, match="fills"):
        osc_slots.osc_hop_slots(*args, fill="cheb8")


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop,h,h_start", [(256, 512, 180, 0), (13, 128, 40, 8)])
def test_k5_rot_kernel_matches_plain_version_on_card(cuda_device, n, hop, h, h_start):
    rng = np.random.default_rng(n)
    amps = rng.uniform(0.0, 1.0, (3, n, h))
    amps /= amps.sum(-1, keepdims=True)
    arrays = [rng.uniform(0.0, 1.0, (n, hop)), *amps, rng.uniform(0.0, 1.0, (n, 3)),
              hop_weights(hop)]
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in arrays]
    key = osc_slots.variant_name("rot")
    before = osc_slots.VARIANT_LAUNCHES[key]
    got = osc_slots.osc_hop_slots(*args, h_start, fill="rot")
    torch.cuda.synchronize()
    assert osc_slots.VARIANT_LAUNCHES[key] == before + 1
    want = osc_slots.render_hop_slots_plain(*args, h_start, fill="rot")
    assert np.isfinite(got.cpu().numpy()).all()
    assert _snr(want.cpu().numpy(), got.cpu().numpy()) > 90.0
