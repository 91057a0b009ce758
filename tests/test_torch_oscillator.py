"""ddsp_tpu_torch oscillator against ddsp_tpu's, same numpy inputs, on CPU.

Floors, as the JAX package's own oscillator tests set them
(tests/test_pallas_oscillator.py): the slot-hop render > 90 dB SNR against
both the XLA path and the Pallas slot-hop kernel (K5, run by the Pallas
interpreter); multi-frame renders > 80 dB; final phase within 1e-6 cycles
(float32 phase accumulation, ~2e-7 measured in the reference).

jax is imported inside the tests that compare with it, so the tests marked
``cuda`` also run on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_oscillator.py``.
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import oscillator as osc
from ddsp_tpu_torch.ops.cuda import oscillator as cuda_osc
from ddsp_tpu_torch.ops.interp import hop_weights


@pytest.fixture(scope="module")
def jax_osc():
    return pytest.importorskip("ddsp_tpu.ops.oscillator")


def _rows(n, h, sr, seed):
    """(N, 3, .) per-slot (prev, cur, next) controls."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(80.0, 600.0, (n, 3, 1)).astype(np.float32)
    amps = rng.uniform(0.01, 1.0, (n, 3, h)).astype(np.float32)
    loud = rng.uniform(0.0, 1.0, (n, 3, 1)).astype(np.float32)
    phase0 = rng.uniform(0.0, 1.0, (n,)).astype(np.float32)
    return f0, amps, loud, phase0


@pytest.mark.parametrize("n,hop,h", [(13, 128, 40), (4, 512, 180)])
def test_render_hop_rows_matches_xla_path(snr, jax_osc, n, hop, h):
    import jax.numpy as jnp

    sr = 44100
    f0, amps, loud, phase0 = _rows(n, h, sr, seed=n + hop)
    want, wphase = jax_osc.render_hop_rows(
        jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(loud),
        sample_rate=sr, hop=hop, initial_phase=jnp.asarray(phase0), impl="xla",
    )
    t = torch.from_numpy
    got, gphase = osc.render_hop_rows(
        t(f0), t(amps), t(loud), sample_rate=sr, hop=hop, initial_phase=t(phase0)
    )
    assert got.shape == (n, hop)
    assert snr(np.asarray(want), got.numpy()) > 90.0
    np.testing.assert_allclose(gphase.numpy(), np.asarray(wphase), atol=1e-6)


def test_render_hop_rows_matches_pallas_slot_kernel(snr, jax_osc):
    """Against K5 itself (pallas_render_hop_slots through the Pallas
    interpreter), fed the same normalised amps and phase."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddsp_tpu.ops.pallas.oscillator import pallas_render_hop_slots

    sr, n, hop, h = 16000, 13, 128, 40  # n not a multiple of the TPU tile
    f0, amps, loud, phase0 = _rows(n, h, sr, seed=9)
    amps_n = jax_osc.nyquist_normalized_amps(jnp.asarray(f0), jnp.asarray(amps), sr)
    phase1 = jax_osc._fundamental_phase_cycles(
        jnp.asarray(f0[..., 0]), hop, sr, jnp.asarray(phase0)
    )  # (N, 1, hop)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_render_hop_slots(
            jnp.moveaxis(phase1, 0, 1),
            amps_n[:, 0][None], amps_n[:, 1][None], amps_n[:, 2][None],
            jnp.asarray(loud[:, 0, 0])[None], jnp.asarray(loud[:, 1, 0])[None],
            jnp.asarray(loud[:, 2, 0])[None],
        )
    t = torch.from_numpy
    got, _ = osc.render_hop_rows(
        t(f0), t(amps), t(loud), sample_rate=sr, hop=hop, initial_phase=t(phase0)
    )
    assert snr(np.asarray(want).reshape(n, hop), got.numpy()) > 90.0


def test_render_padded_crosses_phase_block_carry(snr, jax_osc):
    """T=300 frames spans three 128-frame phase blocks (two Kahan carries)."""
    import jax.numpy as jnp

    sr, hop, b, t_frames, h = 16000, 64, 2, 300, 20
    rng = np.random.default_rng(1)
    f0 = rng.uniform(80.0, 600.0, (b, t_frames + 2, 1)).astype(np.float32)
    amps = rng.uniform(0.01, 1.0, (b, t_frames + 2, h)).astype(np.float32)
    loud = rng.uniform(0.0, 1.0, (b, t_frames + 2, 1)).astype(np.float32)
    phase0 = rng.uniform(0.0, 1.0, (b,)).astype(np.float32)
    want, wphase = jax_osc.render_padded(
        jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(loud),
        sample_rate=sr, hop=hop, initial_phase=jnp.asarray(phase0),
    )
    got, gphase = osc.render_padded(
        torch.from_numpy(f0), torch.from_numpy(amps), torch.from_numpy(loud),
        sample_rate=sr, hop=hop, initial_phase=torch.from_numpy(phase0),
    )
    assert snr(np.asarray(want), got.numpy()) > 80.0
    np.testing.assert_allclose(gphase.numpy(), np.asarray(wphase), atol=1e-6)


def test_nyquist_mask_is_strict():
    """h * f0 == sr // 2 exactly stays audible (strict >), as the reference."""
    f0 = torch.tensor([[[100.0]]])
    amps = torch.ones((1, 1, 4))
    got = osc.nyquist_normalized_amps(f0, amps, sample_rate=601)  # nyq 300
    np.testing.assert_allclose(got.numpy()[0, 0], [1 / 3, 1 / 3, 1 / 3, 0.0])


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kernel_inputs(n, hop, h, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.uniform(0, 1, (n, hop)),
        *(rng.uniform(0, 1, (n, h)) / h for _ in range(3)),
        rng.uniform(0, 1, (n, 3)),
    ]
    tensors = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    return tensors + [torch.as_tensor(hop_weights(hop), device=device)]


def test_wrapper_takes_plain_version_on_cpu_and_refuses_grad():
    before = cuda_osc.LAUNCHES
    inputs = _kernel_inputs(5, 64, 12, "cpu")
    out = cuda_osc.osc_hop_slots(*inputs)
    assert out.shape == (5, 64)
    assert cuda_osc.LAUNCHES == before  # the plain version is no launch
    inputs[1].requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        cuda_osc.osc_hop_slots(*inputs)
    with pytest.raises(ValueError, match="loud must be"):
        cuda_osc.osc_hop_slots(*_kernel_inputs(5, 64, 12, "cpu")[:4],
                               torch.zeros(5, 2), torch.zeros(64, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop,h", [(256, 512, 180), (13, 128, 40)])
def test_kernel_matches_plain_version_on_card(cuda_device, n, hop, h):
    """The CUDA kernel against its plain version on the same card tensors."""
    inputs = _kernel_inputs(n, hop, h, cuda_device, seed=n)
    before = cuda_osc.LAUNCHES
    got = cuda_osc.osc_hop_slots(*inputs)
    torch.cuda.synchronize()
    assert cuda_osc.LAUNCHES == before + 1
    want = cuda_osc.render_hop_slots_plain(*inputs).double()
    snr_db = 10 * torch.log10(want.pow(2).sum() / (want - got.double()).pow(2).sum())
    assert snr_db.item() > 90.0
