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

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
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


# K5 where its block layout is awkward: one slot, a ragged count, 257 and
# 2048 slots; hops of 128, 200 (no multiple of a block's samples) and 512;
# H of 1, 7, 180 and 301, with h_start up to 2048 - H.
K5_CARD_SHAPES = [(1, 128, 1, 0), (3, 200, 7, 5), (3, 512, 301, 2048 - 301),
                  (257, 200, 180, 0), (257, 128, 7, 2048 - 7), (2048, 512, 180, 0),
                  (2048, 200, 1, 2047), (1, 512, 301, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("fill", cuda_osc.FILLS)
@pytest.mark.parametrize("n,hop,h,h_start", K5_CARD_SHAPES)
def test_kernel_at_awkward_shapes_on_card(cuda_device, n, hop, h, h_start, fill):
    """K5 against its plain version of the same fill (> 90 dB), a rerun
    bit-equal, two launches counted under the fill's name."""
    inputs = _kernel_inputs(n, hop, h, cuda_device, seed=n + hop + h)
    name = cuda_osc.variant_name(fill)
    before = cuda_osc.VARIANT_LAUNCHES[name]
    got, again = (cuda_osc.osc_hop_slots(*inputs, h_start=h_start, fill=fill) for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_osc.VARIANT_LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = cuda_osc.render_hop_slots_plain(*inputs, h_start=h_start, fill=fill).double()
    snr_db = 10 * torch.log10(want.pow(2).sum() / (want - got.double()).pow(2).sum())
    assert bool(torch.isfinite(got).all()) and snr_db.item() > 90.0


@pytest.mark.cuda
@pytest.mark.parametrize("fill", cuda_osc.FILLS)
@pytest.mark.parametrize("b,t,hop,h,h_start", [(2, 5, 200, 7, 5), (3, 4, 512, 180, 0),
                                               (1, 3, 128, 301, 2048 - 301)])
def test_kernel_on_frame_rows_is_bit_equal_to_k1_on_card(cuda_device, b, t, hop, h, h_start,
                                                          fill):
    """K5 on the rows amps_pad[:, t..t+2] (``impl='banked'``) and K1 on
    amps_pad run one body (csrc/osc_fwd.cuh) with the same sums: bit-equal."""
    from ddsp_tpu_torch.ops.cuda import osc_frames, osc_variants

    rng = np.random.default_rng(b + t + h)
    phase, amps, loud = (torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in (
        rng.uniform(0, 1, (b, t, hop)), rng.uniform(0, 1, (b, t + 2, h)) / h,
        rng.uniform(0, 1, (b, t + 2))))
    if fill == "rot":
        rows = osc_variants.render_rows(phase, amps, loud, h_start)
    else:  # render_rows is the rotation fill's route: the same rows by hand
        lw = torch.stack([loud[:, :-2], loud[:, 1:-1], loud[:, 2:]], -1).reshape(b * t, 3)
        rows = cuda_osc.osc_hop_slots(
            phase.reshape(b * t, hop), *(amps[:, k:k + t].reshape(b * t, h).contiguous()
                                         for k in range(3)),
            lw.contiguous(), torch.as_tensor(hop_weights(hop), device=cuda_device),
            h_start, fill).reshape(b, t * hop)
    k1 = osc_frames.osc_frames_fwd(phase, amps, loud, h_start, fill=fill)
    assert torch.equal(rows, k1)


def test_sass_loops_finds_each_backward_branch():
    """The loop census of utils/osc_kernel_ab.py: a backward branch's body
    runs from its target to the branch, both counted; forward branches
    and other functions' loops stay apart."""
    from ddsp_tpu_torch.utils.osc_kernel_ab import sass_loops

    line = "        /*{:04x}*/                   {} ;   /* 0x0 */\n"
    body = lambda ops: "".join(line.format(16 * i, op) for i, op in enumerate(ops))  # noqa: E731
    listing = (
        "\tFunction : kernel_a\n" + body(["MOV R1, R2", "FFMA R3, R1, R1, R3",
                                         "@P0 BRA 0x40", "FMUL R4, R3, R3",
                                         "@!P1 BRA 0x10", "EXIT"])
        + "\tFunction : kernel_b\n" + body(["S2R R0, SR_TID.X", "BRA 0x0"]))
    loops = sass_loops(listing)
    assert loops == {
        "kernel_a": [dict(start="0x10", end="0x40", instructions=4)],
        "kernel_b": [dict(start="0x0", end="0x10", instructions=2)],
    }


def test_kernel_ab_needs_a_card(monkeypatch):
    from ddsp_tpu_torch.utils import osc_kernel_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        osc_kernel_ab.main([])
