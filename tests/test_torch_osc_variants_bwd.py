"""The oscillator's backward variants in ddsp_tpu_torch against ddsp_tpu's,
same numpy inputs, on CPU: K6 (``impl='banked'``), the K8 options of K2
(``impl='banked2'``: fill, bf16 bank, ``contract_dtype``), S2 (the fill
alone), the bf16 contraction switch of the training backward, and the
sweep's CLI.

On the CPU the port's dispatcher (``ops/cuda/osc_variants.pallas_backward``)
runs the plain versions; they are held against ``_pallas_backward`` and
``scripts/bwd_ablation.run_variant`` run by the Pallas interpreter, as
tests/test_pallas_oscillator.py runs them, at B=2, T=18, hop 128, H=40.

Floors, per gradient (dphase, d amps_pad, d loud_pad): float32 variants
> 80 dB; a bf16 bank or contraction, which both packages round alike,
> 60 dB; K6, which the interpreter computes in float32 (DEFAULT precision
on the CPU) and the port as the TPU's one bf16 pass, > 45 dB and cosine
> 0.9999 (~54 dB measured).  The train step under the bf16 contraction
holds the three-step test's criterion (tests/test_torch_training.py):
loss 1e-4, grad_norm 1e-3 relative, parameters allclose(2e-3, 3e-3).

The contraction dtype is process-wide in both packages; the fixture
resets both.  jax is imported inside the tests that compare with it:
``python -m pytest --noconftest -m cuda tests/test_torch_osc_variants_bwd.py``.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops.cuda import osc_banked_bwd, osc_frames, osc_variants
from ddsp_tpu_torch.utils import osc_sweep

B, T, HOP, H = 2, 18, 128, 40
NAMES = ("dphase", "d amps_pad", "d loud_pad")


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = want - np.asarray(got, np.float64)
    return float(10 * np.log10(np.mean(want**2) / max(np.mean(noise**2), 1e-300)))


def _cos(want, got) -> float:
    a, b = np.asarray(want, np.float64).ravel(), np.asarray(got, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _operands(seed=3, hop=HOP, h=H):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, T, hop)).astype(np.float32),
            (rng.uniform(0, 1, (B, T + 2, h)) / h).astype(np.float32),
            rng.uniform(0, 1, (B, T + 2)).astype(np.float32),
            rng.standard_normal((B, T * hop)).astype(np.float32))


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def port_contract_reset():
    """The port's contraction switch back to None, whatever happens."""
    yield
    osc_frames.set_osc_bwd_contract_dtype(None)


@pytest.fixture
def contract_reset(port_contract_reset):
    """Both packages' contraction switch back to None, whatever happens."""
    from ddsp_tpu.ops.pallas import oscillator as po

    yield po
    po.set_osc_bwd_contract_dtype(None)


BWD_CASES = [
    (dict(impl="banked2", fill="rot"), "f32"),
    (dict(impl="banked2", fill="rot", h_start=8), "f32"),
    (dict(impl="banked2", fill="rot4"), "f32"),
    (dict(impl="banked2", fill="cheb8", resync_tiles=3), "f32"),
    (dict(impl="banked2", fill="rot", bank_dtype="bfloat16"), "bf16"),
    (dict(impl="banked2", fill="rot", contract_dtype="bfloat16"), "bf16"),
    (dict(impl="banked"), "one-pass"),
    (dict(impl="banked", h_start=8), "one-pass"),
    (dict(impl="banked", bank_dtype="bfloat16"), "bf16"),
    # K6 at a hop that is no multiple of its 16-sample k-steps, and at H = 7
    # (one 16-harmonic tile, 9 padded harmonics); "hop" and "harmonics"
    # set the operands' shape, not an option
    (dict(impl="banked", hop=200), "one-pass"),
    (dict(impl="banked", harmonics=7, h_start=5), "one-pass"),
]


@pytest.mark.parametrize("kw,grade", BWD_CASES)
def test_backward_variant_matches_interpreted_jax(interpret, kw, grade):
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.oscillator import _pallas_backward

    kw = dict(kw)
    phase, amps, loud, g = _operands(hop=kw.pop("hop", HOP), h=kw.pop("harmonics", H))
    want = _pallas_backward(*(jnp.asarray(x) for x in (phase, amps, loud, g)), 4, **kw)
    got = osc_variants.pallas_backward(*(torch.from_numpy(x) for x in (phase, amps, loud, g)),
                                       4, **kw)
    for name, a, c in zip(NAMES, want, got):
        a, c = np.asarray(a), c.numpy()
        assert c.shape == a.shape, name
        snr = _snr(a, c)
        if grade == "f32":
            assert snr > 80.0, (name, snr)
        elif grade == "bf16":
            assert snr > 60.0, (name, snr)
        else:
            assert snr > 45.0 and _cos(a, c) > 0.9999, (name, snr)


def test_fill_only_matches_the_ablation_kernel(interpret):
    import jax.numpy as jnp

    from scripts.bwd_ablation import _kernel_fill_only, run_variant

    phase, amps, loud, g = _operands(seed=5)
    want = run_variant(_kernel_fill_only, *(jnp.asarray(x) for x in (phase, amps, loud, g)))
    got = osc_banked_bwd.osc_fill_only(torch.from_numpy(phase), torch.from_numpy(amps))
    assert _snr(np.asarray(want[0])[:, :T], got[0].numpy()) > 90.0
    for a, c in zip(want[1:4], got[1:4]):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a)[:, :T, :H])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4])[:, :T])


def test_render_from_phase_honours_the_contract_dtype_on_cpu(port_contract_reset):
    """Under 'bfloat16' the CPU gradient is the plain backward with the
    casts, not autograd; the setting in force at the forward decides."""
    phase, amps, loud, g = (torch.from_numpy(x) for x in _operands(seed=7))

    def grads():
        leaves = [x.clone().requires_grad_(True) for x in (phase, amps, loud)]
        out = osc_frames.render_from_phase(*leaves, 3)
        return torch.autograd.grad(out, leaves, g)

    f32 = grads()
    osc_frames.set_osc_bwd_contract_dtype("bfloat16")
    bf16 = grads()
    want = osc_frames.render_from_phase_bwd_variant_plain(g, phase, amps, loud, 3, bf16=True)
    for a, b, c in zip(want, bf16, f32):
        assert torch.equal(a, b)
        assert 45.0 < _snr(c.numpy(), b.numpy()) < 70.0
    with pytest.raises(ValueError, match="contract dtype"):
        osc_frames.set_osc_bwd_contract_dtype("float16")
    osc_frames.set_osc_bwd_contract_dtype(torch.bfloat16)
    assert osc_frames.get_osc_bwd_contract_dtype() == "bfloat16"


def test_train_step_with_bf16_contraction_matches_jax(interpret, contract_reset):
    """One decoder train step under set_osc_bwd_contract_dtype('bfloat16')
    in both packages, the JAX side on its Pallas oscillator (K1/K2 by the
    interpreter), the port's on the CPU's plain versions with the casts."""
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.training import trainer as jax_trainer
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.convert import decoder_from_jax, decoder_to_jax
    from ddsp_tpu_torch.training import trainer

    kw = dict(sample_rate=4000, n_fft=256, hop_length=64, example_duration=0.25,
              n_harmonics=16, n_noise_filters=17, decoder_mlp_units=32,
              decoder_mlp_layers=1, decoder_gru_units=32, batch_size=2,
              mss_ffts=(128, 64), checkpoint_every=0, reverb_length=512)
    jconf = JaxConfig(**kw, loss_matmul_dtype="float32", reverb_grad_matmul_dtype="float32",
                      osc_impl="pallas")
    conf = Config(**kw)
    contract_reset.set_osc_bwd_contract_dtype("bfloat16")
    osc_frames.set_osc_bwd_contract_dtype("bfloat16")
    jstate = jax_trainer.init_state(jax.random.PRNGKey(0), jconf)
    decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), conf)
    state = trainer.TrainState(
        0, decoder, trainer.make_optimizer(conf).init(list(decoder.parameters())),
        torch.from_numpy(np.asarray(jstate.rng).astype(np.int64)))
    rng = np.random.default_rng(0)
    t = conf.frames_per_example
    batch = {"f0": rng.uniform(100, 400, (2, t, 1)).astype(np.float32),
             "normalized_cents": rng.uniform(0, 1, (2, t, 1)).astype(np.float32),
             "loudness": rng.uniform(0, 1, (2, t, 1)).astype(np.float32),
             "audio": (0.1 * rng.standard_normal((2, conf.example_length))).astype(np.float32)}
    jstate, jm = jax_trainer.make_train_step(jconf)(jstate, batch)
    state, m = trainer.make_train_step(conf)(state, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    for name, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
        want, got = float(jm[name]), float(m[name])
        assert abs(got - want) <= rtol * abs(want), (name, got, want)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=2e-3, atol=3e-3),
        jstate.params, decoder_to_jax(state.params))


def test_backward_refusals():
    phase, amps, loud, g = (torch.from_numpy(x) for x in _operands())
    with pytest.raises(ValueError, match="impl"):
        osc_variants.pallas_backward(phase, amps, loud, g, impl="cheb")
    with pytest.raises(ValueError, match="dtype"):
        osc_variants.pallas_backward(phase, amps, loud, g, bank_dtype="float16")
    with pytest.raises(ValueError, match="rot4"):
        osc_frames.render_from_phase_bwd_variant_plain(g, phase, amps, loud, fill="rot4",
                                                       chunk_tiles=2)
    with pytest.raises(ValueError, match="g must be"):
        osc_banked_bwd.osc_banked_bwd(g[:, 1:], phase, amps, loud)
    osc_sweep.reset_launches()
    osc_banked_bwd.osc_fill_only(phase, amps)
    osc_variants.pallas_backward(phase, amps, loud, g)
    assert (osc_banked_bwd.BWD_LAUNCHES, osc_banked_bwd.FILL_LAUNCHES) == (0, 0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_frames_bwd(g, phase, amps, loud, bf16=True)


@pytest.mark.parametrize("mode", ["bwd", "ablate", "contract"])
def test_sweep_cli_runs_plain_versions_on_cpu(mode, port_contract_reset):
    rows = osc_sweep.main([mode, "--device=cpu", "--frames=6", "--h_start=8"])
    if mode == "contract":
        grads, times = rows[:3], rows[3:]
        assert [r["label"] for r in grads] == ["grad[f0]", "grad[c]", "grad[a]"]
        assert all(r["cos"] > 0.999 for r in grads)
        assert len(times) == 4 and all(r["ms"] > 0 for r in times)
        assert osc_frames.get_osc_bwd_contract_dtype() is None
        return
    for r in rows:
        assert r["launches"] == r["expected_launches"] == 0
        if r.get("reference"):
            continue
        assert r["finite"] and all(v > (45.0 if r["bf16"] else 80.0)
                                   for v in np.atleast_1d(list(
                                       r["db_f64"].values() if isinstance(r["db_f64"], dict)
                                       else [r["db_f64"]])))
    if mode == "ablate":
        assert rows[0]["kernel"] == "osc_fill_only" and rows[0]["copies_equal"]
        assert rows[-1]["kernel"] == "osc_banked_bwd"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_backward_kernels_match_plain_versions_on_card(cuda_device):
    """Every backward variant, K6 and S2 against their plain versions on the
    card (float32 > 80 dB, bf16 > 60 dB), bit-equal reruns, launches."""
    osc_sweep.reset_launches()
    rows = osc_sweep.sweep_bwd(cuda_device, (B, T, HOP, H), h_start=8, iters=1)
    rows += osc_sweep.sweep_ablate(cuda_device, (B, T, HOP, H), iters=1)
    for r in rows:
        assert r["launches"] == r["expected_launches"], r
        if r.get("reference"):
            continue
        assert r["finite"] and r.get("bit_equal", True) and r.get("copies_equal", True), r
        dbs = r["db_plain"].values() if isinstance(r["db_plain"], dict) else [r["db_plain"]]
        assert min(dbs) > (60.0 if r["bf16"] else 80.0), r


# K6 and S2 at the shapes their warp layout makes awkward: H of 1, 7 and
# 301 (one tile, a ragged tile, tiles past the 12 held in registers), hops
# of 128 and 200 (200: a k-step of 8 live samples), h_start up to 2048 - H.
BANKED_SHAPES = [(2, 3, 128, 1, 0), (2, 3, 200, 7, 5), (2, 4, 128, 40, 8),
                 (1, 2, 200, 301, 1747), (2, 3, 200, 40, 2008), (2, 4, 512, 180, 0)]


def _card_operands(device, b, t, hop, h):
    rng = np.random.default_rng(b + t + hop + h)
    arrays = (rng.uniform(0, 1, (b, t, hop)), rng.uniform(0, 1, (b, t + 2, h)) / h,
              rng.uniform(0, 1, (b, t + 2)), rng.standard_normal((b, t * hop)))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,hop,h,h_start", BANKED_SHAPES)
def test_k6_at_awkward_shapes_on_card(cuda_device, b, t, hop, h, h_start, bank_dtype):
    """K6 against its plain version: each gradient finite and > 60 dB (one
    bf16 pass both sides, float32 sums in another order), reruns bit-equal,
    one launch a call."""
    phase, amps, loud, g = _card_operands(cuda_device, b, t, hop, h)
    before = osc_banked_bwd.BWD_LAUNCHES
    got = osc_banked_bwd.osc_banked_bwd(g, phase, amps, loud, h_start, bank_dtype)
    again = osc_banked_bwd.osc_banked_bwd(g, phase, amps, loud, h_start, bank_dtype)
    torch.cuda.synchronize()
    assert osc_banked_bwd.BWD_LAUNCHES == before + 2
    want = osc_banked_bwd.banked_bwd_plain(g, phase, amps, loud, h_start, bank_dtype)
    for label, a, c, c2 in zip(NAMES, want, got, again):
        assert c.shape == a.shape and bool(torch.isfinite(c).all()), label
        assert torch.equal(c, c2), label
        assert _snr(a.cpu().numpy(), c.cpu().numpy()) > 60.0, label


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hop,h,h_start", BANKED_SHAPES)
def test_fill_only_at_awkward_shapes_on_card(cuda_device, b, t, hop, h, h_start):
    """S2 bit-equal to its plain version (the rotation fill's bits) and its
    amplitude copies and zeros equal, one launch a call."""
    phase, amps, _, _ = _card_operands(cuda_device, b, t, hop, h)
    before = osc_banked_bwd.FILL_LAUNCHES
    got = osc_banked_bwd.osc_fill_only(phase, amps)
    torch.cuda.synchronize()
    assert osc_banked_bwd.FILL_LAUNCHES == before + 1
    for a, c in zip(osc_banked_bwd.fill_only_plain(phase, amps), got):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_seed_sincos_has_the_bits_of_sincosf_on_card(cuda_device):
    """The kernels' branch-free seeds equal sincosf at every float fraction."""
    assert osc_banked_bwd.sincos_seed_mismatches(cuda_device) == 0


@pytest.mark.cuda
def test_k6_entry_launches_the_overlap_add_kernel(cuda_device, monkeypatch):
    """On the card K6's entry sums the window gradients with
    osc_frames.osc_overlap_add (one launch), never the plain loop."""
    def plain(*args):
        raise AssertionError("the plain overlap-add ran on the card")

    monkeypatch.setattr(osc_frames, "overlap_add_windows", plain)
    phase, amps, loud, g = _card_operands(cuda_device, 2, 5, 128, 40)
    before = (osc_frames.OVERLAP_LAUNCHES, osc_banked_bwd.BWD_LAUNCHES)
    got = osc_variants.pallas_backward(phase, amps, loud, g, h_start=3, impl="banked")
    torch.cuda.synchronize()
    assert (osc_frames.OVERLAP_LAUNCHES, osc_banked_bwd.BWD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)
    monkeypatch.undo()
    _, da_win, dl_win = osc_banked_bwd.osc_banked_bwd_windows(g, phase, amps, loud, 3)
    for a, c in zip(osc_frames.overlap_add_windows(da_win, dl_win, 5), got[1:]):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_bf16_contraction_on_card_matches_plain(cuda_device, port_contract_reset):
    phase, amps, loud, g = (torch.from_numpy(x).to(cuda_device) for x in _operands(seed=9))
    osc_frames.set_osc_bwd_contract_dtype("bfloat16")
    before = osc_frames.VARIANT_LAUNCHES["osc_frames_bwd[bf16]"]
    leaves = [x.clone().requires_grad_(True) for x in (phase, amps, loud)]
    got = torch.autograd.grad(osc_frames.render_from_phase(*leaves, 2), leaves, g)
    torch.cuda.synchronize()
    assert osc_frames.VARIANT_LAUNCHES["osc_frames_bwd[bf16]"] == before + 1
    want = osc_frames.render_from_phase_bwd_variant_plain(g, phase, amps, loud, 2, bf16=True)
    for a, c in zip(want, got):
        assert _snr(a.cpu().numpy(), c.cpu().numpy()) > 60.0


# Every fill x bf16 instantiation of K2 at the shapes its slot ownership
# makes awkward: H of 1 and 7, h_start + H = 2048, hops of 100 and 200 (no
# multiple of a block's samples), a lone frame, the training width.
FRAME_SHAPES = [(1, 1, 100, 1, 0), (2, 3, 100, 7, 5), (1, 2, 64, 24, 2024),
                (1, 2, 64, 301, 1747), (3, 4, 200, 41, 8), (2, 4, 512, 180, 0)]
FILL_OPTIONS = [("exact", {}), ("rot", {}), ("rot", {"chunk_tiles": 2}), ("rot4", {}),
                ("cheb8", {}), ("cheb8", {"resync_tiles": 3, "chunk_tiles": 5})]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fill,opts", FILL_OPTIONS)
@pytest.mark.parametrize("b,t,hop,h,h_start", FRAME_SHAPES)
def test_backward_instantiations_at_awkward_shapes_on_card(
        cuda_device, b, t, hop, h, h_start, fill, opts, bf16):
    """osc_frames_bwd against its plain version of the same options: each
    gradient > 80 dB (float32) or > 60 dB (bf16), two runs bit-equal."""
    rng = np.random.default_rng(b + t + h)
    arrays = (rng.uniform(0, 1, (b, t, hop)), rng.uniform(0, 1, (b, t + 2, h)) / h,
              rng.uniform(0, 1, (b, t + 2)), rng.standard_normal((b, t * hop)))
    phase, amps, loud, g = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
                            for x in arrays)
    name = osc_frames.variant_name("osc_frames_bwd", fill, bf16, **opts)
    before = osc_frames.VARIANT_LAUNCHES[name]
    got = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill=fill, bf16=bf16, **opts)
    again = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill=fill, bf16=bf16,
                                      **opts)
    torch.cuda.synchronize()
    assert osc_frames.VARIANT_LAUNCHES[name] == before + 2
    want = osc_frames.render_from_phase_bwd_variant_plain(
        g, phase, amps, loud, h_start, fill=fill, bf16=bf16, **opts)
    for label, a, c, c2 in zip(NAMES, want, got, again):
        assert c.shape == a.shape and bool(torch.isfinite(c).all()), label
        assert torch.equal(c, c2), label
        assert _snr(a.cpu().numpy(), c.cpu().numpy()) > (60.0 if bf16 else 80.0), label
