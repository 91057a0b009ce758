"""The oscillator's forward variants in ddsp_tpu_torch against ddsp_tpu's,
same numpy inputs, on CPU: the bank fills, K7 (``impl='cheb'``), the K8
options of K1 (``impl='banked2'``: fill, resync_tiles, k_chunk, bf16 bank,
precision DEFAULT), K5 over frame rows with ``h_start`` (``impl='banked'``)
and the sweep's CLI.

On the CPU the port's dispatcher (``ops/cuda/osc_variants.pallas_forward``)
runs the plain versions; they are held against ``_pallas_forward`` run by
the Pallas interpreter, as tests/test_pallas_oscillator.py runs it, at its
ragged shape B=2, T=18, H=40 with hop 128 and 256 (K7's three-accumulator
and split two-accumulator layouts).

Floors: float32 variants > 90 dB SNR against the JAX kernel; a bf16 bank
> 60 dB (both packages round the same float32 sines); precision DEFAULT on
a float32 bank, which the interpreter computes in float32 and the port as
the TPU's one bf16 pass, > 45 dB and cosine > 0.9999 (one bf16 pass
measures ~54 dB).  The fills themselves agree with the JAX fill functions
to 2e-6 (one rounding of a sine or cosine, carried along the chain).

jax is imported inside the tests that compare with it, so the tests marked
``cuda`` also run on a GPU machine without jax:
``python -m pytest --noconftest -m cuda tests/test_torch_osc_variants_fwd.py``.
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.ops import osc_fill
from ddsp_tpu_torch.ops.cuda import osc_cheb, osc_frames, osc_variants
from ddsp_tpu_torch.ops.cuda import oscillator as osc_slots
from ddsp_tpu_torch.utils import osc_sweep

B, T, H = 2, 18, 40


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = want - np.asarray(got, np.float64)
    return float(10 * np.log10(np.mean(want**2) / max(np.mean(noise**2), 1e-300)))


def _cos(want, got) -> float:
    a, b = np.asarray(want, np.float64).ravel(), np.asarray(got, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _operands(hop, seed=3, b=B, t=T, h=H):
    """test_pallas_oscillator.py:79-84's operands."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, t, hop)).astype(np.float32),
            (rng.uniform(0, 1, (b, t + 2, h)) / h).astype(np.float32),
            rng.uniform(0, 1, (b, t + 2)).astype(np.float32))


@pytest.fixture
def interpret():
    """Run Pallas kernels through the interpreter, as the JAX suite does."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


class _Bank:
    """A (rows, L) numpy bank that the JAX fill functions write tiles into."""

    def __init__(self, rows, length):
        self.a = np.zeros((rows, length), np.float32)
        self.dtype = np.float32

    def __setitem__(self, key, value):
        self.a[key] = np.asarray(value)


@pytest.mark.parametrize("fill,h_start,resync,chunk", [
    ("rot", 0, 8, None), ("rot", 8, 8, 2), ("rot4", 5, 8, None),
    ("cheb8", 0, 4, None), ("cheb8", 8, 3, 2),
])
def test_fills_match_jax_fill_functions(fill, h_start, resync, chunk):
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas import oscillator as po

    hb, length = 48, 300
    x = np.random.default_rng(1).uniform(0, 1, (1, length)).astype(np.float32)
    s_j, c_j = _Bank(hb, length), _Bank(hb, length)
    groups = hb // 8
    xj = jnp.asarray(x)
    if fill == "rot4":
        po._fill_sine_banks_rot_logdepth(s_j, c_j, xj, hb, h_start, span=4)
    else:
        step = groups if chunk is None else chunk
        for g0 in range(0, groups, step):
            g1 = min(groups, g0 + step)
            if fill == "rot":
                po._fill_sine_banks_cat_range(s_j, c_j, xj, h_start, g0, g1)
            else:
                po._fill_sine_banks_cheb8(s_j, c_j, xj, hb, h_start, resync, g0, g1)
    s, c = osc_fill.fill_banks(torch.from_numpy(x[0]), hb, h_start, fill, resync, chunk)
    np.testing.assert_allclose(s.numpy().T, s_j.a, atol=2e-6)
    np.testing.assert_allclose(c.numpy().T, c_j.a, atol=2e-6)
    exact, _ = osc_fill.fill_banks(torch.from_numpy(x[0]), hb, h_start, "exact")
    np.testing.assert_allclose(s.numpy(), exact.numpy(), atol=2e-5)  # drift of the chains


FWD_CASES = [
    (128, dict(impl="banked"), "f32"),
    (128, dict(impl="banked", h_start=8), "f32"),
    (128, dict(impl="banked2", fill="rot"), "f32"),
    (128, dict(impl="banked2", fill="rot", h_start=8), "f32"),
    (128, dict(impl="banked2", fill="cheb8", resync_tiles=4), "f32"),
    (128, dict(impl="banked2", fill="cheb8", resync_tiles=23), "f32"),
    (128, dict(impl="banked2", fill="rot", k_chunk=16), "f32"),
    (128, dict(impl="banked2", fill="cheb8", resync_tiles=2, k_chunk=24), "f32"),
    (128, dict(impl="banked2", fill="rot4"), "f32"),
    (128, dict(impl="banked2", fill="rot", bank_dtype="bfloat16"), "bf16"),
    (128, dict(impl="banked2", fill="cheb8", precision="default"), "one-pass"),
    (128, dict(impl="banked2", fill="rot", precision="default", bank_dtype="bfloat16"), "bf16"),
    (128, dict(impl="cheb", resync=4), "f32"),
    (128, dict(impl="cheb", resync=32), "f32"),
    (256, dict(impl="cheb", resync=4), "f32"),
    (256, dict(impl="cheb", resync=32), "f32"),
]


@pytest.mark.parametrize("hop,kw,grade", FWD_CASES)
def test_forward_variant_matches_interpreted_jax(interpret, hop, kw, grade):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.oscillator import _pallas_forward

    phase, amps, loud = _operands(hop)
    jkw = dict(kw)
    if jkw.get("precision") == "default":
        jkw["precision"] = jax.lax.Precision.DEFAULT
    want = np.asarray(_pallas_forward(*(jnp.asarray(x) for x in (phase, amps, loud)), 4, **jkw))
    got = osc_variants.pallas_forward(*(torch.from_numpy(x) for x in (phase, amps, loud)), 4, **kw)
    assert got.shape == want.shape == (B, T * hop)
    snr = _snr(want, got.numpy())
    if grade == "f32":
        assert snr > 90.0, snr
    elif grade == "bf16":
        assert snr > 60.0, snr
    else:
        assert snr > 45.0 and _cos(want, got.numpy()) > 0.9999, snr


@pytest.mark.parametrize("hop", [128, 256, 512])
def test_k7_holds_its_floor_against_float64(hop):
    """K7 at the JAX default resync=32 against the float64 oracle; both
    accumulator layouts (hop 512 splits too)."""
    phase, amps, loud = (torch.from_numpy(x) for x in _operands(hop, seed=hop))
    got = osc_cheb.osc_cheb_fwd(phase, amps, loud, 32)
    assert osc_sweep.snr_db(osc_sweep.oracle_fwd(phase, amps, loud), got[:2]) > 90.0


def test_forward_refusals_match_jax():
    import jax.numpy as jnp

    from ddsp_tpu.ops.pallas.oscillator import _pallas_forward

    phase, amps, loud = _operands(128)
    j = [jnp.asarray(x) for x in (phase, amps, loud)]
    t = [torch.from_numpy(x) for x in (phase, amps, loud)]
    for fn, args in ((_pallas_forward, j), (osc_variants.pallas_forward, t)):
        with pytest.raises(ValueError, match="rot4"):
            fn(*args, 4, impl="banked2", fill="rot4", k_chunk=16)
        with pytest.raises(NotImplementedError, match="h_start"):
            fn(*args, 4, impl="cheb", h_start=3)
    with pytest.raises(ValueError, match="impl"):
        osc_variants.pallas_forward(*t, impl="nope")
    with pytest.raises(ValueError, match="fill"):
        osc_variants.pallas_forward(*t, impl="banked2", fill="nope")
    with pytest.raises(ValueError, match="precision"):
        osc_variants.pallas_forward(*t, impl="banked2", precision="low")


def test_cpu_takes_plain_versions_without_launches():
    phase, amps, loud = (torch.from_numpy(x) for x in _operands(128))
    osc_sweep.reset_launches()
    for kw in (dict(impl="banked", h_start=4), dict(impl="banked2", fill="cheb8"),
               dict(impl="cheb")):
        assert osc_variants.pallas_forward(phase, amps, loud, **kw).shape == (B, T * 128)
    assert (osc_slots.LAUNCHES, osc_cheb.LAUNCHES, osc_frames.FWD_LAUNCHES) == (0, 0, 0)
    assert not osc_frames.VARIANT_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        osc_frames.osc_frames_fwd(phase, amps, loud, fill="rot")
    with pytest.raises(ValueError, match="outside"):
        osc_slots.osc_hop_slots(phase[0], amps[0, :-2], amps[0, 1:-1], amps[0, 2:],
                                torch.zeros(T, 3), torch.zeros(128, 3), h_start=2040)
    assert osc_frames.variant_name("osc_frames_fwd", "cheb8", True, 23, 8) == \
        "osc_frames_fwd[fill=cheb8,resync_tiles=23,chunk_tiles=8,bf16]"


def test_sweep_cli_runs_plain_versions_on_cpu(capsys):
    rows = osc_sweep.main(["fwd", "--device=cpu", "--h_start=8", "--frames=6"])
    assert [r["label"] for r in rows] == [v[0] for v in osc_sweep.FWD_VARIANTS]
    for r in rows:
        assert r["finite"] and r["launches"] == r["expected_launches"] == 0
        assert r["db_f64"] > (45.0 if r["bf16"] else 90.0), r
    rows = osc_sweep.main(["resync", "--device=cpu", "--frames=6"])
    assert [r["kernel"] for r in rows] == ["osc_cheb_fwd"] * len(osc_sweep.RESYNCS)
    assert rows[1]["db_f64"] > 90.0
    assert len(capsys.readouterr().out.splitlines()) == len(osc_sweep.FWD_VARIANTS) + 4


def test_sweep_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        osc_sweep.main(["fwd"])


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [128, 256])
def test_forward_kernels_match_plain_versions_on_card(cuda_device, hop):
    """Every forward variant of the sweep against its plain version on the
    card: float32 > 90 dB, bf16 > 60 dB, with the launches counted."""
    osc_sweep.reset_launches()
    rows = osc_sweep.sweep_fwd(cuda_device, (B, T, hop, H), h_start=8, iters=1)
    for r in rows:
        assert r["finite"], r
        assert r["db_plain"] > (60.0 if r["bf16"] else 90.0), r
        assert r["launches"] == r["expected_launches"], r
    rows = osc_sweep.sweep_resync(cuda_device, (B, T, hop, H), iters=1)
    assert all(r["db_plain"] > 90.0 for r in rows)


# Every fill x bf16 instantiation of K1 at the shapes its block layout makes
# awkward: H of 1 and 7, h_start + H = 2048 (H = 24 and 301), hops of 100
# and 200 (no multiple of a block's samples), a lone frame, the training
# width.
FRAME_SHAPES = [(1, 1, 100, 1, 0), (2, 3, 100, 7, 5), (1, 2, 64, 24, 2024),
                (1, 2, 64, 301, 1747), (3, 4, 200, 41, 8), (2, 4, 512, 180, 0)]
FILL_OPTIONS = [("exact", {}), ("rot", {}), ("rot", {"chunk_tiles": 2}), ("rot4", {}),
                ("cheb8", {}), ("cheb8", {"resync_tiles": 3, "chunk_tiles": 5})]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fill,opts", FILL_OPTIONS)
@pytest.mark.parametrize("b,t,hop,h,h_start", FRAME_SHAPES)
def test_forward_instantiations_at_awkward_shapes_on_card(
        cuda_device, b, t, hop, h, h_start, fill, opts, bf16):
    """osc_frames_fwd against its plain version of the same options:
    float32 > 90 dB, bf16 > 60 dB, one launch counted under its name."""
    phase, amps, loud = (torch.from_numpy(x).to(cuda_device)
                         for x in _operands(hop, seed=b + t + h, b=b, t=t, h=h))
    name = osc_frames.variant_name("osc_frames_fwd", fill, bf16, **opts)
    before = osc_frames.VARIANT_LAUNCHES[name]
    got = osc_frames.osc_frames_fwd(phase, amps, loud, h_start, fill=fill, bf16=bf16, **opts)
    torch.cuda.synchronize()
    assert osc_frames.VARIANT_LAUNCHES[name] == before + 1
    want = osc_frames.render_from_phase_variant_plain(
        phase, amps, loud, h_start, fill=fill, bf16=bf16, **opts)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _snr(want.cpu().numpy(), got.cpu().numpy()) > (60.0 if bf16 else 90.0)
