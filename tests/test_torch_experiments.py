"""The port's spectrogram experiments against the JAX package's, on the CPU:
``ops/griffin_lim`` (STFT pair, iSTFT, Griffin-Lim), the style-transfer
building blocks, CREPE DeepDream (``dream``, ``dream_file``, the CLI) and
the Streamlit UI through ``tests/streamlit_double.py``.  The same seeded
numpy inputs and the JAX package's weights (through ``models/convert``) go
through both.  jax and the JAX package are imported inside the tests, so a
machine without jax can collect this file; the ``cuda`` tests hold the card
against the port on the CPU."""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import importlib
import sys

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
from ddsp_tpu_torch.experiments import dream as tdream
from ddsp_tpu_torch.experiments import style_transfer as tst
from ddsp_tpu_torch.models.convert import crepe_from_jax, extractor_from_jax
from ddsp_tpu_torch.models.crepe import crepe_init, save_torch_checkpoint
from ddsp_tpu_torch.ops import fir
from ddsp_tpu_torch.ops import griffin_lim as tgl
from ddsp_tpu_torch.utils.gl_quality_curve import fixture_audio, spectral_convergence

N_FFT, HOP = 512, 128
# port vs JAX (XLA's DFT matmuls against torch.fft, float32): measured
# 132 dB (STFT), 131.9 dB (iSTFT); the round trip 139.5 dB
TRANSFORM_FLOOR_DB = 110.0
# Griffin-Lim on the 8 kHz fixture, port vs JAX: the waveform measured
# 123.5 dB after 1 iteration and 104.8 dB after 8; momentum 0.99 amplifies
# float differences (82.0 dB at 40, 71.3 dB at 512), so 40 iterations are
# compared by spectral convergence (measured 5.5e-7 relative), not waveform
GL_SHORT_FLOOR_DB = 90.0
GL_SC_RTOL = 1e-5
# jax.random.normal against the port's draw on XLA's float32 erfinv
# polynomial: the uniforms are bit-equal; erfinv differs in 4.4-4.6 % of the
# elements by at most 4 float32 ulps of the value (log1p and the Horner
# steps round differently), held at 8
NORMAL_MAX_ULPS = 8
# the building blocks on JAX's extractor: each array within 1e-5 of its
# largest magnitude (measured: log spectrogram 4.3e-6, where the tone's
# empty bins differ by the DFT's absolute rounding; features 5.9e-7; Gram
# 2.0e-7), the loss terms 1e-5 relative
BLOCK_RTOL = 1e-5
# dream: 3 iterations at lr 10 on tiny CREPE, measured 138 dB and 2.5e-7
DREAM_FLOOR_DB = 100.0
DREAM_VALUE_RTOL = 1e-5


def snr_db(ref, est) -> float:
    ref = np.asarray(ref, np.float64)
    noise = ref - np.asarray(est, np.float64)
    return float("inf") if not noise.any() else float(
        10 * np.log10(np.mean(ref**2) / np.mean(noise**2)))


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _fixture(sr=8000, seconds=1.0):
    return fixture_audio(sr, seconds)


# ----------------------------------------------------------- Griffin-Lim


def test_stft_pair_and_istft_match_jax():
    jax, jnp = _jax()
    from ddsp_tpu.ops import griffin_lim as jgl

    x = np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32)
    jre, jim = jgl.stft_pair(jnp.asarray(x), N_FFT, HOP)
    re, im = tgl.stft_pair(torch.from_numpy(x), N_FFT, HOP)
    assert re.shape == jre.shape == (2, 4096 // HOP + 1, N_FFT // 2 + 1)
    assert snr_db(jre, re) > TRANSFORM_FLOOR_DB and snr_db(jim, im) > TRANSFORM_FLOOR_DB
    jback = jgl.istft(jre, jim, N_FFT, HOP, length=4096)
    back = tgl.istft(re, im, N_FFT, HOP, length=4096)
    assert back.shape == x.shape
    assert snr_db(jback, back) > TRANSFORM_FLOOR_DB
    assert snr_db(x, back) > 120.0  # the round trip
    # center=False and no length: the raw overlap-add span, compared where
    # the squared-window sum is not near 0 (its first and last n_fft/2
    # samples divide by down to 1e-11, where any rounding is magnified)
    re, im = tgl.stft_pair(torch.from_numpy(x), N_FFT, HOP, center=False)
    jre, jim = jgl.stft_pair(jnp.asarray(x), N_FFT, HOP, center=False)
    jraw = np.asarray(jgl.istft(jre, jim, N_FFT, HOP, center=False))
    raw = tgl.istft(re, im, N_FFT, HOP, center=False).numpy()
    assert raw.shape == jraw.shape == (2, 4096)
    inner = slice(N_FFT // 2, -N_FFT // 2)
    assert snr_db(jraw[:, inner], raw[:, inner]) > TRANSFORM_FLOOR_DB


@pytest.mark.parametrize("seed, shape", [(0, (63, 257)), (7, (2, 5, 33))])
def test_griffin_lim_initial_angles_bit_equal(seed, shape):
    """The angles are jax.random.uniform(key, shape, 0, 2 pi) bit for bit,
    and griffin_lim starts from them: with no iteration it is the iSTFT of
    magnitude * exp(i angle) (compared with JAX's at the transform floor)."""
    jax, jnp = _jax()
    from ddsp_tpu.ops import griffin_lim as jgl

    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32,
                                         0.0, 2 * np.pi))
    got = fir.uniform(fir.PRNGKey(seed), shape, 0.0, 2 * np.pi).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if shape[-1] == N_FFT // 2 + 1:
        mag = np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
        y = tgl.griffin_lim(torch.from_numpy(mag), N_FFT, HOP, n_iter=0,
                            key=fir.PRNGKey(seed))
        ang = torch.from_numpy(got)
        ref = tgl.istft(torch.from_numpy(mag) * torch.cos(ang),
                        torch.from_numpy(mag) * torch.sin(ang), N_FFT, HOP)
        assert torch.equal(y, ref)
        jy = jgl.griffin_lim(jnp.asarray(mag), N_FFT, HOP, n_iter=0,
                             key=jax.random.PRNGKey(seed))
        assert snr_db(jy, y) > TRANSFORM_FLOOR_DB


@pytest.mark.parametrize("n_iter", [1, 8])
def test_griffin_lim_short_runs_match_jax(n_iter):
    jax, jnp = _jax()
    from ddsp_tpu.ops import griffin_lim as jgl

    x = _fixture()
    mag = tgl.stft_pair(torch.from_numpy(x), N_FFT, HOP)
    mag = torch.sqrt(mag[0] ** 2 + mag[1] ** 2)
    y = tgl.griffin_lim(mag, N_FFT, HOP, n_iter=n_iter, length=x.size)
    jy = jgl.griffin_lim(jnp.asarray(mag.numpy()), N_FFT, HOP, n_iter=n_iter, length=x.size)
    assert y.shape == jy.shape == ((x.size // HOP) * HOP,)  # (frames - 1) hops
    assert snr_db(jy, y) > GL_SHORT_FLOOR_DB


def test_griffin_lim_spectral_convergence_at_40_iterations():
    """40 iterations: the spectral convergence equals JAX's within
    GL_SC_RTOL relative, and is well below the start's (as the JAX
    package's tone test asks of its own)."""
    jax, jnp = _jax()
    from ddsp_tpu.ops import griffin_lim as jgl

    x = _fixture()
    re, im = tgl.stft_pair(torch.from_numpy(x), N_FFT, HOP)
    mag = torch.sqrt(re**2 + im**2)
    y = tgl.griffin_lim(mag, N_FFT, HOP, n_iter=40, length=x.size)
    jy = jgl.griffin_lim(jnp.asarray(mag.numpy()), N_FFT, HOP, n_iter=40, length=x.size)
    sc = spectral_convergence(y, mag, N_FFT, HOP)
    jsc = spectral_convergence(torch.from_numpy(np.array(jy)), mag, N_FFT, HOP)
    sc0 = spectral_convergence(tgl.griffin_lim(mag, N_FFT, HOP, n_iter=0, length=x.size),
                               mag, N_FFT, HOP)
    assert abs(sc - jsc) <= GL_SC_RTOL * jsc, (sc, jsc)
    assert sc < 0.5 * sc0, (sc, sc0)


# ---------------------------------------------------- style transfer blocks


def _conf(**kw):
    base = dict(n_fft=N_FFT, hop=HOP, n_features=256, n_steps=12, gl_iters=8, sample_rate=8000)
    base.update(kw)
    return base


def _pair(sr=8000):
    t = np.arange(sr) / sr
    content = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    style = (0.5 * np.random.default_rng(0).standard_normal(sr)).astype(np.float32)
    return content, style


def test_extractor_init_matches_jax_normal():
    jax, jnp = _jax()
    from ddsp_tpu.experiments import style_transfer as jst

    for n_channels, seed in ((257, 0), (33, 5)):
        want = np.asarray(jst.extractor_init(jax.random.PRNGKey(seed), n_channels,
                                             jst.StyleTransferConfig(**_conf()))["weight"])
        got = tst.extractor_init(fir.PRNGKey(seed), n_channels,
                                 tst.StyleTransferConfig(**_conf()))["weight"].numpy()
        assert got.shape == want.shape == (256, n_channels, 17)
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= NORMAL_MAX_ULPS, ulps.max()
        assert (got != want).mean() < 0.1


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BLOCK_RTOL, err


def test_style_building_blocks_match_jax():
    """log_spectrogram, extract_features, gram_matrix and both loss terms on
    JAX's extractor, carried over by ``extractor_from_jax``."""
    jax, jnp = _jax()
    from ddsp_tpu.experiments import style_transfer as jst

    content, style = _pair()
    jconf, conf = jst.StyleTransferConfig(**_conf()), tst.StyleTransferConfig(**_conf())
    jcs, jss = jst.log_spectrogram(jnp.asarray(content), jconf), jst.log_spectrogram(
        jnp.asarray(style), jconf)
    cs = tst.log_spectrogram(torch.from_numpy(content), conf)
    ss = tst.log_spectrogram(torch.from_numpy(style), conf)
    _close(cs, jcs)
    ext = jst.extractor_init(jax.random.PRNGKey(0), jcs.shape[0], jconf)
    text = extractor_from_jax(jax.tree.map(np.asarray, ext))
    jf, f = jst.extract_features(ext, jss), tst.extract_features(text, ss)
    assert f.shape == jf.shape == (256, ss.shape[1] - 16)
    _close(f, jf)
    jg, g = jst.gram_matrix(jf), tst.gram_matrix(f)
    _close(g, jg)

    vg = tst.make_value_and_grad(text, cs, ss, conf)
    spec = cs + 0.01 * torch.from_numpy(
        np.random.default_rng(1).standard_normal(cs.shape).astype(np.float32))
    loss, grad, (c, s) = vg(spec)
    jspec = jnp.asarray(spec.numpy())
    jfe = jst.extract_features(ext, jspec)
    jc = float(jnp.mean((jfe - jst.extract_features(ext, jcs)) ** 2))
    js = float(jnp.mean((jst.gram_matrix(jfe) - jst.gram_matrix(jst.extract_features(ext, jss)))
                        ** 2))
    assert abs(float(c) - jc) <= 1e-5 * jc and abs(float(s) - js) <= 1e-5 * js
    assert abs(float(loss) - (jc + 1e13 * js)) <= 1e-5 * float(loss)
    assert grad.shape == spec.shape and torch.isfinite(grad).all()


def test_style_transfer_spec_rejects_short_spectrograms():
    conf = tst.StyleTransferConfig(**_conf())
    spec = np.zeros((N_FFT // 2 + 1, 16), np.float32)
    with pytest.raises(ValueError, match="16 frames < kernel_size 17"):
        tst.style_transfer_spec(spec, spec, conf, device="cpu")


# ---------------------------------------------------------------- dream


def _crepe_pair():
    jax, _ = _jax()
    from ddsp_tpu.models.crepe import crepe_init as jcrepe_init

    jc = jcrepe_init(jax.random.PRNGKey(0), "tiny")
    return jc, crepe_from_jax(jax.tree.map(np.asarray, jc))


def test_dream_matches_jax():
    """3 iterations at the reference's lr 10 on layer 2, 2,048 samples."""
    jax, jnp = _jax()
    from ddsp_tpu.experiments.dream import dream as jdream
    from ddsp_tpu.models.crepe import crepe_activation as jact

    jc, tc = _crepe_pair()
    audio = (0.1 * np.random.default_rng(1).standard_normal((1, 2048))).astype(np.float32)
    jout, jvalue = jdream(jc, jnp.asarray(audio), 2, 3, 10.0)
    out, value = tdream.dream(tc, audio, 2, 3, 10.0, device="cpu")
    assert out.shape == (1, 2048) and np.abs(out).max() <= 1.0
    assert snr_db(jout, out) > DREAM_FLOOR_DB
    assert abs(value - jvalue) <= DREAM_VALUE_RTOL * jvalue
    # the activation rises: the returned audio, normalised, excites the
    # layer more than the input did
    def norm_of(x):
        xn = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True, ddof=1)
        return float(jnp.linalg.norm(jact(jc, jnp.asarray(xn), 2)[0]))

    assert norm_of(out) > norm_of(audio)


def test_dream_file_and_cli_match_jax(tmp_path, capsys):
    """``dream_file`` and the CLI on a 22.05 kHz WAV written by the port
    (resampled to 16 kHz, truncated to a multiple of 2,048) with a CREPE
    checkpoint saved by the port, against the JAX package's dream_file on
    the same file and weights: the same 16-bit WAV within one step."""
    from ddsp_tpu.experiments.dream import dream_file as jdream_file

    jc, tc = _crepe_pair()
    in_wav, ckpt = str(tmp_path / "in.wav"), str(tmp_path / "tiny.pth")
    rng = np.random.default_rng(2)
    write_wav(in_wav, (0.1 * rng.standard_normal(int(0.3 * 22050))).astype(np.float32), 22050)
    save_torch_checkpoint(tc, ckpt)
    jvalue = jdream_file(jc, in_wav, str(tmp_path / "jax.wav"), 2, 3, 1.0)
    value = tdream.dream_file(tc, in_wav, str(tmp_path / "port.wav"), 2, 3, 1.0, device="cpu")
    tdream.main([ckpt, in_wav, str(tmp_path / "cli.wav"), "2", "3", "1.0", "--device=cpu"])
    assert "done: final activation norm" in capsys.readouterr().out
    (jout, _), (out, sr), (cli, _) = (read_wav(str(tmp_path / f"{n}.wav"))
                                      for n in ("jax", "port", "cli"))
    assert sr == 16000 and out.shape == jout.shape == (1, 4096)  # 4,800 samples -> 4,096
    assert np.abs(out - jout).max() <= 1.0 / 32768 + 1e-7
    assert np.array_equal(out, cli)
    assert abs(value - jvalue) <= DREAM_VALUE_RTOL * jvalue
    short = str(tmp_path / "short.wav")
    write_wav(short, np.zeros(2047, np.float32), 16000)
    with pytest.raises(ValueError, match="need >= 2048 samples"):
        tdream.dream_file(tc, short, str(tmp_path / "x.wav"), device="cpu")


# ------------------------------------------------------------------- UI


def test_ui_helpers():
    """normalize_audio / trim_to_times / spectrogram_image (helper.py:14-63)
    equal the JAX package's on the same inputs."""
    from ddsp_tpu.experiments import ui as jui

    from ddsp_tpu_torch.experiments import ui

    rng = np.random.default_rng(3)
    x = (0.25 * rng.standard_normal(8000) + 0.5).astype(np.float32)
    y = ui.normalize_audio(x)
    assert abs(y.mean()) < 1e-6 and np.isclose(np.abs(y).max(), 1.0)
    assert np.array_equal(y, jui.normalize_audio(x))
    assert np.allclose(ui.normalize_audio(np.full(100, 0.5, np.float32)), 0.0)
    sr, hop = 8000, 256
    spec = rng.standard_normal((129, len(x) // hop)).astype(np.float32)
    a, s = ui.trim_to_times(x, spec, sr, hop, 0.25, 0.75)
    ja, js = jui.trim_to_times(x, spec, sr, hop, 0.25, 0.75)
    assert np.array_equal(a, ja) and np.array_equal(s, js)
    assert s.shape == (129, int(0.75 * sr / hop) - int(0.25 * sr / hop))
    img = ui.spectrogram_image(spec)
    assert np.array_equal(img, jui.spectrogram_image(spec))
    assert img.min() == 0.0 and img.max() == 1.0


def _ui_with(fake):
    """The port's experiments.ui reloaded with ``fake`` as `streamlit`."""
    import ddsp_tpu_torch.experiments.ui as ui

    sys.modules["streamlit"] = fake
    try:
        return importlib.reload(ui)
    except BaseException:
        _restore_ui()
        raise


def _restore_ui():
    import ddsp_tpu_torch.experiments.ui as ui

    sys.modules.pop("streamlit", None)
    importlib.reload(ui)


def _wav_bytes(tmp_path, name, freq, sr, seconds=1.0):
    t = np.arange(int(seconds * sr)) / sr
    p = tmp_path / name
    write_wav(str(p), (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32), sr)
    return p.read_bytes()


def _fake(tmp_path, **values):
    from streamlit_double import FakeStreamlit, FakeUpload

    widget = {"optimizer steps": 6, "conv kernel size": 5, "conv features": 32,
              "window size": 512, "hop length": 128, "Griffin-Lim iterations": 8,
              "content start [s]": 0.05, "content end [s]": 0.95, "start": True}
    widget.update(values)
    return FakeStreamlit(widget_values=widget, uploads={
        "content audio (wav)": FakeUpload(_wav_bytes(tmp_path, "content.wav", 440.0, 8000)),
        "style audio (wav)": FakeUpload(_wav_bytes(tmp_path, "style.wav", 220.0, 4000)),
    })


def test_ui_main_end_to_end(tmp_path):
    """main() through the double with device="cpu": two uploads at
    different rates (the resample branch), trim sliders, start; previews,
    two figures, the metrics and the result WAV, and the metrics equal the
    JAX UI's on the same script."""
    fake, jfake = _fake(tmp_path), _fake(tmp_path)
    try:
        ui = _ui_with(fake)
        assert ui.HAS_STREAMLIT
        ui.main(device="cpu")
    finally:
        _restore_ui()
    import ddsp_tpu.experiments.ui as jui

    sys.modules["streamlit"] = jfake
    try:
        importlib.reload(jui).main()
    finally:
        sys.modules.pop("streamlit", None)
        importlib.reload(jui)

    assert not fake.calls("warning"), fake.calls("warning")
    assert len(fake.calls("image")) == 2 and len(fake.calls("pyplot")) == 2
    (metrics_args, _), = fake.calls("write")
    (jmetrics_args, _), = jfake.calls("write")
    metrics, jmetrics = metrics_args[0], jmetrics_args[0]
    assert abs(metrics["loss"] - jmetrics["loss"]) <= 1e-4 * abs(jmetrics["loss"])
    for (a, _), (b, _) in zip(fake.calls("image"), jfake.calls("image")):
        np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    audio_calls = fake.calls("audio")
    assert len(audio_calls) == 3
    final_args, final_kw = audio_calls[-1]
    assert final_kw.get("format") == "audio/wav"
    out_path = tmp_path / "result.wav"
    out_path.write_bytes(final_args[0])
    y, out_sr = read_wav(str(out_path))
    assert out_sr == 8000 and y.size > 0 and np.isfinite(y).all()
    assert 0.0 < np.abs(y).max() <= 1.0


def test_ui_main_short_selection_warns(tmp_path):
    fake = _fake(tmp_path, **{"content start [s]": 0.0, "content end [s]": 0.03})
    try:
        _ui_with(fake).main(device="cpu")
    finally:
        _restore_ui()
    assert any("too short" in a[0][0] for a in fake.calls("warning"))
    assert not fake.calls("pyplot")


def test_ui_main_needs_streamlit_then_cuda(tmp_path, monkeypatch):
    """Without streamlit main() points at the CLI; with it and no GPU it
    raises unless the CPU is asked for."""
    import ddsp_tpu_torch.experiments.ui as ui

    assert not ui.HAS_STREAMLIT
    with pytest.raises(RuntimeError, match="ddsp_tpu_torch.experiments.style_transfer"):
        ui.main(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = _fake(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _ui_with(fake).main()
    finally:
        _restore_ui()
    assert not fake.calls("audio")


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_griffin_lim_card_matches_cpu(cuda_device):
    x = torch.from_numpy(_fixture())
    re, im = tgl.stft_pair(x, N_FFT, HOP)
    mag = torch.sqrt(re**2 + im**2)
    want = tgl.griffin_lim(mag, N_FFT, HOP, n_iter=8, length=x.numel())
    got = tgl.griffin_lim(mag.to(cuda_device), N_FFT, HOP, n_iter=8, length=x.numel())
    assert snr_db(want.numpy(), got.cpu().numpy()) > GL_SHORT_FLOOR_DB


@pytest.mark.cuda
def test_dream_card_matches_cpu(cuda_device):
    tc = crepe_init("tiny", seed=0)
    audio = (0.1 * np.random.default_rng(1).standard_normal((1, 2048))).astype(np.float32)
    want, wvalue = tdream.dream(tc, audio, 2, 3, 10.0, device="cpu")
    got, value = tdream.dream(tc, audio, 2, 3, 10.0, device=cuda_device)
    assert snr_db(want, got) > DREAM_FLOOR_DB
    assert abs(value - wvalue) <= DREAM_VALUE_RTOL * wvalue
