"""The port's style transfer and its L-BFGS against the JAX package's and
optax's, on the CPU, at the size of tests/test_experiments.py (n_fft 512,
hop 128, 256 features, 8 kHz, a 1 s tone against noise): 12 steps of both
optimiser modes, iterate by iterate, with optax's accepted stepsizes and
line-search step counts; each step again from optax's own state; the
audio end to end and the CLI.  jax, optax and the JAX package are imported
inside the tests; the ``cuda`` test holds the card against the CPU."""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
from ddsp_tpu_torch.experiments import style_transfer as tst
from ddsp_tpu_torch.experiments.lbfgs import LBFGS, LBFGSState, LinesearchInfo
from ddsp_tpu_torch.models.convert import extractor_from_jax
from ddsp_tpu_torch.utils.gl_quality_curve import spectral_convergence

SR, N_STEPS = 8000, 12
SMALL = dict(n_fft=512, hop=128, n_features=256, n_steps=N_STEPS, gl_iters=8, sample_rate=SR)
# Tolerances, from measurements on this size (port against optax, float32):
# * the line-search mode, 12 free-running steps: iterates within 5.7e-6 of
#   the displacement from the content (JAX itself moves 4e-6 for a 1e-6
#   input change), losses within 8.6e-6 relative, stepsizes within 6.3e-6,
#   the same line-search step counts;
# * one step from optax's own state, either mode: within 5.5e-6 of the step;
# * the fixed-step mode (learning_rate 0.5, no search) is not a descent
#   method here (its loss rises) and amplifies float noise: JAX against
#   itself with a 1e-7 * max input change parts by 9e-4 of the displacement
#   at step 12, and the port parts from JAX by 2.2e-5 at step 5, 1.2e-4 at
#   step 7 and 2.9e-2 at step 12.  So its free-running iterates are held
#   over its first 5 steps, its losses over all 12 (measured 9.9e-5), and
#   every step from optax's state.
ITER_RTOL = 5e-5
LOSS_RTOL = 5e-5
STEPSIZE_RTOL = 5e-5
ONE_STEP_RTOL = 5e-5
FIXED_FREE_STEPS = 5
FIXED_ITER_RTOL = 1e-4
FIXED_LOSS_RTOL = 5e-4


def _inputs():
    t = np.arange(SR) / SR
    content = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    style = (0.5 * np.random.default_rng(0).standard_normal(SR)).astype(np.float32)
    return content, style


def _jax_run(learning_rate):
    """The JAX package's optimisation, step by step: its ``style_transfer_
    spec`` loop with optax's state kept (the final iterate is checked equal
    to the function's).  Returns (content spec, style spec, extractor,
    [(spec, loss, stepsize, line-search steps, optax state before)])."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddsp_tpu.experiments import style_transfer as jst

    conf = jst.StyleTransferConfig(**SMALL, learning_rate=learning_rate)
    content, style = _inputs()
    cs = jst.log_spectrogram(jnp.asarray(content), conf)
    ss = jst.log_spectrogram(jnp.asarray(style), conf)
    t = min(cs.shape[1], ss.shape[1])
    cs, ss = cs[:, :t], ss[:, :t]
    ext = jst.extractor_init(jax.random.PRNGKey(0), cs.shape[0], conf)
    c_t = jst.extract_features(ext, cs)
    s_t = jst.gram_matrix(jst.extract_features(ext, ss))

    def losses(spec):
        f = jst.extract_features(ext, spec)
        c = jnp.mean((f - c_t) ** 2)
        s = jnp.mean((jst.gram_matrix(f) - s_t) ** 2)
        return conf.content_weight * c + conf.style_weight * s

    opt = (optax.lbfgs(learning_rate=learning_rate, linesearch=None) if learning_rate > 0
           else optax.lbfgs())

    @jax.jit
    def step(spec, state):
        loss, g = jax.value_and_grad(losses)(spec)
        updates, state = opt.update(g, state, spec, value=loss, grad=g, value_fn=losses)
        return optax.apply_updates(spec, updates), state, loss

    spec, state, traj = cs, opt.init(cs), []
    for _ in range(N_STEPS):
        before = state
        spec, state, loss = step(spec, state)
        ls = state[-1] if learning_rate == 0 else None
        traj.append((np.array(spec), float(loss),
                     float(ls.learning_rate) if ls is not None else None,
                     int(ls.info.num_linesearch_steps) if ls is not None else None, before))
    final, _ = jst.style_transfer_spec(cs, ss, conf)
    assert np.array_equal(np.asarray(final), traj[-1][0])
    return np.array(cs), np.array(ss), jax.tree.map(np.asarray, ext), traj


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["linesearch", "fixed_lr"])
def jax_run(request):
    return request.param, _jax_run(request.param)


def test_lbfgs_trajectory_matches_optax(jax_run):
    """12 free-running steps of the port's style_transfer_steps on JAX's
    extractor against the JAX package's loop under optax."""
    lr, (cs, ss, ext, traj) = jax_run
    conf = tst.StyleTransferConfig(**SMALL, learning_rate=lr)
    steps = list(tst.style_transfer_steps(cs, ss, conf, device="cpu",
                                          extractor=extractor_from_jax(ext)))
    assert len(steps) == N_STEPS
    for i, (step, (jspec, jloss, jlr, jn, _)) in enumerate(zip(steps, traj)):
        disp = np.linalg.norm(jspec - cs)
        err = np.linalg.norm(step.spec.numpy() - jspec) / disp
        loss_err = abs(float(step.loss) - jloss) / abs(jloss)
        if lr == 0:
            assert err <= ITER_RTOL, (i, err)
            assert loss_err <= LOSS_RTOL, (i, loss_err)
            assert abs(step.state.learning_rate - jlr) <= STEPSIZE_RTOL * jlr, (
                i, step.state.learning_rate, jlr)
            assert step.state.info.num_linesearch_steps == jn, (i, step.state.info, jn)
            # one evaluation a trial point, the accepted one reused
            assert step.state.evaluations == jn + (i == 0)
        else:
            assert err <= FIXED_ITER_RTOL or i >= FIXED_FREE_STEPS, (i, err)
            assert loss_err <= FIXED_LOSS_RTOL, (i, loss_err)
            assert step.state.learning_rate == np.float32(lr) and step.state.evaluations == 1


def test_lbfgs_one_step_from_optax_state(jax_run):
    """Each of the 12 steps again from optax's own state (its ring, count and
    last point): the port's step against optax's."""
    lr, (cs, ss, ext, traj) = jax_run
    conf = tst.StyleTransferConfig(**SMALL, learning_rate=lr)
    vg = tst.make_value_and_grad(extractor_from_jax(ext), torch.from_numpy(cs),
                                 torch.from_numpy(ss), conf)
    opt = LBFGS(lr if lr > 0 else None)
    start = cs
    for i, (jspec, jloss, jlr, jn, before) in enumerate(traj):
        ring = before[0]
        state = LBFGSState(
            int(ring.count), *[torch.from_numpy(np.array(getattr(ring, f))) for f in (
                "params", "updates", "diff_params_memory", "diff_updates_memory",
                "weights_memory")],
            learning_rate=np.float32(1.0), value=None, grad=None, aux=None,
            info=LinesearchInfo(0, np.float32(np.inf), np.float32(np.inf)), evaluations=0)
        new, state, loss, _ = opt.step(torch.from_numpy(start), state, vg)
        err = np.linalg.norm(new.numpy() - jspec) / np.linalg.norm(jspec - start)
        assert err <= ONE_STEP_RTOL, (i, err)
        assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
        assert int(state.count) == int(ring.count) + 1
        if lr == 0:
            assert state.info.num_linesearch_steps == jn
            assert abs(state.learning_rate - jlr) <= STEPSIZE_RTOL * jlr
        start = jspec


def test_style_transfer_spec_matches_jax_function():
    """The port's style_transfer_spec with its own extractor draw (the key
    PRNGKey(0), as the JAX function's) against the JAX function."""
    import jax.numpy as jnp

    from ddsp_tpu.experiments import style_transfer as jst

    content, style = _inputs()
    jconf, conf = jst.StyleTransferConfig(**SMALL), tst.StyleTransferConfig(**SMALL)
    cs, ss = (jst.log_spectrogram(jnp.asarray(a), jconf) for a in (content, style))
    jspec, jm = jst.style_transfer_spec(cs, ss, jconf)
    spec, m = tst.style_transfer_spec(np.array(cs), np.array(ss), conf, device="cpu")
    err = np.linalg.norm(spec.numpy() - np.asarray(jspec)) / np.linalg.norm(
        np.asarray(jspec) - np.asarray(cs))
    assert err <= ITER_RTOL, err
    for k in ("loss", "content", "style"):
        assert abs(m[k] - jm[k]) <= LOSS_RTOL * abs(jm[k]), (k, m[k], jm[k])
    # the optimisation moves toward the style (the JAX package's own check)
    g0 = tst.gram_matrix(tst.extract_features(
        tst.extractor_init(tst.PRNGKey(0), cs.shape[0], conf), torch.from_numpy(np.array(cs))))
    gs = tst.gram_matrix(tst.extract_features(
        tst.extractor_init(tst.PRNGKey(0), cs.shape[0], conf), torch.from_numpy(np.array(ss))))
    assert m["style"] < 0.5 * float(torch.mean((g0 - gs) ** 2))


def test_style_transfer_audio_and_cli_match_jax(tmp_path, monkeypatch, capsys):
    """End to end at the JAX test's size (12 steps, 8 Griffin-Lim
    iterations): the metrics within LOSS_RTOL, the output's spectral
    convergence against JAX's output's magnitudes; then the CLI on WAVs
    written by the port, on a config of the same size."""
    import jax.numpy as jnp

    from ddsp_tpu.experiments import style_transfer as jst

    content, style = _inputs()
    jout, jm = jst.style_transfer_audio(jnp.asarray(content), jnp.asarray(style),
                                        jst.StyleTransferConfig(**SMALL))
    out, m = tst.style_transfer_audio(content, style, tst.StyleTransferConfig(**SMALL),
                                      device="cpu")
    assert out.shape == jout.shape and np.isfinite(out).all()
    for k in ("loss", "content", "style"):
        assert abs(m[k] - jm[k]) <= LOSS_RTOL * abs(jm[k]), (k, m[k], jm[k])
    re, im = tst.stft_pair(torch.from_numpy(np.array(jout)), 512, 128)
    jmag = torch.sqrt(re**2 + im**2)
    assert spectral_convergence(torch.from_numpy(out), jmag, 512, 128) < 1e-3

    paths = [str(tmp_path / f) for f in ("content.wav", "style.wav", "out.wav")]
    write_wav(paths[0], content, SR)
    write_wav(paths[1], style, SR)
    base = tst.StyleTransferConfig
    monkeypatch.setattr(tst, "StyleTransferConfig",
                        lambda **kw: base(**{**SMALL, "gl_iters": 4, **kw}))
    tst.main(paths + ["3", "--device=cpu"])
    assert "done:" in capsys.readouterr().out
    y, sr = read_wav(paths[2])
    assert sr == SR and y.shape == (1, (SR // 128) * 128) and 0.0 < np.abs(y).max() <= 0.9


def test_style_transfer_cli_ignores_the_style_rate_as_jax_does(tmp_path, monkeypatch, capsys):
    """The JAX CLI reads the style WAV's rate and never uses it
    (ddsp_tpu/experiments/style_transfer.py:188, ROADMAP section 3); the port
    keeps that: the same style samples labelled 8 kHz and 16 kHz give the
    same output file, byte for byte."""
    content, style = _inputs()
    base = tst.StyleTransferConfig
    monkeypatch.setattr(tst, "StyleTransferConfig",
                        lambda **kw: base(**{**SMALL, "gl_iters": 4, **kw}))
    write_wav(str(tmp_path / "content.wav"), content, SR)
    outs = []
    for style_sr in (SR, 2 * SR):
        style_path, out_path = tmp_path / f"style{style_sr}.wav", tmp_path / f"out{style_sr}.wav"
        write_wav(str(style_path), style, style_sr)
        tst.main([str(tmp_path / "content.wav"), str(style_path), str(out_path), "2",
                  "--device=cpu"])
        outs.append(out_path.read_bytes())
    assert "done:" in capsys.readouterr().out
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_style_transfer_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    content, style = _inputs()
    conf = tst.StyleTransferConfig(**{**SMALL, "n_steps": 4})
    cs, ss = (tst.log_spectrogram(torch.from_numpy(a), conf) for a in (content, style))
    cpu = list(tst.style_transfer_steps(cs, ss, conf, device="cpu"))
    card = list(tst.style_transfer_steps(cs, ss, conf, device="cuda"))
    for a, b in zip(cpu, card):
        disp = torch.linalg.vector_norm(a.spec - cs)
        assert torch.linalg.vector_norm(b.spec.cpu() - a.spec) <= ITER_RTOL * disp
        assert b.state.info.num_linesearch_steps == a.state.info.num_linesearch_steps
        assert abs(b.state.learning_rate - a.state.learning_rate) <= (
            STEPSIZE_RTOL * a.state.learning_rate)
