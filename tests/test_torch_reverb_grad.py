"""The reverb's reduced-precision backward (``reverb_grad_matmul_dtype``)
of the port against ddsp_tpu's, same numpy inputs, on CPU.

The port's bf16 route (``ops/fir.fft_convolve(grad_matmul_dtype=
'bfloat16')``) keeps the float32 forward, computes d/dsignal as the
shared-kernel bf16 convolution of the flipped cotangent (S1's plain
version here) and d/dkernel as a float32 correlation; the JAX package
transposes its bf16-matmul forward for both.  Floors, each with its
reason:

* forward: equal to the float32 route, bit for bit
  (``tests/test_synths.py:130-137`` holds the JAX package to the same);
* gradients >= 40 dB against JAX's bf16 VJP (two independent bf16
  passes: 44.2-48.2 dB measured here) and >= 44 dB against a float64
  oracle (one bf16 pass: d/dsignal 46.8-47.1 dB on the permuted path;
  the float32 d/dkernel and the float32 fallback at n <= 4096, 133-134 dB);
* ``reverb_apply``'s gradients on the same floors against JAX's
  ``reverb_apply`` at bf16 (the scalars decay and wet within 1e-2
  relative: sums over the whole IR);
* one tiny-width train step on the default route against JAX's
  ``make_train_step`` (loss spectrograms pinned to float32 and the XLA
  oscillator on the JAX side, the port's CPU defaults): the loss within
  1e-4 relative, grad_norm within 1e-3, each gradient leaf within 5e-3 of
  its norm (phase 9's bf16 criterion in ``chip_smoke.py``; the worst leaf,
  the IR's noise, measured 2.7e-3, grad_norm 2.6e-4).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import copy

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.convert import decoder_from_jax, decoder_to_jax
from ddsp_tpu_torch.models.synths import Reverb, reverb_apply
from ddsp_tpu_torch.ops.fir import fft_convolve, split
from ddsp_tpu_torch.training import trainer

# (B, L, kernel_len): n = 6144 on the permuted path (packed rows 1 and 2,
# the odd batch padding a zero row), and n = 3072 on the float32 fallback
SHAPES = [(2, 3000, 1200), (3, 3000, 1200), (2, 2000, 500)]


def _snr(ref, est) -> float:
    ref = np.asarray(ref, np.float64)
    return float(10 * np.log10(np.mean(ref**2) / np.mean((ref - np.asarray(est, np.float64)) ** 2)))


def _inputs(b, length, klen, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length)).astype(np.float32)
    h = (0.1 * rng.standard_normal((1, klen))).astype(np.float32)
    g = rng.standard_normal((b, length)).astype(np.float32)
    return x, h, g


def _oracle_grads(x, h, g):
    """Float64 (d/dsignal, d/dkernel) of sum(g * conv(x, h)[:L])."""
    b, length = x.shape
    klen = h.shape[-1]
    n = length + klen - 1
    xs, hs, gs = (np.fft.rfft(a.astype(np.float64), n) for a in (x, h, g))
    dx = np.fft.irfft(gs * np.conj(hs), n)[:, :length]
    dh = np.fft.irfft((gs * np.conj(xs)).sum(0, keepdims=True), n)[:, :klen]
    return dx, dh


def _port_grads(x, h, g, dtype):
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    y = fft_convolve(xt, ht, h.shape[-1], grad_matmul_dtype=dtype)
    dx, dh = torch.autograd.grad(y, [xt, ht], torch.from_numpy(g))
    return y.detach().numpy(), dx.numpy(), dh.numpy()


def test_bf16_route_forward_is_the_float32_forward():
    for b, length, klen in SHAPES:
        x, h, g = _inputs(b, length, klen)
        y_bf, _, _ = _port_grads(x, h, g, "bfloat16")
        y_32, _, _ = _port_grads(x, h, g, "float32")
        np.testing.assert_array_equal(y_bf, y_32)


@pytest.mark.parametrize("b,length,klen", SHAPES)
def test_bf16_gradients_match_jax_vjp(b, length, klen):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.ops.fir import fft_convolve as jax_fft_convolve

    x, h, g = _inputs(b, length, klen)
    _, vjp = jax.vjp(lambda a, k: jax_fft_convolve(a, k, klen, grad_matmul_dtype="bfloat16"),
                     jnp.asarray(x), jnp.asarray(h))
    want_dx, want_dh = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    _, dx, dh = _port_grads(x, h, g, "bfloat16")
    oracle_dx, oracle_dh = _oracle_grads(x, h, g)
    assert dx.shape == x.shape and dh.shape == h.shape
    assert _snr(want_dx, dx) >= 40.0 and _snr(want_dh, dh) >= 40.0
    assert _snr(oracle_dx, dx) >= 44.0 and _snr(oracle_dh, dh) >= 44.0


def _reverb_from_jax(params, conf):
    model = Reverb(conf)
    with torch.no_grad():
        for name in ("noise", "decay", "wet"):
            getattr(model, name).copy_(torch.from_numpy(np.array(params[name])))
    return model


def test_reverb_apply_bf16_gradients_match_jax():
    """``tests/test_synths.py:165-200``'s setting: a 4000-tap IR over
    8192 samples (n = 12,288, (n1, n2) = (128, 96))."""
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models.synths import reverb_apply as jax_reverb_apply
    from ddsp_tpu.models.synths import reverb_init as jax_reverb_init

    jconf = JaxConfig(sample_rate=4000, reverb_grad_matmul_dtype="bfloat16")
    conf = Config(sample_rate=4000, reverb_grad_matmul_dtype="bfloat16")
    x = (0.3 * np.random.default_rng(5).standard_normal((2, 8192))).astype(np.float32)
    params = jax_reverb_init(jax.random.PRNGKey(0), jconf)
    gp, gx = jax.grad(lambda p, a: jnp.mean(jax_reverb_apply(p, a, jconf) ** 2),
                      argnums=(0, 1))(params, jnp.asarray(x))
    model = _reverb_from_jax(params, conf)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = reverb_apply(model, xt, conf).pow(2).mean()
    grads = torch.autograd.grad(loss, [xt, model.noise, model.decay, model.wet])
    assert _snr(np.asarray(gx), grads[0].numpy()) >= 40.0
    assert _snr(np.asarray(gp["noise"]), grads[1].numpy()) >= 40.0
    for name, got in (("decay", grads[2]), ("wet", grads[3])):
        want = float(gp[name])
        assert abs(float(got) - want) <= 1e-2 * abs(want), (name, float(got), want)


TINY = dict(
    sample_rate=4000, n_fft=256, hop_length=64, example_duration=0.5,
    n_harmonics=16, n_noise_filters=17, decoder_mlp_units=32,
    decoder_mlp_layers=1, decoder_gru_units=32, batch_size=4,
    mss_ffts=(256, 128, 64), checkpoint_every=0,
)


def test_default_route_train_step_matches_jax():
    """The default ``reverb_grad_matmul_dtype`` ('bfloat16') on both
    sides: 1,984-sample examples and a 4000-tap IR, so the reverb's
    d/dsignal takes the 6144-point permuted path (S1's plain version)."""
    import jax

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.training import trainer as jax_trainer

    jconf = JaxConfig(**TINY, loss_matmul_dtype="float32", osc_impl="xla")
    conf = Config(**TINY)
    assert jconf.reverb_grad_matmul_dtype == conf.reverb_grad_matmul_dtype == "bfloat16"
    jstate = jax_trainer.init_state(jax.random.PRNGKey(0), jconf)
    rng = np.random.default_rng(0)
    t = conf.frames_per_example
    batch = {"f0": rng.uniform(100, 400, (4, t, 1)).astype(np.float32),
             "normalized_cents": rng.uniform(0, 1, (4, t, 1)).astype(np.float32),
             "loudness": rng.uniform(0, 1, (4, t, 1)).astype(np.float32),
             "audio": (0.1 * rng.standard_normal((4, conf.example_length))).astype(np.float32)}
    _, noise_key = jax.random.split(jstate.rng)
    grad_fn = jax.jit(lambda p, b, k: jax.value_and_grad(jax_trainer.loss_fn, has_aux=True)(
        p, b, jconf, k))
    (jloss, _), jgrads = grad_fn(jstate.params, batch, noise_key)

    decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), conf)
    key = torch.from_numpy(np.asarray(jstate.rng).astype(np.int64))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = trainer.loss_fn(decoder, tbatch, conf, split(key)[1])
    params = list(decoder.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    as_module = copy.deepcopy(decoder)
    with torch.no_grad():
        for p, g in zip(as_module.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    got_tree = decoder_to_jax(as_module)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(leaves) == len(got_leaves)
    for path, want in leaves:
        want = np.asarray(want, np.float64)
        diff = np.linalg.norm(got_leaves[path] - want)
        assert diff <= 5e-3 * np.linalg.norm(want), (jax.tree_util.keystr(path), diff)
    state = trainer.TrainState(0, decoder, trainer.make_optimizer(conf).init(params), key)
    _, metrics = trainer.make_train_step(conf)(state, tbatch)
    want_norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                                  for _, g in leaves)))
    assert abs(float(metrics["grad_norm"]) - want_norm) <= 1e-3 * want_norm
