"""The finetune slice of ddsp_tpu_torch against ddsp_tpu, on CPU, and the
finetune contracts of tests/test_training.py:414-462, on the port.

The three-step comparisons are in tests/test_torch_finetune_steps.py.
The JAX side's parameters are carried over with ``crepe_from_jax`` /
``autoencoder_from_jax``, its BatchNorm statistics become optimised
leaves (``make_statistics_trainable``), and both packages get the same
numpy audio and key.  Tolerances, each with its reason:

* the pitch decodes: float32 noise (the weighted sum of 9 bins in another
  order), rtol 2e-6, with normalized cents also within 2e-7 absolute
  (``cents - cents_map(0)`` cancels near the lowest bin); their gradients
  rtol 1e-5 and within 5e-5 of the largest: the gradient's factor
  ``cents_i - cents`` (at most 80 cents) cancels two values of 2,000 to
  9,200 cents, so the few float32 ulps (up to 9.8e-4) by which the two
  packages' weighted sums differ show in it at ~1e-5 of the largest.
* ``f0_encoder_apply(freeze_crepe=False)``: probabilities within 1e-6, f0
  within 1e-5 relative (two float32 convolution stacks in other layouts);
  every CREPE gradient, BatchNorm statistics included, within 1e-3 of its
  leaf's largest entry (float32 sums over the 1024-sample windows).
* ``loss_fn_e2e``: 1e-4 relative, the train step's criterion
  (test_torch_training.py).
* three finetune steps in float32 (JAX pinned to its float32 loss and
  reverb paths, ``osc_impl='xla'``): the train-step criterion of
  test_torch_training.py, loss within 1e-4 relative, grad_norm within
  1e-3, parameters at allclose(rtol=2e-3, atol=3e-3) through
  ``autoencoder_to_jax``.
  Measured at this seed: loss 6.4e-6, grad_norm 1.5e-5, parameters 0.93
  of the criterion.
* three finetune steps on the bf16 kernel route (``set_stft_impl
  ('pallas')`` on both sides, JAX's K3/K4 in the Pallas interpreter):
  loss within 1e-4 relative and grad_norm within 1e-3, as in float32
  (measured 7.0e-6 and 1.1e-4); the first step's gradients, from equal
  parameters, leaf by leaf within the bf16 criterion of
  tests/test_pallas_stft.py:52-58, max |diff| <= 5e-3 of the leaf's
  largest and cosine > 0.9999 (measured 3.9e-3 and 0.9999981: K4's casts
  round float32 values that differ in their last bits); parameters at
  rtol 2e-3 and atol 3e-3 after the first step, 2e-3 more for each step
  after it (measured 0.66, 0.72 and 0.69 of that).  The widening is
  Adam's: a step moves a parameter by about lr (1e-3) in the sign of its
  gradient, so an entry whose gradient is float noise (1e-7 of its
  leaf's largest) can step the other way in the other package, 2e-3 of
  drift a step; the bf16 casts make more such entries than float32 does.
  Later steps' gradients are not compared leaf by leaf: CREPE's reach the
  loss through f0 and the oscillator's phase sum, whose cancellation
  leaves some leaves 1e-2 apart in float32 as well once the parameters
  have moved.

Random CREPE weights leave near-ties between pitch bins, and an argmax
that falls differently in the two packages moves f0 by 20 cents or more,
which is no fault; the step test checks that every step's argmax centres
are equal.  Seeds 3 (used), 9 and 14 keep them equal through three steps
in both runs; 4, 6, 8, 10 and 11 do not.
"""

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.autoencoder import autoencoder_apply
from ddsp_tpu_torch.models.convert import autoencoder_from_jax, crepe_from_jax
from ddsp_tpu_torch.models.crepe import (
    make_statistics_trainable,
    pitch_centered_ref,
    pitch_weighted,
)
from ddsp_tpu_torch.models.encoder import f0_encoder_apply
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.training import trainer

TINY = dict(
    sample_rate=4000, n_fft=256, hop_length=64, example_duration=0.5,
    n_harmonics=16, n_noise_filters=17, decoder_mlp_units=32,
    decoder_mlp_layers=1, decoder_gru_units=32, batch_size=4,
    mss_ffts=(256, 128, 64), checkpoint_every=0, log_every=5,
    pitch_decode="weighted", reverb_length=1024,
)
# the JAX side pinned to its float32 reverb gradient and XLA oscillator
PINNED = dict(reverb_grad_matmul_dtype="float32", osc_impl="xla")
SEED = 3
CONF = Config(**TINY)


def _tones(conf, n, seed):
    """(n, example_length) three-partial tones at 150-400 Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(conf.example_length) / conf.sample_rate
    return np.stack([
        sum((0.5 / k) * np.sin(2 * np.pi * f * k * t + rng.uniform(0, 6)) for k in range(1, 4))
        for f in rng.uniform(150, 400, n)
    ]).astype(np.float32)


def _confs(loss_dtype):
    from ddsp_tpu.config import Config as JaxConfig

    return (JaxConfig(**TINY, **PINNED, loss_matmul_dtype=loss_dtype),
            CONF.replace(loss_matmul_dtype=loss_dtype))


def _probabilities(rng):
    """(3, 12, 360) sigmoid-like values with argmaxes at and near both
    edges, where the 9-bin window is zero-padded."""
    probs = rng.uniform(0.0, 0.5, (3, 12, 360)).astype(np.float32)
    for i, b in enumerate((0, 1, 3, 4, 355, 356, 358, 359)):
        probs[0, i, b] = 0.9
    return probs


@pytest.mark.parametrize("name", ["pitch_weighted", "pitch_centered_ref"])
def test_pitch_decodes_match_jax(name):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.models import crepe as jax_crepe

    probs = _probabilities(np.random.default_rng(0))
    ours = {"pitch_weighted": pitch_weighted, "pitch_centered_ref": pitch_centered_ref}[name]
    want, vjp = jax.vjp(getattr(jax_crepe, name), jnp.asarray(probs))
    tp = torch.from_numpy(probs).requires_grad_(True)
    got = ours(tp)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=2e-6, atol=2e-7)
    cot = [np.random.default_rng(i).standard_normal(np.shape(a)).astype(np.float32)
           for i, a in enumerate(want)]
    (want_g,) = vjp(tuple(jnp.asarray(c) for c in cot))
    (got_g,) = torch.autograd.grad(got, [tp], [torch.from_numpy(c) for c in cot])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=5e-5 * np.abs(want_g).max())


def test_f0_encoder_unfrozen_matches_jax_with_crepe_gradients():
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models import crepe as jax_crepe
    from ddsp_tpu.models import encoder as jax_encoder
    from ddsp_tpu.models.autoencoder import feature_pad

    jconf = JaxConfig(**TINY)
    jparams = jax_crepe.crepe_init(jax.random.PRNGKey(SEED), "tiny")
    audio = np.array(feature_pad(jnp.asarray(_tones(CONF, 2, SEED)), jconf))
    cot = {k: np.random.default_rng(i).standard_normal((2, CONF.frames_per_example, 1))
           .astype(np.float32) for i, k in enumerate(("f0", "normalized_cents", "harmonicity"))}

    def jax_loss(p):
        out = jax_encoder.f0_encoder_apply(p, jnp.asarray(audio), jconf, freeze_crepe=False)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    crepe = make_statistics_trainable(crepe_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    got = f0_encoder_apply(crepe, torch.from_numpy(audio), CONF, freeze_crepe=False)
    np.testing.assert_allclose(got["probabilities"].detach().numpy(),
                               np.asarray(want["probabilities"]), atol=1e-6)
    np.testing.assert_allclose(got["f0"].detach().numpy(), np.asarray(want["f0"]), rtol=1e-5)
    loss = sum((got[k] * torch.from_numpy(cot[k])).sum() for k in cot)
    names, leaves = zip(*crepe.named_parameters())
    assert sum("running_" in n for n in names) == 12  # mean and var of six BatchNorms
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    # the JAX gradient tree in the port's layout: crepe_to_jax of the grads
    want_tree = jax.tree_util.tree_map(np.asarray, want_g)
    for i, layer in enumerate(want_tree["layers"], start=1):
        pairs = {f"conv{i}.weight": layer["weight"], f"conv{i}.bias": layer["bias"],
                 f"conv{i}_BN.weight": layer["bn"]["weight"], f"conv{i}_BN.bias": layer["bn"]["bias"],
                 f"conv{i}_BN.running_mean": layer["bn"]["mean"],
                 f"conv{i}_BN.running_var": layer["bn"]["var"]}
        for name, w in pairs.items():
            np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                       atol=1e-3 * max(np.abs(w).max(), 1e-30), err_msg=name)
    for leaf in ("weight", "bias"):
        w = want_tree["classifier"][leaf]
        np.testing.assert_allclose(grads[f"classifier.{leaf}"].numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
    assert float(grads["conv1_BN.running_var"].abs().max()) > 0.0


def _jax_finetune_state(jconf):
    import jax

    from ddsp_tpu.training import trainer as jax_trainer

    jstate = jax_trainer.init_finetune_state(jax.random.PRNGKey(SEED), jconf)
    params = autoencoder_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), CONF)
    make_statistics_trainable(params["crepe"])
    state = trainer.TrainState(
        0, params, trainer.make_optimizer(CONF).init(list(params.parameters())),
        torch.from_numpy(np.asarray(jstate.rng).astype(np.int64)),
    )
    return jstate, state


def test_loss_fn_e2e_matches_jax():
    import jax

    from ddsp_tpu.training import trainer as jax_trainer

    jconf, conf = _confs("float32")
    jstate, state = _jax_finetune_state(jconf)
    audio = _tones(conf, 2, SEED)
    want_loss, want = jax.jit(lambda p: jax_trainer.loss_fn_e2e(
        p, {"audio": audio}, jconf, jax.random.PRNGKey(5)))(jstate.params)
    with torch.no_grad():
        loss, got = trainer.loss_fn_e2e(state.params, {"audio": torch.from_numpy(audio)},
                                        conf, PRNGKey(5))
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)


def test_finetune_gradients_flow_into_crepe():
    """With the weighted decode CREPE (BatchNorm statistics included) and
    the decoder receive nonzero gradient; with ``freeze_crepe`` CREPE
    receives exactly zero; one finetune step is finite."""
    conf = CONF.replace(mss_ffts=(256, 128))
    state = trainer.init_finetune_state(PRNGKey(0), conf, device="cpu")
    batch = {"audio": torch.from_numpy(_tones(conf, 4, 0))}
    params = state.params
    names, leaves = zip(*params.named_parameters())
    loss, _ = trainer.loss_fn_e2e(params, batch, conf, PRNGKey(1))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves, allow_unused=True)))

    def norm(prefix):
        return float(torch.sqrt(sum((g * g).sum() for n, g in grads.items()
                                    if n.startswith(prefix) and g is not None)))

    assert np.isfinite(norm("crepe.")) and norm("crepe.") > 0.0
    assert np.isfinite(norm("decoder.")) and norm("decoder.") > 0.0
    assert norm("crepe.conv3_BN.running_mean") > 0.0

    pred = autoencoder_apply(params, batch["audio"], conf, PRNGKey(1), freeze_crepe=True)
    crepe_leaves = [p for n, p in params.named_parameters() if n.startswith("crepe.")]
    frozen = torch.autograd.grad((pred**2).sum(), crepe_leaves, allow_unused=True)
    assert all(g is None or float(g.abs().max()) == 0.0 for g in frozen)

    state, metrics = trainer.make_finetune_step(conf)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert state.step == 1


def test_finetune_requires_differentiable_decode():
    with pytest.raises(ValueError, match="differentiable"):
        trainer.make_finetune_step(CONF.replace(pitch_decode="argmax"))


def test_finetune_loop_leaves_the_callers_modules_alone(tmp_path):
    from ddsp_tpu_torch.models.autoencoder import autoencoder_init

    params = autoencoder_init(PRNGKey(2), CONF)
    before = {k: v.clone() for k, v in params.state_dict().items()}
    state, metrics = trainer.finetune(
        CONF, _tones(CONF, 5, 1), 3, params["decoder"], params["crepe"],
        log_path=str(tmp_path / "ft.jsonl"), device="cpu",
    )
    assert state.step == 3 and np.isfinite(metrics["loss"])
    assert sum(1 for _ in open(tmp_path / "ft.jsonl")) == 1  # log_every 5: the last step
    for k, v in params.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(state.params["crepe"].conv1.weight, before["crepe.conv1.weight"])
    with pytest.raises(ValueError, match="no full batch"):
        trainer.finetune(CONF, _tones(CONF, 3, 1), 1, params["decoder"], params["crepe"],
                         device="cpu")
