"""Three finetune steps of ddsp_tpu_torch against ddsp_tpu's
``make_finetune_step``, on CPU, in float32 and on the bf16 STFT kernel
route.  The tolerances, the seed and why each holds are in
tests/test_torch_finetune.py's docstring (this file is separate only so
that the test runner can run it beside that one).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import copy

import numpy as np
import pytest
import torch

from ddsp_tpu_torch.models.autoencoder import encode
from ddsp_tpu_torch.models.convert import autoencoder_to_jax
from ddsp_tpu_torch.ops.fir import split
from ddsp_tpu_torch.ops.spectral import set_stft_impl
from ddsp_tpu_torch.training import trainer

from test_torch_finetune import SEED, _confs, _jax_finetune_state, _tones


def _grad_tree(params, grads):
    """{name: gradient} of ``params`` -> the JAX autoencoder tree."""
    tree = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in tree.named_parameters():
            p.copy_(grads[name])
    return autoencoder_to_jax(tree)


def _first_step_gradients_agree(jstate, state, audio, jconf, conf):
    """The first step's gradients, leaf by leaf, at the bf16 criterion."""
    import jax

    from ddsp_tpu.training import trainer as jax_trainer

    batch = {"audio": audio}
    want = jax.jit(jax.grad(lambda p: jax_trainer.loss_fn_e2e(
        p, batch, jconf, jax.random.split(jstate.rng)[1])[0]))(jstate.params)
    names, leaves = zip(*state.params.named_parameters())
    loss, _ = trainer.loss_fn_e2e(state.params, {"audio": torch.from_numpy(audio)}, conf,
                                  split(state.rng)[1])
    got = _grad_tree(state.params, dict(zip(names, torch.autograd.grad(loss, leaves))))

    def check(path, a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        where = jax.tree_util.keystr(path)
        assert np.abs(b - a).max() <= 5e-3 * np.abs(a).max(), where
        if np.abs(a).max() > 0:
            assert np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9999, where

    jax.tree_util.tree_map_with_path(check, want, got)


@pytest.mark.parametrize("loss_dtype", ["float32", "bfloat16"])
def test_three_finetune_steps_match_jax(loss_dtype):
    import jax
    import jax.numpy as jnp

    from ddsp_tpu.models import autoencoder as jax_autoencoder
    from ddsp_tpu.ops import spectral as jax_spectral
    from ddsp_tpu.training import trainer as jax_trainer

    jconf, conf = _confs(loss_dtype)
    jstate, state = _jax_finetune_state(jconf)
    audio = _tones(conf, conf.batch_size, SEED)
    impl = "pallas" if loss_dtype == "bfloat16" else "auto"
    # atol of the parameters after step i: the train step's in float32,
    # widening by 2 lr a step on the bf16 route (test_torch_finetune.py)
    widen = 2e-3 if loss_dtype == "bfloat16" else 0.0
    jax_spectral.set_stft_impl(impl)
    set_stft_impl(impl)
    try:
        if loss_dtype == "bfloat16":
            _first_step_gradients_agree(jstate, state, audio, jconf, conf)
        jstep = jax.jit(jax_trainer.make_finetune_step(jconf))
        jprobs = jax.jit(lambda p: jax_autoencoder.encode(p, jnp.asarray(audio), jconf)["probabilities"])
        step = trainer.make_finetune_step(conf)
        for i in range(3):
            jstate, jm = jstep(jstate, {"audio": audio})
            state, m = step(state, {"audio": torch.from_numpy(audio)})
            for name, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
                want, got = float(jm[name]), float(m[name])
                assert abs(got - want) <= rtol * abs(want), (i, name, got, want)
            assert state.step == i + 1
            np.testing.assert_array_equal(state.rng.numpy(),
                                          np.asarray(jstate.rng).astype(np.int64))
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(
                    b, np.asarray(a), rtol=2e-3, atol=3e-3 + widen * i),
                jstate.params, autoencoder_to_jax(state.params),
            )
            with torch.no_grad():
                probs = encode(state.params, torch.from_numpy(audio), conf)["probabilities"]
            np.testing.assert_array_equal(probs.argmax(-1).numpy(),
                                          np.asarray(jprobs(jstate.params)).argmax(-1))
    finally:
        jax_spectral.set_stft_impl("auto")
        set_stft_impl("auto")
