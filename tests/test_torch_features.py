"""Feature front end of ddsp_tpu_torch against ddsp_tpu, on CPU.

Tolerances: resampling and loudness at atol 1e-5 (float32 convolution and
FFT rounding in another summation order); CREPE probabilities at atol 1e-5
with the argmax pitch bins equal, since a bin is what the controller sees.
The port runs CREPE's torch-shaped NCH stack, the JAX package its default
channels-last 'nlc' stack: the same math.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ddsp_tpu.models import crepe as jax_crepe
from ddsp_tpu.ops.resample import resample as jax_resample
from ddsp_tpu.ops.spectral import a_weighted_loudness as jax_loudness
from ddsp_tpu_torch.models import crepe
from ddsp_tpu_torch.models.convert import crepe_from_jax
from ddsp_tpu_torch.ops.resample import resample
from ddsp_tpu_torch.ops.spectral import a_weighted_loudness


def _audio(shape, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / sr
    f = rng.uniform(100, 800, shape[:-1] + (1,))
    x = 0.5 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("orig,new,length", [(44100, 16000, 2887), (4000, 16000, 320)])
def test_resample_matches_jax(orig, new, length):
    x = _audio((3, length), orig, seed=length)
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    got = resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_a_weighted_loudness_matches_jax():
    x = _audio((4, 2048 + 3 * 512), 44100, seed=3)
    want = np.asarray(jax_loudness(jnp.asarray(x), 2048, 512, 44100))
    got = a_weighted_loudness(torch.from_numpy(x), 2048, 512, 44100).numpy()
    assert got.shape == want.shape == (4, 4, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_crepe_params():
    return jax_crepe.crepe_init(jax.random.PRNGKey(3), "tiny")


def test_crepe_forward_matches_jax_nlc(jax_crepe_params):
    frames = _audio((6, 1024), 16000, seed=11)
    frames = (frames - frames.mean(-1, keepdims=True)) / frames.std(-1, keepdims=True)
    want = np.asarray(
        jax_crepe.crepe_forward(jax_crepe_params, jnp.asarray(frames), layout="nlc")
    )
    model = crepe_from_jax(jax.tree_util.tree_map(np.asarray, jax_crepe_params))
    with torch.no_grad():
        got = crepe.crepe_forward(model, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wf, _, wc = jax_crepe.pitch_argmax(jnp.asarray(want))
    gf, _, gc = crepe.pitch_argmax(got)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-6)


def test_load_torch_checkpoint_reads_reference_layout(tmp_path, jax_crepe_params):
    """A reference-layout .pth (convN weights (O, I, k, 1), convN_BN running
    stats, classifier) written from crepe_init weights loads to the same
    network."""
    def t(x):
        return torch.from_numpy(np.array(x))

    sd = {}
    for i, layer in enumerate(jax_crepe_params["layers"], start=1):
        sd[f"conv{i}.weight"] = t(np.asarray(layer["weight"])[..., None])
        sd[f"conv{i}.bias"] = t(layer["bias"])
        for ours, ref in (("weight", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"conv{i}_BN.{ref}"] = t(layer["bn"][ours])
    sd["classifier.weight"] = t(jax_crepe_params["classifier"]["weight"])
    sd["classifier.bias"] = t(jax_crepe_params["classifier"]["bias"])
    path = tmp_path / "tiny.pth"
    torch.save(sd, path)

    model = crepe.load_torch_checkpoint(str(path))
    frames = torch.from_numpy(_audio((2, 1024), 16000, seed=5))
    with torch.no_grad():
        want = crepe.crepe_forward(
            crepe_from_jax(jax.tree_util.tree_map(np.asarray, jax_crepe_params)), frames
        )
        np.testing.assert_array_equal(
            crepe.crepe_forward(model, frames).numpy(), want.numpy()
        )
    del sd["classifier.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="classifier.bias"):
        crepe.load_torch_checkpoint(str(path))
