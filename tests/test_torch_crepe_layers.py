"""CREPE's intermediate outputs in the port (``crepe_embed``,
``crepe_activation``) against the JAX package's on the same seeded weights
and windows, on the CPU.  The JAX package's ``layout`` names its TPU's
channels-last form; both of its layouts are held to the port's (N, C, H)
stack."""

import jax
import numpy as np
import pytest
import torch

from ddsp_tpu.models import crepe as jax_crepe
from ddsp_tpu_torch.models.convert import crepe_from_jax
from ddsp_tpu_torch.models.crepe import crepe_activation, crepe_embed

# relative to the output's largest magnitude; measured up to 2.8e-6
# (float32 convolutions summed in another order)
RTOL_OF_MAX = 1e-5
# bf16 operands, float32 sums: the two packages round the same operands,
# measured 1.2e-7 of the largest magnitude; the float32 embedding is 1.8e-3
# from JAX's bf16 one, so this tells the two apart
BF16_RTOL_OF_MAX = 2e-5


@pytest.fixture(scope="module")
def weights():
    """JAX CREPE tiny from PRNGKey(3), its BatchNorm statistics and affine
    parameters drawn from a seeded numpy generator (the init leaves them at
    0 and 1), and 4 windows of seeded noise plus a tone."""
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(np.asarray, jax_crepe.crepe_init(jax.random.PRNGKey(3)))
    for layer in params["layers"]:
        c = layer["bias"].shape[0]
        layer["bn"] = {
            "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
            "mean": rng.uniform(-0.05, 0.05, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
        }
    t = np.arange(1024) / 16000.0
    frames = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 800, (4, 1))[:, :] * t)
              + 0.05 * rng.standard_normal((4, 1024))).astype(np.float32)
    return params, crepe_from_jax(params), frames


def _close(got, want, rtol_of_max):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol_of_max, err


@pytest.mark.parametrize("layout", ["nlc", "nch"])
def test_crepe_embed_matches_jax(weights, layout):
    params, crepe, frames = weights
    want = jax_crepe.crepe_embed(params, frames, layout=layout)
    with torch.no_grad():
        got = crepe_embed(crepe, torch.from_numpy(frames))
    assert tuple(got.shape) == (4, 32, 8)  # (B, C5, 8) at capacity tiny
    _close(got, want, RTOL_OF_MAX)


def test_crepe_embed_bf16_matches_jax(weights):
    params, crepe, frames = weights
    want = jax.jit(lambda p, f: jax_crepe.crepe_embed(
        p, f, compute_dtype=jax.numpy.bfloat16, layout="nch"))(params, frames)
    with torch.no_grad():
        got = crepe_embed(crepe, torch.from_numpy(frames), compute_dtype=torch.bfloat16)
        control = crepe_embed(crepe, torch.from_numpy(frames))
    _close(got, want, BF16_RTOL_OF_MAX)
    with pytest.raises(AssertionError):
        _close(control, want, 10 * BF16_RTOL_OF_MAX)


@pytest.mark.parametrize("layer_index", range(6))
def test_crepe_activation_matches_jax(weights, layer_index):
    params, crepe, frames = weights
    want = jax_crepe.crepe_activation(params, frames, layer_index)
    with torch.no_grad():
        got = crepe_activation(crepe, torch.from_numpy(frames), layer_index)
    _close(got, want, RTOL_OF_MAX)
    if layer_index == 4:  # the embedding is stage 5's activation
        np.testing.assert_array_equal(got.numpy(), crepe_embed(
            crepe, torch.from_numpy(frames)).detach().numpy())


def test_crepe_activation_rejects_other_layers(weights):
    _, crepe, frames = weights
    with pytest.raises(ValueError, match="0..5"):
        crepe_activation(crepe, torch.from_numpy(frames), 6)
