"""Streaming reverb and the designed noise FIR against ddsp_tpu, on CPU.

Tolerance atol 1e-5: float32 FFTs (pocketfft here, the JAX package's DFT
matmuls there) round in a different order; the partition sums add 3
products per bin.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from ddsp_tpu.config import Config as JaxConfig
from ddsp_tpu.models.synths import reverb_init as jax_reverb_init
from ddsp_tpu.models.synths import reverb_live as jax_reverb_live
from ddsp_tpu.models.synths import reverb_live_init as jax_reverb_live_init
from ddsp_tpu.ops.fir import convolve_designed_fir as jax_convolve_designed_fir
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.synths import (
    Reverb,
    reverb_impulse,
    reverb_ir_spectra,
    reverb_live,
    reverb_live_init,
)
from ddsp_tpu_torch.ops.fir import convolve_designed_fir

SMALL = dict(sample_rate=4000, hop_length=64, reverb_length=300)


def _reverb_from_jax(params, conf):
    model = Reverb(conf)
    with torch.no_grad():
        for name in ("noise", "decay", "wet"):
            getattr(model, name).copy_(torch.from_numpy(np.array(params[name])))
    return model


def test_reverb_live_matches_jax_over_blocks():
    jconf, conf = JaxConfig(**SMALL), Config(**SMALL)
    params = jax_reverb_init(jax.random.PRNGKey(4), jconf, initial_wet=1.5,
                             initial_decay=2.0)
    model = _reverb_from_jax(params, conf)
    block, batch = conf.hop_length, 3
    rng = np.random.default_rng(0)
    js = jax_reverb_live_init(jconf, batch, block)
    ts = reverb_live_init(conf, batch, block)
    with torch.no_grad():
        spec = reverb_ir_spectra(model, conf, block)
        for _ in range(6):  # 6 blocks > the 5 partitions of a 300-tap IR
            x = rng.uniform(-1, 1, (batch, block)).astype(np.float32)
            want, js = jax_reverb_live(params, js, jnp.asarray(x), jconf)
            got, ts = reverb_live(model, ts, torch.from_numpy(x), conf, ir_spec=spec)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_reverb_live_equals_offline_convolution():
    """Block output == causal convolution with the whole IR (float64 numpy)."""
    conf = Config(**SMALL)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = Reverb(conf, initial_wet=1.0, initial_decay=1.0)
    block, n_blocks = conf.hop_length, 7
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, block * n_blocks)).astype(np.float32)
    state = reverb_live_init(conf, 1, block)
    outs = []
    with torch.no_grad():
        ir = reverb_impulse(model, conf).numpy().astype(np.float64)
        for i in range(n_blocks):
            y, state = reverb_live(model, state, torch.from_numpy(x[:, i * block:(i + 1) * block]), conf)
            outs.append(y.numpy())
    want = np.convolve(x[0].astype(np.float64), ir)[: block * n_blocks]
    np.testing.assert_allclose(np.concatenate(outs, -1)[0], want, rtol=0, atol=1e-5)


def test_convolve_designed_fir_matches_jax():
    rng = np.random.default_rng(2)
    mags = rng.uniform(0, 1, (2, 5, 65)).astype(np.float32)
    frames = rng.uniform(-1, 1, (2, 5, 512)).astype(np.float32)
    want = np.asarray(jax_convolve_designed_fir(jnp.asarray(mags), jnp.asarray(frames)))
    got = convolve_designed_fir(torch.from_numpy(mags), torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 5 * 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
