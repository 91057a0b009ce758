"""ddsp_tpu_torch's threefry keys and frame noise against jax's, bit for bit.

Noise that equals the JAX package's word for word is what lets a port
stream reproduce a ddsp_tpu stream (and an offline render) exactly, so
every comparison here is exact equality, not a tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ddsp_tpu.ops.fir import frame_noise as jax_frame_noise
from ddsp_tpu.runtime.multistream import _slot_noise as jax_slot_noise
from ddsp_tpu_torch.ops import fir
from ddsp_tpu_torch.runtime.multistream import _slot_noise, _slot_row_keys


def _key(seed):
    return fir.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_prngkey_is_zero_then_seed(seed):
    np.testing.assert_array_equal(_key(seed).numpy(), [0, seed])
    np.testing.assert_array_equal(
        _key(seed).numpy(), np.asarray(jax.random.PRNGKey(seed), np.int64)
    )


@pytest.mark.parametrize("size", [2, 7, 64])
def test_threefry_2x32_bit_equal(size):
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(size)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    count = rng.integers(0, 2**32, size, dtype=np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    got = fir.threefry_2x32(
        torch.from_numpy(key.astype(np.int64)), torch.from_numpy(count.astype(np.int64))
    )
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("data", [0, 1, 255, 2**31 + 3])
def test_fold_in_bit_equal(data):
    key = _key(42)
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(42), data), np.int64)
    np.testing.assert_array_equal(fir.fold_in(key, data).numpy(), want)
    # the definition: fold_in(k, d) == threefry_2x32(k, [0, d])
    np.testing.assert_array_equal(
        fir.fold_in(key, data).numpy(),
        fir.threefry_2x32(key, torch.tensor([0, data], dtype=torch.int64)).numpy(),
    )


@pytest.mark.parametrize("offset", [0, 3, 40000])
def test_frame_noise_bit_equal(offset):
    want = np.asarray(
        jax_frame_noise(jax.random.PRNGKey(5), 3, 4, 64, frame_offset=offset)
    )
    got = fir.frame_noise(_key(5), 3, 4, 64, frame_offset=offset).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() < 1.0


def test_slot_noise_bit_equal_to_jax_and_to_lone_streams():
    """Slot i's noise == JAX's _slot_noise == frame_noise of a lone stream
    keyed fold_in(key, i), at per-slot absolute frames."""
    offsets = np.array([0, 5, 17, 1000], np.int64)
    key = _key(9)
    got = _slot_noise(
        _slot_row_keys(key, 4), torch.from_numpy(offsets), 64, torch.float32
    ).numpy()
    want = np.asarray(
        jax_slot_noise(jax.random.PRNGKey(9), jnp.asarray(offsets, jnp.int32),
                       64, jnp.float32)
    )
    np.testing.assert_array_equal(got, want)
    for i, off in enumerate(offsets):
        lone = fir.frame_noise(fir.fold_in(key, i), 1, 1, 64, int(off))
        np.testing.assert_array_equal(got[i], lone[0].numpy())
