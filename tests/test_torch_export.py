"""torch_export: round trip with torch_import, strict load into the
reference Decoder, and the Lightning .ckpt wrapping.

The docstring of models/torch_export.py claims import(export(p)) == p and
strict=True reference loads; these tests pin that claim (ADVICE round 1:
the export path shipped with zero coverage).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import types
import warnings

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from ddsp_tpu.config import Config
from ddsp_tpu.models.controller import decoder_init
from ddsp_tpu.models.torch_export import (
    save_torch_decoder,
    state_dict_from_decoder_params,
)
from ddsp_tpu.models.torch_import import (
    decoder_params_from_state_dict,
    load_lightning_decoder,
)

CONF = Config(
    sample_rate=16000,
    n_fft=512,
    hop_length=128,
    n_harmonics=64,
    n_noise_filters=33,
    decoder_mlp_units=64,
    decoder_mlp_layers=2,
    decoder_gru_units=64,
)


def _assert_tree_equal(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_export_import_roundtrip_bit_exact():
    """import(export(p)) == p: the export is a pure re-keying."""
    params = decoder_init(jax.random.PRNGKey(0), CONF)
    sd = state_dict_from_decoder_params(params, CONF)
    back = decoder_params_from_state_dict(sd, CONF)
    _assert_tree_equal(params, back)


def test_lightning_ckpt_roundtrip(tmp_path):
    """save_torch_decoder(lightning=True) loads back via both our
    load_lightning_decoder and the reference's key layout."""
    params = decoder_init(jax.random.PRNGKey(1), CONF)
    path = str(tmp_path / "export.ckpt")
    save_torch_decoder(params, CONF, path, lightning=True, step=7)
    blob = torch.load(path, weights_only=False)
    assert blob["epoch"] == 7
    assert all(k.startswith("model.") for k in blob["state_dict"])
    back = load_lightning_decoder(path, CONF)
    _assert_tree_equal(params, back)


def test_reference_decoder_strict_load(reference_path):
    """The exported state dict must strict=True load into the reference
    Decoder (reference model/autoencoder/decoder.py:119-135) -- every
    registered key present, every shape right."""
    from model.autoencoder.decoder import Decoder

    tconf = types.SimpleNamespace(
        decoder_mlp_units=CONF.decoder_mlp_units,
        decoder_mlp_layers=CONF.decoder_mlp_layers,
        decoder_gru_units=CONF.decoder_gru_units,
        decoder_gru_layers=CONF.decoder_gru_layers,
        n_harmonics=CONF.n_harmonics,
        n_noise_filters=CONF.n_noise_filters,
        sample_rate=CONF.sample_rate,
        hop_length=CONF.hop_length,
    )
    params = decoder_init(jax.random.PRNGKey(2), CONF)
    sd = state_dict_from_decoder_params(params, CONF)
    dec = Decoder(tconf)
    dec.load_state_dict(sd, strict=True)
    got = dec.state_dict()["controller.dense_harmonic.weight"].numpy()
    np.testing.assert_array_equal(
        got, np.asarray(params["controller"]["dense_harmonic"]["weight"])
    )


def test_nondefault_reverb_length_warns():
    """A reverb IR != sample_rate taps cannot strict-load into the
    reference (its Reverb hardwires 1 s); the export must warn."""
    conf = CONF.replace(reverb_length=1234)
    params = decoder_init(jax.random.PRNGKey(3), conf)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state_dict_from_decoder_params(params, conf)
    assert any("reverb IR length" in str(w.message) for w in caught)
