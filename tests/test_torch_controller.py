"""ddsp_tpu_torch controller against ddsp_tpu's, from carried-over weights.

Tolerance rtol 1e-4 (atol 1e-6): float32 matmuls and LayerNorm reductions
summed in another order, compounded over three GRU steps.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ddsp_tpu.config import Config as JaxConfig
from ddsp_tpu.models.controller import controller_apply as jax_controller_apply
from ddsp_tpu.models.controller import decoder_init as jax_decoder_init
from ddsp_tpu.models.torch_export import state_dict_from_decoder_params
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import controller_apply, decoder_init, modified_sigmoid
from ddsp_tpu_torch.models.convert import (
    decoder_from_jax,
    decoder_from_state_dict,
    load_lightning_decoder,
)

SMALL = dict(
    n_harmonics=12, n_noise_filters=9, decoder_mlp_units=16,
    decoder_mlp_layers=2, decoder_gru_units=16, reverb_length=300,
)


@pytest.fixture(scope="module")
def jax_params():
    return jax_decoder_init(jax.random.PRNGKey(0), JaxConfig(**SMALL))


def _features(b, t, seed):
    rng = np.random.default_rng(seed)
    return {
        "normalized_cents": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "f0": rng.uniform(80, 600, (b, t, 1)).astype(np.float32),
    }


def test_config_json_round_trip_from_jax_package():
    text = JaxConfig(**SMALL).to_json()
    conf = Config.from_json(text)
    assert conf.to_json() == text
    assert Config().to_json() == JaxConfig().to_json()


def test_controller_matches_jax_over_hops_with_carried_hidden(jax_params):
    conf = Config(**SMALL)
    model = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), conf)
    hidden_j, hidden_t = None, None
    for hop in range(3):  # one frame per hop, hidden carried
        batch = _features(4, 1, seed=hop)
        want, hidden_j = jax_controller_apply(
            jax_params["controller"], {k: jnp.asarray(v) for k, v in batch.items()},
            hidden=hidden_j,
        )
        with torch.no_grad():
            got, hidden_t = controller_apply(
                model.controller, {k: torch.from_numpy(v) for k, v in batch.items()},
                hidden=hidden_t,
            )
        for k in ("c", "a", "H"):
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-6, err_msg=k
            )
        np.testing.assert_allclose(
            hidden_t.numpy(), np.asarray(hidden_j), rtol=1e-4, atol=1e-6
        )


def test_controller_whole_sequence_matches_jax(jax_params):
    conf = Config(**SMALL)
    model = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), conf)
    batch = _features(2, 5, seed=9)
    want, _ = jax_controller_apply(
        jax_params["controller"], {k: jnp.asarray(v) for k, v in batch.items()}
    )
    with torch.no_grad():
        got, _ = controller_apply(
            model.controller, {k: torch.from_numpy(v) for k, v in batch.items()}
        )
    np.testing.assert_allclose(got["c"].numpy(), np.asarray(want["c"]), rtol=1e-4, atol=1e-6)


def test_state_dict_round_trip_through_reference_layout(jax_params, tmp_path):
    """ddsp_tpu's torch export (the reference Decoder layout, extra
    non-learned keys included) loads into the port unchanged, bare and as
    a Lightning checkpoint."""
    jconf = JaxConfig(**SMALL)
    conf = Config(**SMALL)
    sd = state_dict_from_decoder_params(jax_params, jconf)
    model = decoder_from_state_dict(sd, conf)
    direct = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), conf)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), direct.state_dict()[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)

    path = tmp_path / "decoder.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, path)
    loaded = load_lightning_decoder(str(path), conf)
    np.testing.assert_array_equal(
        loaded.reverb.noise.detach().numpy(), np.asarray(jax_params["reverb"]["noise"])
    )
    del sd["controller.dense_filter.bias"]
    with pytest.raises(KeyError, match="dense_filter.bias"):
        decoder_from_state_dict(sd, conf)


def test_modified_sigmoid_uses_literal_exponent():
    x = torch.tensor([-2.0, 0.0, 3.0])
    want = 2.0 * torch.sigmoid(x) ** 2.3026 + 1e-7
    np.testing.assert_array_equal(modified_sigmoid(x).numpy(), want.numpy())


def test_decoder_init_is_seeded():
    conf = Config(**SMALL)
    a, b, c = decoder_init(conf, 1), decoder_init(conf, 1), decoder_init(conf, 2)
    wa = a.controller.gru.weight_hh_l0.detach()
    assert torch.equal(wa, b.controller.gru.weight_hh_l0.detach())
    assert not torch.equal(wa, c.controller.gru.weight_hh_l0.detach())
