"""The JAX trainer's Orbax checkpoints in the port: read without
tensorstore (``models/orbax.py``, ``native/zstd.py``) and training resumed
from their whole state (``models/convert.train_state_from_jax``,
``training/trainer.restore_checkpoint``), on the CPU, against tensorstore,
zstandard and the JAX package as oracles.

The committed fixture ``tests/torch_data/jax_ckpt/`` is written by
``tests/make_jax_ckpt_fixture.py`` (its docstring says what it holds).  A
finetune state's resume is in tests/test_torch_orbax_finetune.py (a file of
its own, so that each stays under 40 s alone and the two run side by side).

Tolerances, each with its reason:

* every read: bit-equal (the same bytes decoded);
* resumed steps, port vs JAX from one checkpoint, the criterion of
  ``tests/test_torch_training.py::test_three_train_steps_match_jax``: each
  step's loss within 1e-4 relative and grad_norm within 1e-3 relative
  (float32 sums in another order), the parameters after each step at
  ``allclose(rtol=2e-3, atol=3e-3)``; Adam's ``mu`` and ``nu``, which that
  test does not compare, leaf by leaf within 1e-3 of the leaf's norm plus
  1e-6 of the whole tree's norm (its grad_norm tolerance, leaf by leaf;
  chip_smoke.py's gradient criterion; a finetune state's CREPE leaves are
  held as tests/test_torch_orbax_finetune.py says); the plateau's float
  fields (window
  means of the loss) within the loss's 1e-4; ``count``, ``step``, the
  plateau's integer fields and the threefry key equal.
"""

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch_one_thread  # noqa: F401  (one torch thread a test worker)
from hypothesis import given, settings
from hypothesis import strategies as st

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.audio_io import write_wav
from ddsp_tpu_torch.models import convert, orbax
from ddsp_tpu_torch.models.controller import decoder_init
from ddsp_tpu_torch.native import zstd
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.training import trainer

import make_jax_ckpt_fixture as fx

STEP = os.path.join(fx.FIXTURE, fx.STEP_DIR)
RESUME_STEPS = 3
LOSS_RTOL, NORM_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-3, 2e-3, 3e-3
MOMENT_RTOL, MOMENT_FLOOR = 1e-3, 1e-6


def _expected():
    return dict(np.load(os.path.join(fx.FIXTURE, "expected.npz")))


def _port_conf():
    with open(os.path.join(fx.FIXTURE, "config.json")) as f:
        return Config.from_json(f.read())


def _copy_fixture(tmp_path):
    dst = tmp_path / "jax_ckpt"
    shutil.copytree(fx.FIXTURE, dst)
    return dst


def _ts_read(step_dir, name):
    import tensorstore

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{step_dir}",
                                          "path": name}}
    return np.asarray(tensorstore.open(spec).result().read().result())


# --- the reader ------------------------------------------------------------------------
def test_fixture_reads_without_tensorstore_bit_equal(monkeypatch):
    """Every leaf of the committed checkpoint, read with tensorstore and
    zstandard unimportable, equals its SHA-256 and tensorstore's read."""
    for name in ("tensorstore", "zstandard", "orbax", "orbax.checkpoint"):
        monkeypatch.setitem(sys.modules, name, None)  # import fails
    tree = orbax.read_orbax(STEP)
    monkeypatch.undo()
    leaves = orbax.flatten(tree)
    want = {k[len("digest:"):]: str(v) for k, v in _expected().items()
            if k.startswith("digest:")}
    assert leaves.pop("opt_state.0.1") is None  # optax's EmptyState
    assert {k: orbax.leaf_digest(v) for k, v in leaves.items()} == want
    for k, v in leaves.items():
        ts = _ts_read(STEP, k)
        assert v.dtype == ts.dtype and v.shape == ts.shape, k
        np.testing.assert_array_equal(v, ts, err_msg=k)
    assert tree["opt_state"][0][0]["count"] == 3 and tree["step"] == 3
    assert tree["opt_state"][1]["best_value"].dtype == np.float32


def _full_width_jax_state(seed=0):
    """A JAX TrainState at full ``Config()`` width made from numpy: the
    parameters of a seeded port decoder in the JAX layout, seeded nonzero
    Adam moments, count 5, a plateau state past its first window."""
    import jax.numpy as jnp
    import optax

    from ddsp_tpu.training.trainer import TrainState

    rng = np.random.default_rng(seed)
    params = convert.decoder_to_jax(decoder_init(Config(), seed=seed))

    def like(scale, positive=False):
        def draw(x):
            a = scale * rng.standard_normal(np.shape(x)).astype(np.float32)
            return jnp.asarray(np.abs(a) if positive else a)
        return _tree_map(draw, params)

    adam = optax.ScaleByAdamState(count=jnp.asarray(np.int32(5)), mu=like(1e-3),
                                  nu=like(1e-3, positive=True))
    plateau = optax.contrib.ReduceLROnPlateauState(
        scale=jnp.float32(0.5), best_value=jnp.float32(5.5e4), plateau_count=jnp.int32(2),
        cooldown_count=jnp.int32(0), count=jnp.int32(0), avg_value=jnp.float32(0.0))
    return TrainState(jnp.asarray(np.int32(5)), _tree_map(jnp.asarray, params),
                      ((adam, optax.EmptyState()), plateau),
                      jnp.asarray(np.array([123, 456789], np.uint32)))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def test_full_width_checkpoint_reads_bit_equal(tmp_path):
    """A JAX checkpoint at full ``Config()`` width (an 18 MB array file):
    every leaf bit-equal to the JAX state, and the port's state restored
    from it maps back (``train_state_to_jax``) to the same leaves, bit for
    bit, so moments follow their parameters through the port's order."""
    from ddsp_tpu.config import Config as JConfig
    from ddsp_tpu.training import trainer as jt

    state = _full_width_jax_state()
    path = jt.save_checkpoint(str(tmp_path / "ckpt"), state, JConfig(), block=True)
    got = orbax.flatten(orbax.read_orbax(path))
    want = orbax.flatten(fx.numpy_tree(state._asdict()))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert max(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
               for f in fs) > 15e6

    port = trainer.restore_checkpoint(path, trainer.init_state(PRNGKey(1), Config(), "cpu"))
    back = orbax.flatten(convert.train_state_to_jax(port))
    assert back.keys() == want.keys() and port.step == 5
    for k, v in want.items():
        if v is not None:
            assert back[k].dtype == v.dtype or k == "step", k  # the port's step is an int
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def _store_values(rng, n):
    return {f"k{i:05d}/{'x' * (i % 5)}": bytes(rng.integers(0, 256, int(rng.integers(0, 400)),
                                                            dtype=np.uint8))
            for i in range(n)}


@pytest.mark.parametrize("compression,n_keys,node_bytes", [
    (None, 40, 8 << 20), ({"id": "zstd"}, 40, 8 << 20), ({"id": "zstd"}, 2500, 4000)])
def test_ocdbt_stores_read_equal(tmp_path, compression, n_keys, node_bytes):
    """Stores that tensorstore writes, in the clear and with zstd, and with
    enough keys for interior B-tree nodes, read equal key by key; values
    above ``max_inline_value_bytes`` lie in the data files."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"compression": compression,
                                     "max_decoded_node_bytes": node_bytes,
                                     "max_inline_value_bytes": 100}}).result()
    values = _store_values(np.random.default_rng(n_keys), n_keys)
    txn = ts.Transaction()
    for k, v in values.items():
        kv.with_transaction(txn).write(k.encode(), v).result()
    txn.commit_async().result()
    kv.write(b"k00000/", b"rewritten in a second version").result()
    values["k00000/"] = b"rewritten in a second version"
    store = orbax.OcdbtStore(str(tmp_path))
    assert list(store.keys()) == sorted(values)
    for k, v in values.items():
        assert store.get(k) == v == kv.read(k.encode()).result().value, k
    for absent in ("", "k", "k00000", "k00001/x/", "zzz"):
        assert store.get(absent) is None
    if n_keys > 1000:  # interior nodes: the version's root is above its leaves
        assert any(node.height for node in store._nodes.values())


ZARR_CASES = {
    "v2_C_f4": ("zarr", {"dtype": "<f4", "order": "C", "compressor": {"id": "zstd"}}),
    "v2_F_big_i2": ("zarr", {"dtype": ">i2", "order": "F", "compressor": None}),
    "v3_f4": ("zarr3", {"data_type": "float32"}),
}


@pytest.mark.parametrize("case", sorted(ZARR_CASES))
def test_zarr_array_with_chunks_and_a_missing_chunk(tmp_path, case):
    """A (5, 7) array in (2, 3) chunks, ragged at both edges, written only
    in part: the chunks never written read as fill_value."""
    import tensorstore as ts

    driver, meta = ZARR_CASES[case]
    if driver == "zarr":
        metadata = dict(meta, shape=[5, 7], chunks=[2, 3], fill_value=7)
    else:
        metadata = dict(meta, shape=[5, 7], fill_value=7.0, codecs=[
            {"name": "bytes", "configuration": {"endian": "little"}}, {"name": "zstd"}],
            chunk_grid={"name": "regular", "configuration": {"chunk_shape": [2, 3]}})
    spec = {"driver": driver, "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}",
                                          "path": "a.b"}, "metadata": metadata, "create": True}
    arr = ts.open(spec).result()
    data = np.arange(35).reshape(5, 7) * 3 - 40
    arr[:3, 2:].write(data[:3, 2:].astype(arr.dtype.numpy_dtype)).result()
    want = np.asarray(arr.read().result())
    got = orbax.read_array(orbax.OcdbtStore(str(tmp_path)), "a.b")
    assert got.dtype == want.dtype.newbyteorder("=") and got.shape == (5, 7)
    np.testing.assert_array_equal(got, want)
    assert (got[3:, :] == 7).all() and (got[:, :2] == 7).all()


@settings(max_examples=30, deadline=None)
@given(data=st.binary(max_size=3000), level=st.sampled_from([1, 3, 19]),
       sized=st.booleans(), split=st.integers(0, 3000))
def test_zstd_binding_matches_zstandard(data, level, sized, split):
    """Frames with and without a content size, empty input, and frames
    end to end read whole and by offset and length."""
    import zstandard

    cz = zstandard.ZstdCompressor(level=level, write_content_size=sized)
    a, b = data[:split], data[split:]
    fa, fb = cz.compress(a), cz.compress(b)
    assert zstd.decompress(fa) == zstandard.ZstdDecompressor().decompress(
        fa, max_output_size=len(a) + 1) == a
    blob = fa + fb
    assert zstd.decompress(blob[:len(fa)]) == a and zstd.decompress(blob[len(fa):]) == b
    assert zstd.decompress(blob) == a + b
    stream = io.BytesIO()
    with cz.stream_writer(stream, closefd=False) as w:
        w.write(data)
    assert zstd.decompress(stream.getvalue()) == data
    assert zstd.decompress(b"") == b""


# --- the reader's errors ---------------------------------------------------------------
def _first_key():
    return next(iter(orbax.orbax_leaves(STEP)))[0]


def test_missing_manifest_names_file_and_key(tmp_path):
    step = _copy_fixture(tmp_path) / fx.STEP_DIR
    (step / "manifest.ocdbt").unlink()
    with pytest.raises(FileNotFoundError, match=r"manifest\.ocdbt: no such file \(reading key '.+'\)"):
        orbax.read_orbax(str(step))


def test_bad_magic_names_file_and_key(tmp_path):
    step = _copy_fixture(tmp_path) / fx.STEP_DIR
    raw = bytearray((step / "manifest.ocdbt").read_bytes())
    raw[:4] = b"\0\0\0\0"
    (step / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(orbax.OrbaxFormatError,
                       match=r"manifest\.ocdbt: bad magic 00000000 .*reading key '.+'"):
        orbax.read_orbax(str(step))


def test_truncated_data_file_names_file_and_key(tmp_path):
    step = _copy_fixture(tmp_path) / fx.STEP_DIR
    data = max((step / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
    data.write_bytes(data.read_bytes()[: data.stat().st_size // 2])
    with pytest.raises(orbax.OrbaxFormatError,
                       match=rf"{data.name}: truncated: .*reading key '.+'"):
        orbax.read_orbax(str(step))


def test_zstd_error_names_file_and_key(tmp_path):
    """A node whose zstd frame is damaged (its checksum made to match, so
    the frame check is what fails)."""
    step = _copy_fixture(tmp_path) / fx.STEP_DIR
    node = next(p for p in (step / "d").iterdir())
    raw = bytearray(node.read_bytes())
    assert raw[14:18] == b"\x28\xb5\x2f\xfd"  # the body's zstd frame
    raw[14:18] = b"\x00\x00\x00\x00"
    raw[-4:] = orbax.crc32c(bytes(raw[:-4])).to_bytes(4, "little")
    node.write_bytes(bytes(raw))
    with pytest.raises(orbax.OrbaxFormatError,
                       match=rf"{node.name} \(reading key '.+'\): no zstd frame"):
        orbax.read_orbax(str(step))


# --- resuming ----------------------------------------------------------------------------
def _moments_close(got, want, prefix, crepe_rtol):
    """Each leaf under ``prefix`` within MOMENT_RTOL of its norm (CREPE's
    within ``crepe_rtol``) plus MOMENT_FLOOR of the whole tree's norm."""
    keys = [k for k in want if k.startswith(prefix + ".")]
    total = np.sqrt(sum(float(np.sum(np.asarray(want[k], np.float64) ** 2)) for k in keys))
    for k in keys:
        w = np.asarray(want[k], np.float64)
        diff = np.linalg.norm(np.asarray(got[k], np.float64) - w)
        rtol = crepe_rtol if ".crepe." in k else MOMENT_RTOL
        assert diff <= rtol * np.linalg.norm(w) + MOMENT_FLOOR * total, (k, diff)


def _hold(state, jstate, m, jm, i, crepe_rtol=MOMENT_RTOL):
    """One resumed step, port vs JAX, at the tolerances of the docstring."""
    for name, rtol in (("loss", LOSS_RTOL), ("grad_norm", NORM_RTOL)):
        assert abs(float(m[name]) - float(jm[name])) <= rtol * abs(float(jm[name])), (i, name)
    want = orbax.flatten(fx.numpy_tree(jstate._asdict()))
    got = orbax.flatten(convert.train_state_to_jax(state))
    assert got.keys() == want.keys()
    for k in (k for k in want if k.startswith("params.")):
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    for moment in ("mu", "nu"):
        _moments_close(got, want, f"opt_state.0.0.{moment}", crepe_rtol)
    exact = ["step", "rng", "opt_state.0.0.count"] + [
        f"opt_state.1.{f}" for f in ("plateau_count", "cooldown_count", "count")]
    for k in exact:
        np.testing.assert_array_equal(got[k].astype(np.int64), want[k].astype(np.int64), err_msg=k)
    for f in ("scale", "best_value", "avg_value"):
        k = f"opt_state.1.{f}"
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_resume_from_jax_checkpoint_matches_jax():
    """The committed checkpoint: JAX's ``restore_checkpoint`` and 3 steps
    against the port's ``restore_checkpoint`` of the same directory and 3
    steps on the same batches."""
    seeds = tuple(fx.RESUME_SEEDS) + (22,)
    assert len(seeds) == RESUME_STEPS
    jstates, jmetrics = fx.jax_resume(fx.FIXTURE, seeds)
    conf = _port_conf()
    state = trainer.restore_checkpoint(trainer.latest_checkpoint(fx.FIXTURE),
                                       trainer.init_state(PRNGKey(conf.seed), conf, "cpu"))
    assert state.step == 3 and int(state.opt_state.adam.count) == 3
    step = trainer.make_train_step(conf)
    for i, s in enumerate(seeds):
        b = {k: torch.from_numpy(v) for k, v in fx.batch(conf, conf.batch_size, s).items()}
        state, m = step(state, b)
        _hold(state, jstates[i], m, jmetrics[i], i)


def test_train_cli_resumes_from_jax_directory(tmp_path, capsys):
    """``python -m ddsp_tpu_torch.training.train --checkpoint_dir=<JAX
    dir>`` resumes at step 3 and takes the next steps."""
    from ddsp_tpu_torch.training import train

    ckpt = _copy_fixture(tmp_path)
    conf = _port_conf()
    data = tmp_path / "data"
    data.mkdir()
    t = np.arange(int(conf.sample_rate * 1.5)) / conf.sample_rate
    for i, f in enumerate((150.0, 220.0, 330.0)):
        write_wav(str(data / f"t{i}.wav"), (0.4 * np.sin(2 * np.pi * f * t))[None]
                  .astype(np.float32), conf.sample_rate)
    flags = [f"--{k}={json.dumps(list(v) if isinstance(v, tuple) else v)}"
             for k, v in fx.FIXTURE_CONF.items()]
    state = train.main([f"--data_dir={data}", f"--checkpoint_dir={ckpt}", "--num_steps=2",
                        "--device_steps=0", "--checkpoint_every=2", "--device=cpu", *flags])
    out = capsys.readouterr().out
    assert f"Resumed from {ckpt / fx.STEP_DIR} at step 3" in out, out
    assert state.step == 5
    assert trainer.latest_checkpoint(str(ckpt)).endswith("step_00000005")
    assert os.path.exists(ckpt / "step_00000005" / "state.pt")


def test_fixture_regenerates_to_expected(tmp_path):
    """``tests/make_jax_ckpt_fixture.py`` writes, in a new directory, a
    checkpoint whose leaves and JAX continuation equal the committed
    ``expected.npz``."""
    got = fx.write(str(tmp_path / "regen"))
    want = _expected()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    regen = orbax.flatten(orbax.read_orbax(str(tmp_path / "regen" / fx.STEP_DIR)))
    assert {k: orbax.leaf_digest(v) for k, v in regen.items() if v is not None} == {
        k[len("digest:"):]: str(v) for k, v in want.items() if k.startswith("digest:")}


def test_wrong_leaf_raises_naming_it():
    """A leaf missing from the JAX state, one the port lacks, and one of
    another shape or dtype each raise and name the leaf, and leave the
    template as it was."""
    tree = orbax.read_orbax(STEP)
    conf = _port_conf()
    template = lambda: trainer.init_state(PRNGKey(0), conf, "cpu")  # noqa: E731
    del tree["opt_state"][0][0]["nu"]["reverb"]["wet"]
    with pytest.raises(KeyError, match=r"opt_state\.0\.0\.nu\.reverb\.wet"):
        convert.train_state_from_jax(tree, template())
    tree = orbax.read_orbax(STEP)
    tree["params"]["controller"]["extra"] = {"weight": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match=r"params\.controller\.extra\.weight"):
        convert.train_state_from_jax(tree, template())
    tree = orbax.read_orbax(STEP)
    tree["opt_state"][0][0]["mu"]["reverb"]["noise"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match=r"opt_state\.0\.0\.mu\.reverb\.noise: float32 of shape \(7,\)"):
        convert.train_state_from_jax(tree, template())
    tree = orbax.read_orbax(STEP)
    tree["params"]["reverb"]["wet"] = tree["params"]["reverb"]["wet"].astype(np.float64)
    state = template()
    before = [p.detach().clone() for p in state.params.parameters()]
    with pytest.raises(ValueError, match=r"params\.reverb\.wet: float64 of shape \(\)"):
        convert.train_state_from_jax(tree, state)
    assert all(torch.equal(a, b) for a, b in zip(before, state.params.parameters()))
