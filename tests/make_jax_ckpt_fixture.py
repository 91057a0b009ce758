"""Write ``tests/torch_data/jax_ckpt/``: a checkpoint of the JAX package's
trainer, for the port's CPU tests (``tests/test_torch_orbax.py``) and for
``chip_smoke.py``'s phase 20, which reads it on the card without jax.

    JAX_PLATFORMS=cpu python tests/make_jax_ckpt_fixture.py [OUT_DIR]

The state: the narrow config of ``tests/test_torch_reconstruct.py`` at
batch 4, the JAX side on its float32 loss and reverb-gradient paths and its
exact oscillator (``FIXTURE_CONF``), after 3 jitted train steps from
``PRNGKey(SEED)`` on the batches of ``TRAIN_SEEDS`` (so Adam's count is 3
and its moments are nonzero), saved by ``save_checkpoint(block=True)`` at
step 3 with its ``config.json``.  Beside it, ``expected.npz``:

* ``digest:<key path>``: each leaf's SHA-256 (``models/orbax.leaf_digest``,
  over dtype, shape and bytes), the key paths as the checkpoint's
  ``_METADATA`` names them;
* ``resume_seeds`` and ``batch_digest:<i>``: the seeds of the batches of
  the steps after the restore, and a digest of each batch (:func:`batch`),
  so a reader elsewhere can check that it made the same batch;
* ``after:<key path>``: the whole state after the JAX CLI's resume
  (``restore_checkpoint`` into ``init_state(PRNGKey(conf.seed))``) and
  ``len(resume_seeds)`` more steps; ``losses`` and ``grad_norms`` of those
  steps.

The checkpoint's own bytes carry a fresh uuid and commit times on every
run; what it holds, and ``expected.npz``, come out the same.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_data", "jax_ckpt")
STEP_DIR = "step_00000003"
SMALL = dict(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16, reverb_length=300,
    crepe_window=1024, crepe_sample_rate=16000,
)
FIXTURE_CONF = dict(SMALL, batch_size=4, example_duration=0.5, mss_ffts=(256, 128, 64),
                    loss_matmul_dtype="float32",
                    reverb_grad_matmul_dtype="float32", osc_impl="xla")
SEED = 5
TRAIN_SEEDS = (10, 11, 12)
RESUME_SEEDS = (20, 21)


def batch(conf, n: int, seed: int) -> dict:
    """A seeded numpy training batch (``chip_smoke.feature_batch``'s)."""
    rng = np.random.default_rng(seed)
    t = conf.frames_per_example
    return {
        "f0": rng.uniform(100.0, 400.0, (n, t, 1)).astype(np.float32),
        "normalized_cents": rng.uniform(0.0, 1.0, (n, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0.0, 1.0, (n, t, 1)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((n, conf.example_length))).astype(np.float32),
    }


def batch_digest(b: dict) -> str:
    from ddsp_tpu_torch.models.orbax import leaf_digest

    return leaf_digest(np.frombuffer("".join(leaf_digest(b[k]) for k in sorted(b)).encode(),
                                     np.uint8))


def numpy_tree(x):
    """A JAX pytree as nested dicts / lists of numpy arrays, keyed as Orbax
    keys it (a NamedTuple's fields by name, a tuple's items by index; an
    empty NamedTuple, optax's ``EmptyState``, as None)."""
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {f: numpy_tree(getattr(x, f)) for f in x._fields} if x._fields else None
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    return np.asarray(x)


def jax_conf(**overrides):
    from ddsp_tpu.config import Config as JConfig

    return JConfig(**dict(FIXTURE_CONF, **overrides))


@functools.lru_cache(maxsize=None)
def jitted_step(conf):
    """The JAX trainer's jitted train step for ``conf`` (compiled once a
    process)."""
    import jax

    from ddsp_tpu.training import trainer as jt

    return jax.jit(jt.make_train_step(conf))


def uncommitted(tree):
    """``tree``'s arrays, bit for bit, as fresh uncommitted arrays: the
    inputs a jitted step was compiled for (a restored array is committed to
    its device, and a committed input compiles the step anew)."""
    import jax

    return jax.tree_util.tree_map(lambda x: jax.numpy.asarray(np.asarray(x)), tree)


def jax_resume(ckpt_dir: str, seeds, conf=None):
    """What the JAX CLI does on ``ckpt_dir``: restore its newest checkpoint
    into the template ``init_state(PRNGKey(conf.seed))`` (given by its
    shapes and dtypes, which are all the restore reads of it), then one
    step on each seed's batch.  Returns (state after each step, metrics of
    each step)."""
    import jax

    from ddsp_tpu.training import trainer as jt

    conf = conf or jax_conf()
    template = jax.eval_shape(functools.partial(jt.init_state, conf=conf),
                              jax.random.PRNGKey(conf.seed))
    state = uncommitted(jt.restore_checkpoint(jt.latest_checkpoint(ckpt_dir), template))
    states, metrics = [], []
    for s in seeds:
        state, m = jitted_step(conf)(state, batch(conf, conf.batch_size, s))
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def write(out_dir: str) -> dict:
    """Write the checkpoint and ``expected.npz`` under ``out_dir``; returns
    what ``expected.npz`` holds."""
    import jax

    from ddsp_tpu.training import trainer as jt
    from ddsp_tpu_torch.models.orbax import flatten, leaf_digest

    conf = jax_conf()
    # through numpy, the init's weakly typed scalars become strong, as every
    # state after a step is: the step then compiles once, not once a step
    state = uncommitted(jax.jit(jt.init_state, static_argnums=1)(jax.random.PRNGKey(SEED), conf))
    for s in TRAIN_SEEDS:
        state, _ = jitted_step(conf)(state, batch(conf, conf.batch_size, s))
    saved = dict(numpy_tree(state._asdict()))
    path = jt.save_checkpoint(out_dir, state, conf, block=True)
    assert os.path.basename(path) == STEP_DIR, path
    states, metrics = jax_resume(out_dir, RESUME_SEEDS, conf)
    expected = {f"digest:{k}": np.array(leaf_digest(v))
                for k, v in flatten(saved).items() if v is not None}
    expected["seed"] = np.array(SEED)
    expected["train_seeds"] = np.array(TRAIN_SEEDS)
    expected["resume_seeds"] = np.array(RESUME_SEEDS)
    for i, s in enumerate(RESUME_SEEDS):
        expected[f"batch_digest:{i}"] = np.array(batch_digest(batch(conf, conf.batch_size, s)))
    for k, v in flatten(numpy_tree(states[-1]._asdict())).items():
        if v is not None:
            expected[f"after:{k}"] = v
    expected["losses"] = np.array([m["loss"] for m in metrics], np.float64)
    expected["grad_norms"] = np.array([m["grad_norm"] for m in metrics], np.float64)
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **expected)
    return expected


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    out = sys.argv[1] if len(sys.argv) > 1 else FIXTURE
    if os.path.exists(os.path.join(out, STEP_DIR)):
        raise SystemExit(f"{out} already holds {STEP_DIR}: remove it first")
    write(out)
    total = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {total} bytes")
