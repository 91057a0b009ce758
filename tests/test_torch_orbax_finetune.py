"""A finetune state of the JAX trainer ({decoder, crepe}, CREPE's BatchNorm
statistics optimised) saved with Orbax and resumed in the port, against
the JAX package's own resume, on the CPU.

Tolerances: tests/test_torch_orbax.py's resume criterion (the train step's
of tests/test_torch_training.py, and Adam's moments leaf by leaf within
1e-3 of the leaf's norm plus 1e-6 of the tree's), with one exception:
CREPE's moments from the second resumed step on are held within 5e-2 of
their norm.  CREPE's gradients reach the loss through f0 and the
oscillator's phase sum, whose cancellation spreads them to 1e-2 in float32
once the parameters have moved (tests/test_torch_finetune.py's docstring);
here they measure 3.4e-4 at the first resumed step, whose gradients come
from equal parameters, and 1.6e-2 at the third, while the decoder's leaves
stay within 1e-3 throughout.
"""

import functools

import torch
import torch_one_thread  # noqa: F401  (one torch thread a test worker)

from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.training import trainer

import make_jax_ckpt_fixture as fx
from test_torch_orbax import MOMENT_RTOL, RESUME_STEPS, _hold

CREPE_MOMENT_RTOL = 5e-2


def test_finetune_resume_matches_jax(tmp_path):
    """A finetune state ({decoder, crepe}, CREPE's BatchNorm statistics
    optimised) saved by the JAX trainer after one step: restored and 3
    steps on both sides (tests/test_torch_finetune.py's config, seed and
    tones)."""
    import jax

    from ddsp_tpu.training import trainer as jt
    from test_torch_finetune import SEED, _confs, _tones

    jconf, conf = _confs("float32")
    jstate = fx.uncommitted(jax.jit(jt.init_finetune_state, static_argnums=1)(
        jax.random.PRNGKey(SEED), jconf))
    jstep = jax.jit(jt.make_finetune_step(jconf))
    audio = _tones(conf, conf.batch_size, SEED)
    jstate, _ = jstep(jstate, {"audio": audio})
    path = jt.save_checkpoint(str(tmp_path / "ft"), jstate, jconf, block=True)
    restored = fx.uncommitted(jt.restore_checkpoint(path, jax.eval_shape(
        functools.partial(jt.init_finetune_state, conf=jconf), jax.random.PRNGKey(0))))
    state = trainer.restore_checkpoint(path, trainer.init_finetune_state(PRNGKey(0), conf,
                                                                         device="cpu"))
    assert state.step == 1 and set(state.params) == {"decoder", "crepe"}
    step = trainer.make_finetune_step(conf)
    for i in range(RESUME_STEPS):
        restored, jm = jstep(restored, {"audio": audio})
        state, m = step(state, {"audio": torch.from_numpy(audio)})
        # CREPE's moments from the second step on: its gradients spread to
        # 1e-2 in float32 once the parameters have moved
        # (tests/test_torch_finetune.py; 1.6e-2 measured at the third step)
        _hold(state, restored, m, jm, i, crepe_rtol=MOMENT_RTOL if i == 0 else CREPE_MOMENT_RTOL)
