"""The port's differentiable collectives and DP x SP train step
(``ddsp_tpu_torch.parallel.collectives``, ``parallel.sp``) on CPU gloo
groups, against the JAX package on the 8-device virtual mesh
(tests/conftest.py) and the port's single-device step, from the same
seeded numpy inputs and converted weights (tests/torch_parallel_refs.py).

The counterparts of tests/test_parallel.py:260-305 and :359-378 (the
refusals: a ('data', 'model') mesh given to the SP loss, where a
('data', 'time', 'model') one is the DP x SP x TP step,
tests/test_torch_parallel_tp_train.py).  The rank
processes run tests/torch_parallel_cases.py: one spawn a world size (4,
then 2 and 8), each with a hard time limit and a 60 s group timeout, so
that a rank left waiting in a backward ``all_reduce`` that another rank
skipped fails the test instead of hanging it.

Criteria, each from the values measured on these inputs (worst over the
three meshes and three steps), and none looser than the JAX suite's own
SP test (loss and terms within 1e-2 absolute, parameters at
allclose(rtol=2e-3, atol=2e-5)):

* the collectives (``psum``, ``all_gather``, ``ppermute`` with a rank
  that receives nothing and an edge rank's ``where``, ``pvary`` of a
  replicated value (its gradient) and ``pvary(psum(...))`` scaling each
  rank's own values) under ``torch.autograd.grad`` on 4 ranks against
  ``jax.value_and_grad`` through ``jax.shard_map`` (the ``pvary`` ones
  with ``check_vma=True``, where JAX transposes ``pvary`` into a
  ``psum``): the loss within 1e-6 relative (measured 2.4e-7), the
  gradient at allclose(rtol=1e-5, atol=1e-6) (measured 1.5e-7 of its
  largest element; 9.8e-8 for ``pvary(psum(...))``);
* three DP x SP steps on ('data', 'time') meshes (2, 4), (1, 2) and
  (4, 2) at b=4, t=16 (the IR's 512 taps span two 256-sample shards on
  (2, 4)), against JAX's jitted ``make_sp_train_step`` at
  ``loss_matmul_dtype='float32'`` and against the port's single-device
  step, each free-running from the same state: the loss and the
  per-scale terms within 1e-5 relative (measured 1.5e-6 against JAX,
  2.7e-7 against the single step; 3.4e-3 absolute at these losses of
  ~340, under the JAX suite's 1e-2), ``grad_norm`` within 5e-5 relative
  (8.1e-6, 5.5e-6), the parameters after each step at allclose(rtol=2e-3,
  atol=2e-5) (the JAX suite's; measured: within rtol=2e-3 with atol
  8.2e-8 against JAX and 0 against the single step);
* every gradient leaf Adam takes, against JAX's gradient of its SP loss
  and the port's single step, both at this step's parameters and key:
  |diff| within 2e-3 of the leaf's norm (measured 7.0e-4 against JAX,
  3.6e-4 against the single step, both at the second step, where the
  log-spectrum's small bins amplify the float32 order of the sharded
  reverb).  Gradients are compared before Adam because Adam's first
  update is about lr * sign(g): a gradient scaled 8x or 1/8x would pass a
  comparison of the parameters alone;
* every rank's metrics equal and its state checksum bit-equal.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest

import torch_parallel_cases
import torch_parallel_refs as refs

COLLECTIVES = ["psum", "psum_squared", "all_gather", "ppermute_shift_edge", "ppermute_partial",
               "pvary", "pvary_psum"]


@pytest.fixture(scope="module")
def port():
    future = refs.spawn(["collectives4", *refs.SP_MESHES, "sp_errors"])
    yield future
    future.result()


@pytest.fixture(scope="module")
def jax_collectives():
    return refs.jax_collectives(refs.cases()["collectives4"])


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_gradients_match_jax(port, jax_collectives, name):
    want_loss, want_grad = jax_collectives[name]
    for rank, got in enumerate(port.result()["collectives4"]):
        loss, grad = got[name]
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (rank, loss, want_loss)
        want = want_grad if name in torch_parallel_cases.W_GRADS else want_grad[rank]
        np.testing.assert_allclose(grad, want, rtol=1e-5, atol=1e-6, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", list(refs.SP_MESHES))
def test_sp_steps_match_jax_and_single(port, name):
    refs.check_train_steps(name, port.result()[name])


@pytest.mark.parametrize("name, says", [
    ("short_shard", "n_fft//2 + 1"),
    ("t_not_divisible", "T=18 not divisible by time=4"),
    ("b_not_divisible", "B=3 not divisible by data=2"),
    ("data_model_mesh", "('data', 'time') or ('data', 'time', 'model') mesh"),
])
def test_sp_refusals_raise_value_error(port, name, says):
    """A shard too short for the STFT halo, T or B that the mesh does not
    divide, and a ('data', 'model') mesh raise ValueError on every rank
    (none mis-frames, and none leaves another rank waiting)."""
    for rank, got in enumerate(port.result()["sp_errors"]):
        assert got[name] is not None and says in got[name], (rank, got[name])
