"""The port's tensor-parallel train steps (``ddsp_tpu_torch.parallel.tp.
make_tp_train_step``, DP x TP, and ``parallel.sp.make_sp_train_step`` on
a ``make_mesh3`` mesh, DP x SP x TP) on CPU gloo groups, against the JAX
package on the 8-device virtual mesh (tests/conftest.py) and the port's
single-device step, from the same seeded numpy inputs and converted
weights (tests/torch_parallel_refs.py).

The counterparts of tests/test_parallel.py:206-235 and :308-356, held
closer than those: the JAX suite compares the parameters after one Adam
step (atol 3e-3, above 2 lr), which an n_model-fold gradient passes, so
here every gradient leaf is compared before Adam.  The rank processes run
tests/torch_parallel_cases.py: one spawn a world size (4, then 8), each
with a hard time limit and a 60 s group timeout.

Criteria, each from the values measured on these inputs, none looser
than tests/test_torch_parallel_sp.py's:

* the TP render's gradient in the controls c, a, H and the reverb's
  parameters, of sum(render * w) over 2 rows of 32 frames, on ('data' 2,
  'model' 2) and on 'model' 4 (``tp._render_tp_rows`` under autograd,
  each data rank's gradient summed over 'data'), against ``jax.grad``
  through JAX's ``render_controls_tp`` and against the port's unsharded
  render: each leaf within 2e-4 of its norm (measured: 1.9e-6 against
  JAX; against the unsharded render 3.8e-6 in one test process and
  3.8e-5 in another, for the bank c, whose gradient through the Nyquist
  renormalisation cancels ~300x, so the last-bit differences of the
  unsharded render's float32 sums, taken in another order and with an
  alignment that differs by process, show there);
* three DP x TP steps on ('data' 2, 'model' 4) at 16 harmonics and on
  (2, 2) at 15 (the bank zero-padded to 16), and three DP x SP x TP
  steps on ``make_mesh3(2, 2, 2)``, at b=4, t=16 and
  ``loss_matmul_dtype='float32'``, against JAX's jitted
  ``make_tp_train_step`` / ``make_sp_train_step`` and the port's
  single-device step (``refs.check_train_steps``): loss and terms within
  1e-5 relative, ``grad_norm`` within 5e-5, every gradient leaf within
  2e-3 of its norm against JAX's gradient and the single step's from the
  same parameters and key, the parameters at allclose(rtol=2e-3,
  atol=2e-5), every rank's metrics equal and its state checksum
  bit-equal, model ranks included (measured, worst over the cases and
  steps: loss 1.7e-6 against JAX and 1.8e-7 against the single step,
  ``grad_norm`` 5.8e-6 and 4.2e-6, leaves 1.9e-4 and 2.4e-4);
* the refusals: ``ValueError`` on every rank for B not divisible by
  'data' (TP), a 3-axis time shard too short for the STFT halo, a
  ('data', 'model') mesh given to the SP loss and a mesh without 'model'
  given to the TP step.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest

import torch_parallel_refs as refs

RENDER_GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def port():
    future = refs.spawn([*refs.TP_GRADS, *refs.TP_STEPS, "tp_errors"])
    yield future
    future.result()


@pytest.mark.parametrize("name", list(refs.TP_GRADS))
def test_tp_render_gradient_matches_jax_and_unsharded(port, name):
    ranks = port.result()[name]
    for r in ranks[1:]:
        for g, g0 in zip(r["grads"], ranks[0]["grads"]):
            np.testing.assert_array_equal(g, g0)
    got = ranks[0]["grads"]
    for want, tag in ((refs.jax_tp_render_grads(name), "jax"),
                      (refs.port_unsharded_render_grads(name), "unsharded")):
        for leaf, g, w in zip(refs.RENDER_GRAD_NAMES, got, want):
            assert g.shape == w.shape, (leaf, g.shape, w.shape)
            diff = np.linalg.norm(np.asarray(g, np.float64) - w)
            assert diff <= RENDER_GRAD_RTOL * np.linalg.norm(w), (leaf, tag, diff,
                                                                  np.linalg.norm(w))


@pytest.mark.parametrize("name", list(refs.TP_STEPS))
def test_tp_steps_match_jax_and_single(port, name):
    refs.check_train_steps(name, port.result()[name])


@pytest.mark.parametrize("name, says", [
    ("b_not_divisible", "batch 3 not divisible by the mesh's 2 row shards"),
    ("short_shard_3axis", "n_fft//2 + 1"),
    ("data_model_mesh_sp", "('data', 'time') or ('data', 'time', 'model') mesh"),
    ("no_model_axis_tp", "('data', 'model') mesh"),
])
def test_tp_refusals_raise_value_error(port, name, says):
    for rank, got in enumerate(port.result()["tp_errors"]):
        assert got[name] is not None and says in got[name], (rank, got[name])
