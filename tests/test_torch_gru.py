"""The port's GRU recurrence (``ops/cuda/gru.py``): one autograd node over
the whole sequence, its backward written by hand.

CPU: the plain version against autograd through the step-by-step loop the
GRU ran before (:func:`_stepwise_gru`) in float64, so the two differ only
in summation order: outputs, last hidden and every gradient within 1e-9.
The graph of ``GRU.forward`` does not grow with T.

On the card (marked ``cuda``; no jax imported, so
``python -m pytest --noconftest -m cuda tests/test_torch_gru.py`` runs it
there): the kernels against the plain version at the training cell's
shape (384, 172, 512), serving's (2,048, 1, 512) and a 60 s file's
(1, 5,168, 512) without a gradient, and T launches of each kernel a call.
Both run the same GEMMs and round the gates the same way, so they agree
within 1e-6 of each tensor's norm.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest
import torch

from ddsp_tpu_torch.models.nn import GRU
from ddsp_tpu_torch.ops.cuda import gru as gru_ops
from ddsp_tpu_torch.ops.cuda import launch_counts, reset_launch_counts


def _stepwise_gru(gru: GRU, x: torch.Tensor, h0: torch.Tensor):
    """The GRU as the port ran it before: a torch op per gate a step, the
    step's slice of the input projection taken under autograd."""
    finals, seq = [], x
    for k in range(gru.n_layers):
        gi = seq @ getattr(gru, f"weight_ih_l{k}").T + getattr(gru, f"bias_ih_l{k}")
        w_hh, b_hh = getattr(gru, f"weight_hh_l{k}"), getattr(gru, f"bias_hh_l{k}")
        h, outs = h0[k], []
        for i in range(x.shape[1]):
            gh = h @ w_hh.T + b_hh
            i_r, i_z, i_n = gi[:, i].chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        finals.append(h)
    return seq, torch.stack(finals)


def _grads(gru, x, h0, fn, w_out, w_last):
    for p in (*gru.parameters(), x, h0):
        p.grad = None
    out, last = fn(gru, x, h0)
    loss = 0.0
    if w_out is not None:
        loss = loss + (out * w_out).sum()
    if w_last is not None:
        loss = loss + (last * w_last).sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in gru.named_parameters()}
    grads["x"] = x.grad.clone()
    if h0.requires_grad:
        grads["h0"] = h0.grad.clone()
    return out.detach(), last.detach(), grads


@pytest.mark.parametrize("b,t,h,layers,h0_given,use", [
    (2, 1, 4, 1, True, "both"),
    (3, 5, 6, 1, False, "out"),
    (2, 7, 5, 2, True, "both"),
    (4, 9, 8, 2, False, "last"),
    (1, 12, 3, 1, True, "out"),
    (3, 1, 7, 2, True, "last"),
])
def test_plain_sequence_matches_autograd_through_the_steps(b, t, h, layers, h0_given, use):
    n_in = 5
    torch.manual_seed(b * 100 + t)
    gru = GRU(n_in, h, layers).double()
    rng = np.random.default_rng(t)
    x = torch.tensor(rng.standard_normal((b, t, n_in)), requires_grad=True)
    h0 = torch.tensor(rng.standard_normal((layers, b, h)) if h0_given
                      else np.zeros((layers, b, h)), requires_grad=h0_given)
    w_out = torch.tensor(rng.standard_normal((b, t, h))) if use in ("both", "out") else None
    w_last = torch.tensor(rng.standard_normal((layers, b, h))) if use in ("both", "last") else None
    reset_launch_counts()
    got = _grads(gru, x, h0, lambda g, a, s: g(a, s if h0_given else None), w_out, w_last)
    assert not any(launch_counts().values())  # the CPU runs no kernel
    want = _grads(gru, x, h0, _stepwise_gru, w_out, w_last)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-9, atol=1e-12)
    assert got[2].keys() == want[2].keys()
    for name, g in want[2].items():
        np.testing.assert_allclose(got[2][name].numpy(), g.numpy(), rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def _graph_nodes(*outputs) -> int:
    seen, stack = set(), [o.grad_fn for o in outputs]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    return len(seen)


def test_backward_graph_does_not_grow_with_time():
    gru = GRU(4, 6, 2)
    counts = []
    for t in (8, 64):
        x = torch.randn(2, t, 4, requires_grad=True)
        counts.append(_graph_nodes(*gru(x)))
    assert counts[0] == counts[1], counts
    x = torch.randn(2, 8, 4, requires_grad=True)
    assert counts[0] < _graph_nodes(*_stepwise_gru(gru, x, torch.zeros(2, 2, 6)))


def test_no_grad_run_equals_the_graph_run_and_keeps_nothing():
    torch.manual_seed(3)
    gru = GRU(5, 8, 2)
    x, h0 = torch.randn(3, 11, 5), torch.randn(2, 3, 8)
    with torch.no_grad():
        plain = gru(x, h0)
    graph = gru(x, h0)
    assert graph[0].grad_fn is not None and plain[0].grad_fn is None
    for a, b in zip(plain, graph):
        assert torch.equal(a, b.detach())
    gi = torch.randn(3, 4, 24)
    with torch.no_grad():
        out, last = gru_ops.gru_sequence(gi, torch.zeros(3, 8), gru.weight_hh_l0, gru.bias_hh_l0)
    assert torch.equal(last, out[:, -1])


def test_refusals():
    gi, h0 = torch.zeros(2, 3, 12), torch.zeros(2, 4)
    w, b = torch.zeros(12, 4), torch.zeros(12)
    with pytest.raises(ValueError, match="unsupported device"):
        gru_ops.gru_sequence(gi.to("meta"), h0.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="h0 must be"):
        gru_ops.gru_sequence(gi, torch.zeros(3, 4), w, b)
    with pytest.raises(ValueError, match="3H"):
        gru_ops.gru_sequence(torch.zeros(2, 3, 11), h0, w, b)
    with pytest.raises(ValueError, match="no time step"):
        gru_ops.gru_sequence(torch.zeros(2, 0, 12), h0, w, b)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _operands(b, t, h, device, seed, grad: bool):
    """The recurrence's operands at the controller's scales: gi as a
    projection of unit-scale latents, weights in torch's init range."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)
    arrays = (rng.standard_normal((b, t, 3 * h)) * 0.5, rng.standard_normal((b, h)) * 0.1,
              rng.uniform(-bound, bound, (3 * h, h)), rng.uniform(-bound, bound, 3 * h))
    return [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=grad)
            for a in arrays]


def _close(got, want, what, rel=1e-6):
    err = float((got - want).detach().norm())
    scale = float(want.detach().norm())
    assert err <= rel * scale + 1e-30, f"{what}: |diff| {err:.3e} against |want| {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,grad", [(384, 172, 512, True), (2048, 1, 512, True),
                                         (2048, 1, 512, False), (1, 5168, 512, False)])
def test_kernels_match_plain_version_on_card(cuda_device, b, t, h, grad):
    args = _operands(b, t, h, cuda_device, seed=b + t, grad=grad)
    rng = np.random.default_rng(7)
    w_out = torch.tensor(rng.standard_normal((b, t, h)), dtype=torch.float32, device=cuda_device)
    w_last = torch.tensor(rng.standard_normal((b, h)), dtype=torch.float32, device=cuda_device)
    results = []
    for fn in (gru_ops.gru_sequence, gru_ops.gru_sequence_plain):
        reset_launch_counts()
        with torch.set_grad_enabled(grad):
            out, last = fn(*args)
            if grad:
                grads = torch.autograd.grad((out * w_out).sum() + (last * w_last).sum(), args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        results.append((out, last, grads if grad else ()))
        if fn is gru_ops.gru_sequence:
            want = {"gru_gates_fwd": t, **({"gru_gates_bwd": t} if grad else {})}
            assert counts == want, counts
        else:
            assert not counts, counts
    (out, last, grads), (p_out, p_last, p_grads) = results
    assert torch.isfinite(out).all()
    _close(out, p_out, "outputs")
    _close(last, p_last, "last hidden")
    for name, g, p in zip(("gi", "h0", "w_hh", "b_hh"), grads, p_grads):
        _close(g, p, name)
