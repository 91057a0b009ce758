"""L-BFGS as ``optax.lbfgs`` (optax 0.2.6) computes it, on torch tensors.

``optax.lbfgs()`` chains three transforms (``optax/_src/alias.py:2591-
2730``): ``scale_by_lbfgs`` (the two-loop recursion over a ring of
``MEMORY_SIZE`` (s, y) pairs with the scaled-identity initial
preconditioner, ``transform.py:1573-1750``), ``scale(-1)`` (or
``scale(-learning_rate)``), and ``scale_by_zoom_linesearch`` (the
strong-Wolfe zoom search of Nocedal and Wright's algorithms 3.5 and 3.6 with
Hager and Zhang's approximate decrease, ``linesearch.py:576-1560``), or no
search when a learning rate is given.  This module follows them field for
field, as ``training/trainer.py`` follows optax's Adam: the same ring
order, the same initial scale (min(1, 1/|g|) on the first step), the same
trial points, interpolations and acceptance tests, so the stepsizes and
line-search step counts equal optax's for the same objective.
``torch.optim.LBFGS`` is a different algorithm and is not used.

Vectors stay on their device; the line search's scalars (values, slopes,
stepsizes) are float32 on the host, as optax computes them in float32, and
its control flow is a Python loop.  Each trial point is one evaluation of
``value_and_grad_fn``.  The accepted point's value, gradient and auxiliary
output are kept in the state and reused as the next step's start, which
is the point optax's caller would evaluate again.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

# ``optax.lbfgs()``'s default memory, and its default search:
# scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy='one') with the defaults of its other arguments
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5
TOL = 0.0

f32 = np.float32
# value_and_grad_fn(params) -> (value, grad, aux): a 0-dim tensor, a tensor
# shaped as params, and anything the caller wants back for the point
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, Any]]


class LinesearchInfo(NamedTuple):
    """optax's ``ZoomLinesearchInfo``."""

    num_linesearch_steps: int
    decrease_error: np.float32
    curvature_error: np.float32


class LBFGSState(NamedTuple):
    """``ScaleByLBFGSState`` followed by ``ScaleByZoomLinesearchState``.

    ``learning_rate`` is the accepted stepsize (the fixed rate without a
    search); ``value`` / ``grad`` / ``aux`` belong to the accepted point
    (None before the first step and without a search); ``evaluations``
    counts the calls of ``value_and_grad_fn`` in the last step."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor
    learning_rate: np.float32
    value: Optional[torch.Tensor]
    grad: Optional[torch.Tensor]
    aux: Any
    info: LinesearchInfo
    evaluations: int


class _Point(NamedTuple):
    stepsize: np.float32
    value: np.float32
    slope: np.float32
    value_t: torch.Tensor
    grad: torch.Tensor
    aux: Any


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (``linesearch.py:455-494``); NaN when there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]], f32)
    A, B = d1 @ np.array([fb - fa - fpa * db, fc - fa - fpa * dc], f32) / denom
    radical = B * B - 3.0 * A * fpa
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch.py:496-522``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's error, or Hager and Zhang's approximate one near a minimum,
    whichever is smaller; >= 0, NaN as inf (``linesearch.py:710-751``)."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    err = np.maximum(np.minimum(np.maximum(approx, delta_values), err), f32(0))
    return f32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), f32(0))
    return f32(np.inf) if np.isnan(err) else err


class LBFGS:
    """``optax.lbfgs(learning_rate)``: with ``learning_rate`` None the zoom
    line search picks each step's size; with a rate, steps of
    ``-learning_rate`` times the preconditioned gradient and no search."""

    def __init__(self, learning_rate: Optional[float] = None):
        self.learning_rate = learning_rate

    def init(self, params: torch.Tensor) -> LBFGSState:
        zeros = torch.zeros((MEMORY_SIZE,) + params.shape, dtype=params.dtype,
                            device=params.device)
        return LBFGSState(
            count=0, params=torch.zeros_like(params), updates=torch.zeros_like(params),
            diff_params_memory=zeros, diff_updates_memory=zeros.clone(),
            weights_memory=torch.zeros(MEMORY_SIZE, device=params.device),
            learning_rate=f32(1.0), value=None, grad=None, aux=None,
            info=LinesearchInfo(0, f32(np.inf), f32(np.inf)), evaluations=0)

    def _direction(self, grad: torch.Tensor, params: torch.Tensor, state: LBFGSState):
        """``scale_by_lbfgs``'s update: store (s, y) of the last step in the
        ring, then the two-loop product of the inverse-Hessian estimate
        with ``grad``.  Returns (P grad, ring tensors)."""
        m, count = MEMORY_SIZE, state.count
        memory_idx, prev_idx = count % m, (count - 1) % m
        diff_params, diff_updates = params - state.params, grad - state.updates
        vdot_du_dp = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot_du_dp == 0.0, 0.0, 1.0 / vdot_du_dp)
        if count == 0:
            diff_params, diff_updates = torch.zeros_like(params), torch.zeros_like(params)
            weight = torch.zeros_like(weight)
        dw_mem, du_mem = state.diff_params_memory.clone(), state.diff_updates_memory.clone()
        rhos = state.weights_memory.clone()
        dw_mem[prev_idx], du_mem[prev_idx], rhos[prev_idx] = diff_params, diff_updates, weight

        if count > 0:
            denominator = _vdot(diff_updates, diff_updates)
            scale = torch.where(denominator > 0.0, _vdot(diff_updates, diff_params) / denominator,
                                1.0)
        else:  # a capped reciprocal of the gradient norm on the first step
            scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)

        indices = [(memory_idx + i) % m for i in range(m)]
        vec, alphas = grad, {}
        for idx in reversed(indices):
            alphas[idx] = rhos[idx] * _vdot(dw_mem[idx], vec)
            vec = vec - alphas[idx] * du_mem[idx]
        vec = scale * vec
        for idx in indices:
            beta = rhos[idx] * _vdot(du_mem[idx], vec)
            vec = vec + (alphas[idx] - beta) * dw_mem[idx]
        return vec, (dw_mem, du_mem, rhos)

    def step(self, params: torch.Tensor, state: LBFGSState, value_and_grad_fn: ValueAndGrad
             ) -> Tuple[torch.Tensor, LBFGSState, torch.Tensor, Any]:
        """One optax update and ``apply_updates``.  Returns the new
        parameters, the new state, and the value and aux at ``params`` (what
        the step started from: the accepted point of the last search, else
        one evaluation)."""
        evaluations = 0
        if state.value is not None:
            value, grad, aux = state.value, state.grad, state.aux
        else:
            value, grad, aux = value_and_grad_fn(params)
            evaluations += 1
        precond, ring = self._direction(grad, params, state)
        common = dict(count=state.count + 1, params=params, updates=grad,
                      diff_params_memory=ring[0], diff_updates_memory=ring[1],
                      weights_memory=ring[2])
        if self.learning_rate is not None:
            new_state = LBFGSState(
                **common, learning_rate=f32(self.learning_rate), value=None, grad=None,
                aux=None, info=state.info, evaluations=evaluations)
            return params + (-self.learning_rate) * precond, new_state, value, aux
        direction = -1.0 * precond
        point, info = self._zoom(params, direction, value, grad, aux, value_and_grad_fn)
        new_state = LBFGSState(
            **common, learning_rate=point.stepsize, value=point.value_t, grad=point.grad,
            aux=point.aux, info=info, evaluations=evaluations + info.num_linesearch_steps)
        return params + float(point.stepsize) * direction, new_state, value, aux

    def _zoom(self, params, direction, value, grad, aux, value_and_grad_fn):
        """``zoom_linesearch`` from stepsize 0 with the initial guess 1
        (optax's ``initial_guess_strategy='one'``): returns the accepted
        point and the search's info; each search step is one evaluation."""

        def on_line(stepsize):
            v, g, a = value_and_grad_fn(params + float(stepsize) * direction)
            host = torch.stack([v.detach().float(), _vdot(g, direction).float()]).cpu().numpy()
            return _Point(f32(stepsize), host[0], host[1], v, g, a)

        slope_init = f32(_vdot(direction, grad).item())
        value_init = f32(value.item())
        start = _Point(f32(0.0), value_init, slope_init, value, grad, aux)
        cur = safe = low = high = cubic_ref = start
        decrease_error = curvature_error = f32(np.inf)
        interval_found = done = failed = False
        count = 0
        with np.errstate(all="ignore"):
            while not (done or failed):
                zoom = interval_found
                if not zoom:  # algorithm 3.5: grow the stepsize until bracketed
                    new = on_line(f32(1.0) if count == 0 else INCREASE_FACTOR * cur.stepsize)
                else:  # algorithm 3.6: a cubic, quadratic or bisection point
                    delta = np.abs(high.stepsize - low.stepsize)
                    left = np.minimum(high.stepsize, low.stepsize)
                    right = np.maximum(high.stepsize, low.stepsize)
                    middle = _cubicmin(low.stepsize, low.value, low.slope, high.stepsize,
                                       high.value, cubic_ref.stepsize, cubic_ref.value)
                    if not (left + 0.2 * delta < middle < right - 0.2 * delta):
                        middle = _quadmin(low.stepsize, low.value, low.slope,
                                          high.stepsize, high.value)
                        if not (left + 0.1 * delta < middle < right - 0.1 * delta):
                            middle = (low.stepsize + high.stepsize) / 2.0
                    new = on_line(middle)
                decrease_error = _decrease_error(new.stepsize, new.value, new.slope,
                                                 value_init, slope_init)
                curvature_error = _curvature_error(new.slope, slope_init)
                done = bool(max(decrease_error, curvature_error) <= TOL)
                max_steps = count + 1 >= MAX_LINESEARCH_STEPS
                if not zoom:
                    if decrease_error <= TOL:
                        safe = new
                    set_high = decrease_error > 0.0 or (new.value >= cur.value and count > 0)
                    set_low = new.slope >= 0.0 and not set_high
                    low, high = (new, cur) if set_low else (cur, new)
                    cubic_ref = low
                    interval_found = set_high or set_low or done
                    failed = max_steps and not done
                else:
                    if decrease_error <= TOL and new.value < safe.value:
                        safe = new
                    high_to_middle = decrease_error > 0.0 or new.value >= low.value
                    high_to_low = (new.slope * (high.stepsize - low.stepsize) >= 0.0
                                   and not high_to_middle)
                    cubic_ref = high if (high_to_middle or high_to_low) else low
                    if high_to_middle:
                        high = new
                    elif high_to_low:
                        high = low
                    if not high_to_middle:
                        low = new
                    failed = (max_steps or (delta <= STEPSIZE_PRECISION and safe.stepsize > 0.0)
                              ) and not done
                cur = new
                count += 1
                if failed and (safe.stepsize > 0.0 or np.isinf(decrease_error)):
                    cur = safe  # ``_try_safe_step``: the best point with sufficient decrease
        return cur, LinesearchInfo(count, decrease_error, curvature_error)
