"""Rank-side cases of tests/test_torch_parallel*.py and the card test of
tests/test_torch_multihost.py: each rank process runs the port's parallel
entry points (``ddsp_tpu_torch.parallel``) on seeded inputs the test
made.  Imports torch and the port only (no jax), so the rank processes
start quickly; ``ddsp_tpu_torch.parallel.launch.run_ranks`` calls
:func:`run_cases` and :func:`on_card`.
"""

import numpy as np
import torch


def reverb_module(np_params, conf):
    """A port ``Reverb`` holding the JAX package's reverb parameters."""
    from ddsp_tpu_torch.models.synths import Reverb

    reverb = Reverb(conf)
    with torch.no_grad():
        for k in ("noise", "decay", "wet"):
            getattr(reverb, k).copy_(torch.as_tensor(np.array(np_params[k])))
    return reverb


def _full_time(local, mesh):
    from ddsp_tpu_torch.parallel.mesh import gather_time

    return gather_time(local, mesh).cpu().numpy()


def _case(case, dev):
    """One case on this rank: its result (rank order is kept by the caller),
    or None where this rank is outside the case's mesh."""
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.convert import decoder_from_jax
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel import mesh as pmesh, render, sp, tp, train

    kind, conf = case["kind"], Config(**case["conf"])
    ranks = range(case["ranks"])
    key = PRNGKey(case.get("key", 0))
    if kind == "time":
        mesh = pmesh.make_mesh(n_time=case["ranks"], ranks=ranks)
        if mesh.coords is None:
            return None
        local = render.render_controls_sharded(
            reverb_module(case["reverb"], conf), case["controls"], conf, mesh, key,
            impl=case.get("impl"), device=dev)
        return _full_time(local, mesh)
    if kind == "long":
        mesh = pmesh.make_mesh(n_time=case["ranks"], ranks=ranks)
        if mesh.coords is None:
            return None
        decoder = decoder_from_jax(case["params"], conf)
        return _full_time(render.render_long_audio(decoder, case["batch"], conf, mesh, key,
                                                   device=dev), mesh)
    if kind in ("tp", "tp_decode"):
        n_data = case.get("n_data", 1)
        mesh = tp.make_dp_tp_mesh(n_data=n_data, n_model=case["ranks"] // n_data, ranks=ranks)
        if mesh.coords is None:
            return None
        if kind == "tp":
            rows = tp.render_controls_tp(reverb_module(case["reverb"], conf), case["controls"],
                                         conf, mesh, key, impl=case.get("impl"), device=dev)
        else:
            rows = tp.decoder_apply_tp(decoder_from_jax(case["params"], conf), case["batch"],
                                       conf, mesh, key, device=dev)
        return pmesh.gather_batch(rows, mesh).cpu().numpy()
    if kind == "time_tp":
        mesh = tp.make_time_tp_mesh(case["n_time"], case["n_model"], ranks=ranks)
        if mesh.coords is None:
            return None
        local = tp.render_controls_time_tp(
            reverb_module(case["reverb"], conf), case["controls"], conf, mesh, key,
            impl=case.get("impl"), device=dev)
        return _full_time(local, mesh)
    if kind in ("dp", "sp", "tp_train"):
        n_data = case.get("n_data", case["ranks"])
        if kind == "tp_train":
            mesh = tp.make_dp_tp_mesh(n_data=n_data, n_model=case["ranks"] // n_data,
                                      ranks=ranks)
        elif "n_model" in case:
            mesh = pmesh.make_mesh3(n_data, case["n_time"], case["n_model"], ranks=ranks)
        else:
            mesh = pmesh.make_mesh(n_data=n_data, n_time=case.get("n_time", 1), ranks=ranks)
        if mesh.coords is None:
            return None
        if kind == "sp":
            step = sp.make_sp_train_step(conf, mesh, device=dev)
            batch = sp.shard_sp_batch(case["batch"], mesh, device=dev)
        else:
            make = train.make_parallel_train_step if kind == "dp" else tp.make_tp_train_step
            step = make(conf, mesh, device=dev)
            batch = train.shard_batch(case["batch"], mesh, device=dev)
        return train_steps(case, conf, mesh, step, batch, dev)
    if kind == "tp_grad":
        return tp_grad_case(case, conf, dev)
    if kind == "tp_errors":
        return tp_errors_case(case, conf, dev)
    if kind == "shardings":
        mesh = pmesh.make_mesh(n_data=case["n_data"], n_time=case["n_time"], ranks=ranks)
        if mesh.coords is None:
            return None
        x = torch.as_tensor(case["x"], device=dev)
        rows = pmesh.batch_sharding(x, mesh)
        frames = pmesh.time_sharding(x, mesh, axis=1)
        mine = torch.full((3,), float(torch.distributed.get_rank()), device=dev)
        return {"rows": rows.cpu().numpy(), "gathered_rows": pmesh.gather_batch(rows, mesh).cpu().numpy(),
                "frames": frames.cpu().numpy(),
                "gathered_frames": pmesh.gather_time(frames, mesh, axis=1).cpu().numpy(),
                "replicated": pmesh.replicated(mine, mesh).cpu().numpy()}
    if kind == "collectives":
        return collectives_case(case, dev)
    if kind == "sp_errors":
        return sp_errors_case(case, conf, dev)
    raise ValueError(f"unknown case {kind!r}")


def recorded_grads():
    """(list, restore): every gradient list the optimizer takes from now
    on is appended to the list (as float64 CPU arrays), until restore()."""
    from ddsp_tpu_torch.training import trainer

    opt_step, grads = trainer.AdamPlateau.step, []

    def recording(self, params, g, state, value):
        grads.append([t.detach().double().cpu().numpy() for t in g])
        return opt_step(self, params, g, state, value)

    trainer.AdamPlateau.step = recording
    return grads, lambda: setattr(trainer.AdamPlateau, "step", opt_step)


def case_state(case, conf, dev, params=None, rng=None):
    """A fresh train state on ``dev`` from the case's JAX-tree parameters
    and key, or from a ``Decoder`` state dict and a key."""
    from ddsp_tpu_torch.models.convert import decoder_from_jax, decoder_from_state_dict
    from ddsp_tpu_torch.training import trainer

    decoder = (decoder_from_jax(case["params"], conf) if params is None
               else decoder_from_state_dict(params, conf)).to(dev)
    return trainer.TrainState(0, decoder, trainer.make_optimizer(conf).init(
        list(decoder.parameters())), torch.as_tensor(case["rng"] if rng is None else rng,
                                                     dtype=torch.int64, device=dev))


def train_steps(case, conf, mesh, step, batch, dev):
    """``case['steps']`` steps of a parallel train step from the case's
    replicated state: each step's metrics, the gradients Adam took, the
    parameters after it and every hand kernel's launches in it (K1's and
    K2's also by option set), and the state's checksum at the end."""
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts
    from ddsp_tpu_torch.parallel import train

    state = train.shard_state(case_state(case, conf, dev), mesh)
    metrics, params, counts = [], [], []
    grads, restore = recorded_grads()
    try:
        for _ in range(case["steps"]):
            reset_launch_counts()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            counts.append({**{k: v for k, v in launch_counts().items() if v},
                           **osc_frames.VARIANT_LAUNCHES})
            params.append({k: v.detach().cpu().numpy().copy()
                           for k, v in state.params.state_dict().items()})
    finally:
        restore()
    return {"metrics": metrics, "params": params, "grads": grads, "counts": counts,
            "checksum": train.state_checksum(state).cpu().numpy()}


def single_steps(case, starts, dev):
    """The port's single-device train step on the case's whole batch on
    ``dev``: [(metrics, the parameters after) of the free-running steps
    from the case's state, (metrics, the gradients Adam took) of one step
    from ``starts[i]`` (``Decoder`` state dicts) with step i's key]."""
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.training import trainer

    conf = Config(**case["conf"])
    step = trainer.make_train_step(conf)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in case["batch"].items()}
    state = case_state(case, conf, dev)
    grads, restore = recorded_grads()
    out = []
    try:
        for start in starts:
            rng = state.rng
            state, m = step(state, batch)
            free = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu().numpy().copy()
                     for k, v in state.params.state_dict().items()})
            _, m_at = step(case_state(case, conf, dev, start, rng), batch)
            out.append((*free, {k: float(v) for k, v in m_at.items()}, grads[-1]))
    finally:
        restore()
    return out


# the collectives' functions differentiated in w (replicated) rather than x
W_GRADS = ("pvary",)


def collectives_case(case, dev):
    """The differentiable collectives on a time group of ``case['ranks']``:
    {name: (this rank's loss, its gradient in x, or in w for the names in
    ``W_GRADS``)} for each function below, every loss a psum over the
    group, so each is the one global value (their JAX twins:
    ``torch_parallel_refs.jax_collectives``)."""
    from ddsp_tpu_torch.parallel import mesh as pmesh
    from ddsp_tpu_torch.parallel.collectives import (all_gather, axis_index, axis_size,
                                                     ppermute, psum, pvary, rank_mask)

    mesh = pmesh.make_mesh(n_time=case["ranks"], ranks=range(case["ranks"]))
    if mesh.coords is None:
        return None
    group = mesh.groups[pmesh.TIME_AXIS]
    r, n = axis_index(group), axis_size(group)
    c = torch.as_tensor(case["c"][r], device=dev)  # (n, d): this rank's weights
    fns = {
        "psum": lambda x, w: psum((w * x).sum(), group),
        "psum_squared": lambda x, w: psum((w * x * x).sum(), group) ** 2,
        "all_gather": lambda x, w: psum((c * all_gather(x, group)).sum(), group),
        "ppermute_shift_edge": lambda x, w: psum((c[0] * torch.where(
            rank_mask(r == 0, x), 2.0 * x,
            ppermute(x, group, [(i, i + 1) for i in range(n - 1)]))).sum(), group),
        "ppermute_partial": lambda x, w: psum((c[1] * x * ppermute(
            x, group, [(0, 2), (3, 1)])).sum(), group),
        # a replicated value entering each rank's own product
        "pvary": lambda x, w: psum((c[0] * pvary(w, group) * x).sum(), group),
        # an invariant sum scaling each rank's own values (the TP render's
        # Nyquist denominator)
        "pvary_psum": lambda x, w: psum((c[1] * x * pvary(
            psum((w * x).sum(), group), group)).sum(), group),
    }
    out = {}
    for name, fn in fns.items():
        x = torch.as_tensor(case["x"][r], device=dev).requires_grad_(name not in W_GRADS)
        w = torch.as_tensor(case["w"], device=dev).requires_grad_(name in W_GRADS)
        loss = fn(x, w)
        (g,) = torch.autograd.grad(loss, w if name in W_GRADS else x)
        out[name] = (float(loss.detach()), g.cpu().numpy())
    return out


def run_cases(rank, dev, cases):
    """{case name: this rank's result} for every case, in order."""
    torch.set_num_threads(1)
    return {name: _case(case, dev) for name, case in cases.items()}


def on_card(rank, dev, case):
    """One case on this rank with K1's launches recorded: {'out', 'counts'
    (every hand kernel's launches), 'h_starts' and 'fills' of K1's}."""
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts

    launch, h_starts, fills = osc_frames.osc_frames_fwd, [], []

    def recorded(phase, amps_pad, loud_pad, h_start=0, fill="exact", *args, **kwargs):
        h_starts.append(int(h_start))
        fills.append(fill)
        return launch(phase, amps_pad, loud_pad, h_start, fill, *args, **kwargs)

    osc_frames.osc_frames_fwd = recorded
    try:
        reset_launch_counts()
        out = _case(case, dev)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        osc_frames.osc_frames_fwd = launch
    return {"out": out, "counts": counts, "h_starts": h_starts, "fills": fills}


def unsharded_render(case, conf, device):
    """The case's controls rendered unsharded on ``device`` (the card's
    default fill there)."""
    from ddsp_tpu_torch.models.synths import noise_apply, oscillator_apply, reverb_apply
    from ddsp_tpu_torch.ops.fir import PRNGKey

    ctl = {k: torch.as_tensor(v, device=device) for k, v in case["controls"].items()}
    with torch.no_grad():
        harm, _ = oscillator_apply(ctl, conf)
        dry = harm + noise_apply(ctl, conf, PRNGKey(case.get("key", 0), device=device))
        return reverb_apply(reverb_module(case["reverb"], conf).to(device), dry, conf).cpu().numpy()


def sp_errors_case(case, conf, dev):
    """{name: the ValueError's message, or None where none was raised} of
    the DP x SP step's refusals (tests/test_torch_parallel_sp.py)."""
    from ddsp_tpu_torch.models.convert import decoder_from_jax
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel import mesh as pmesh, sp, tp

    decoder = decoder_from_jax(case["params"], conf)
    out = {}
    for name, (n_data, n_time, batch) in case["meshes"].items():
        mesh = pmesh.make_mesh(n_data=n_data, n_time=n_time, ranks=range(case["ranks"]))
        try:
            part = sp.shard_sp_batch(batch, mesh, device=dev)
            sp.make_sp_loss(conf, mesh)(decoder, part, conf, PRNGKey(0))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["data_model_mesh"] = _refusal(lambda: sp.make_sp_loss(
        conf, tp.make_dp_tp_mesh(2, case["ranks"] // 2, ranks=range(case["ranks"]))))
    return out


def _refusal(fn):
    """The ValueError's message of ``fn()``, or None where none was raised."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def tp_grad_case(case, conf, dev):
    """The harmonic-sharded render's gradient on a ('data', 'model') mesh:
    {'grads': [d/dc, d/da, d/dH, d/d reverb noise, decay, wet]} of the
    global loss sum(render * w), each rank's gradient of its rows' part
    summed over 'data' (the global gradient, on every rank)."""
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel import mesh as pmesh, tp
    from ddsp_tpu_torch.parallel.collectives import psum

    n_data = case.get("n_data", 1)
    mesh = tp.make_dp_tp_mesh(n_data=n_data, n_model=case["ranks"] // n_data,
                              ranks=range(case["ranks"]))
    if mesh.coords is None:
        return None
    reverb = reverb_module(case["reverb"], conf).to(dev)
    ctl = {k: torch.as_tensor(v, device=dev) for k, v in case["controls"].items()}
    leaves = [ctl[k].requires_grad_(True) for k in ("c", "a", "H")]
    leaves += [reverb.noise, reverb.decay, reverb.wet]
    rows = {k: tp._rows(v, mesh) for k, v in ctl.items()}
    row_offset = mesh.coords[pmesh.DATA_AXIS] * rows["f0"].shape[0]
    out = tp._render_tp_rows(reverb, rows, conf, mesh, PRNGKey(case["key"], device=dev), None,
                             row_offset)
    loss = (out * tp._rows(torch.as_tensor(case["w"], device=dev), mesh)).sum()
    grads = torch.autograd.grad(loss, leaves)
    return {"grads": [psum(g, mesh.groups[pmesh.DATA_AXIS]).cpu().numpy() for g in grads]}


def tp_errors_case(case, conf, dev):
    """{name: the ValueError's message, or None} of the tensor-parallel
    steps' refusals on ``case['ranks']`` ranks (8): B not divisible by
    'data', a 3-axis time shard too short for the STFT halo, a ('data',
    'model') mesh given to the SP loss, a mesh without 'model' given to
    the TP step."""
    from ddsp_tpu_torch.models.convert import decoder_from_jax
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel import mesh as pmesh, sp, tp, train

    ranks = range(case["ranks"])
    decoder = decoder_from_jax(case["params"], conf).to(dev)
    dp_tp = tp.make_dp_tp_mesh(2, 4, ranks=ranks)
    mesh3 = pmesh.make_mesh3(1, 4, 2, ranks=ranks)
    dp = pmesh.make_mesh(n_data=case["ranks"], ranks=ranks)

    def short_shard():
        part = sp.shard_sp_batch(case["short_batch"], mesh3, device=dev)
        sp.make_sp_loss(conf, mesh3)(decoder, part, conf, PRNGKey(0, device=dev))

    def b_not_divisible():
        step = tp.make_tp_train_step(conf, dp_tp, device=dev)
        step(None, train.shard_batch(case["odd_batch"], dp_tp, device=dev))

    return {"b_not_divisible": _refusal(b_not_divisible),
            "short_shard_3axis": _refusal(short_shard),
            "data_model_mesh_sp": _refusal(lambda: sp.make_sp_loss(conf, dp_tp)),
            "no_model_axis_tp": _refusal(lambda: tp.make_tp_train_step(conf, dp, device=dev))}
