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
    from ddsp_tpu_torch.parallel import mesh as pmesh, render, tp, train

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
    if kind == "dp":
        mesh = pmesh.make_mesh(n_data=case["ranks"], ranks=ranks)
        if mesh.coords is None:
            return None
        from ddsp_tpu_torch.training import trainer

        decoder = decoder_from_jax(case["params"], conf)
        state = trainer.TrainState(0, decoder, trainer.make_optimizer(conf).init(
            list(decoder.parameters())), torch.as_tensor(case["rng"], dtype=torch.int64))
        state = train.shard_state(state, mesh)
        step = train.make_parallel_train_step(conf, mesh, device=dev)
        batch = train.shard_batch(case["batch"], mesh, device=dev)
        metrics, params = [], []
        for _ in range(case["steps"]):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            params.append({k: v.detach().cpu().numpy().copy()
                           for k, v in state.params.state_dict().items()})
        return {"metrics": metrics, "params": params,
                "checksum": train.state_checksum(state).cpu().numpy()}
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
    raise ValueError(f"unknown case {kind!r}")


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
