"""JAX-side references of tests/test_torch_parallel*.py: the cases' seeded
inputs, JAX's sharded functions on the 8-device virtual mesh
(tests/conftest.py), the port's unsharded render, and the spawns of the
port's rank processes (tests/torch_parallel_cases.py)."""

import concurrent.futures
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_parallel_cases
from ddsp_tpu.config import Config as JaxConfig
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import decoder_apply
from ddsp_tpu_torch.models.convert import decoder_from_jax
from ddsp_tpu_torch.models.synths import reverb_impulse
from ddsp_tpu_torch.ops.fir import PRNGKey, fft_convolve, filtered_noise
from ddsp_tpu_torch.ops.oscillator import oscillator_bank
from ddsp_tpu_torch.parallel.launch import run_ranks

CONF_KW = dict(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=16, n_noise_filters=17,
    decoder_mlp_units=32, decoder_mlp_layers=1, decoder_gru_units=32, reverb_length=512,
    mss_ffts=(256, 128), batch_size=8, reverb_grad_matmul_dtype="float32",
)
# tests/test_parallel_pallas.py's config: the kernel's hop is a lane multiple
PALLAS_KW = dict(CONF_KW, sample_rate=8000, hop_length=128, batch_size=4, osc_impl="pallas")
# the sequence-parallel step: the float32 loss matmul on JAX's side, the
# form the port computes (its torch.stft)
SP_KW = dict(CONF_KW, loss_matmul_dtype="float32")
# ('data', 'time') meshes of the DP x SP step: (2, 4) is
# tests/test_parallel.py:260's; (1, 2) and (4, 2) give each axis a size-1 edge
SP_MESHES = {"sp2x4": (2, 4), "sp1x2": (1, 2), "sp4x2": (4, 2)}
SP_STEPS = 3
# the tensor-parallel steps (tests/test_torch_parallel_tp_train.py): DP x TP
# on ('data' 2, 'model' 4) at 16 harmonics and on (2, 2) at 15 (the bank
# padded to 16), DP x SP x TP on make_mesh3(2, 2, 2) (tests/test_parallel.py:308)
TP_STEPS = {"tp2x4": ((2, 4), 16), "tp2x2_h15": ((2, 2), 15), "sp3_2x2x2": ((2, 2, 2), 16)}
# the TP render's gradient: ('data' 2, 'model' 2) and 'model' 4
TP_GRADS = {"tp_grad_2x2": 2, "tp_grad_4": 1}
SPAWN_TIMEOUT = 240  # seconds for one world's spawn, start-up included


def _controls(conf_kw, b=1, t=64, seed=0, n_harmonics=None):
    rng = np.random.default_rng(seed)
    h = n_harmonics or conf_kw["n_harmonics"]
    return {
        "f0": rng.uniform(80, 500, (b, t, 1)).astype(np.float32),
        "c": rng.uniform(0.01, 1, (b, t, h)).astype(np.float32),
        "a": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "H": rng.uniform(0, 1, (b, t, conf_kw["n_noise_filters"])).astype(np.float32),
    }


def _reverb(ir_length, seed, normal=False, decay=4.0, wet=0.5):
    k = jax.random.PRNGKey(seed)
    noise = (jax.random.normal(k, (ir_length,)) if normal
             else jax.random.uniform(k, (ir_length,), minval=-1.0))
    return {"noise": np.asarray(noise), "decay": np.float32(decay), "wet": np.float32(wet)}


def _features(b, t, seed=0):
    return {
        "f0": np.random.default_rng(seed).uniform(100, 400, (b, t, 1)).astype(np.float32),
        "normalized_cents": np.random.default_rng(seed + 1).uniform(0, 1, (b, t, 1)).astype(np.float32),
        "loudness": np.random.default_rng(seed + 2).uniform(0, 1, (b, t, 1)).astype(np.float32),
    }


def sp_batch(b=4, t=16):
    """tests/test_parallel.py:266-275's batch: b rows of t frames, each
    local time shard 16 / n_time frames of 64 samples."""
    rng = np.random.default_rng(7)
    return {
        "f0": rng.uniform(100, 400, (b, t, 1)).astype(np.float32),
        "normalized_cents": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((b, t * CONF_KW["hop_length"]))).astype(np.float32),
    }


def collective_inputs(n, d=3, seed=11):
    """x (n, d): one row a rank; w (d,) replicated; c (n, n, d): each
    rank's own weights."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, d)).astype(np.float32),
            "w": rng.standard_normal(d).astype(np.float32),
            "c": rng.standard_normal((n, n, d)).astype(np.float32)}


def _jax_state(conf_kw):
    """JAX's ``init_state(PRNGKey(0))`` at the config: (parameters as numpy,
    the key as int64)."""
    from ddsp_tpu.training.trainer import init_state

    jstate = init_state(jax.random.PRNGKey(0), JaxConfig(**conf_kw))
    return (jax.tree_util.tree_map(np.asarray, jstate.params),
            np.asarray(jstate.rng).astype(np.int64))


def tp_train_cases():
    """The tensor-parallel steps' cases (tests/test_torch_parallel_tp_train.py)."""
    out = {}
    for name, (mesh, n_h) in TP_STEPS.items():
        conf = dict(SP_KW, n_harmonics=n_h)
        params, rng = _jax_state(conf)
        common = dict(conf=conf, ranks=int(np.prod(mesh)), n_data=mesh[0], steps=SP_STEPS,
                      batch=sp_batch(), params=params, rng=rng)
        out[name] = (dict(common, kind="sp", n_time=mesh[1], n_model=mesh[2]) if len(mesh) == 3
                     else dict(common, kind="tp_train"))
    ir = CONF_KW["reverb_length"]
    for name, n_data in TP_GRADS.items():
        controls = _controls(CONF_KW, b=2, t=32, seed=6)
        w = np.random.default_rng(8).standard_normal((2, 32 * CONF_KW["hop_length"]))
        out[name] = dict(kind="tp_grad", conf=CONF_KW, ranks=4, n_data=n_data,
                         controls=controls, w=w.astype(np.float32),
                         reverb=_reverb(ir, 9, normal=True, decay=2.0), key=3)
    # T = 8 over 4 time shards: 128 samples < n_fft//2 + 1 = 129; B = 3 over 2
    out["tp_errors"] = dict(kind="tp_errors", conf=SP_KW, ranks=8, params=_jax_state(SP_KW)[0],
                            short_batch=sp_batch(2, 8), odd_batch=sp_batch(3, 16))
    return out


def make_cases():
    """{name: case}: the rank-side inputs of every case ('ranks': its world
    size; 'kind': the entry point, tests/torch_parallel_cases.py)."""
    ir = CONF_KW["reverb_length"]
    conf17 = dict(CONF_KW, n_harmonics=17)
    dp_conf = JaxConfig(**CONF_KW)
    from ddsp_tpu.models.controller import decoder_init
    from ddsp_tpu.training.trainer import init_state

    jstate = init_state(jax.random.PRNGKey(0), dp_conf)
    rng = np.random.default_rng(0)
    t = dp_conf.frames_per_example
    dp_batch = {
        "f0": rng.uniform(100, 400, (8, t, 1)).astype(np.float32),
        "normalized_cents": rng.uniform(0, 1, (8, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0, 1, (8, t, 1)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((8, dp_conf.example_length))).astype(np.float32),
    }
    decoder_params = jax.tree_util.tree_map(np.asarray,
                                            decoder_init(jax.random.PRNGKey(0), dp_conf))
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    jrng = np.asarray(jstate.rng).astype(np.int64)
    time_case = dict(kind="time", conf=CONF_KW, controls=_controls(CONF_KW),
                     reverb=_reverb(ir, 1), key=3)
    pallas_rev = _reverb(ir, 1)
    return {
        "time2": dict(time_case, ranks=2),
        "time4": dict(time_case, ranks=4),
        "time8": dict(time_case, ranks=8),
        # 8 shards of 4 frames (256 samples) under a 512-sample IR: each
        # shard's halo spans its two left neighbours
        "halo8": dict(kind="time", conf=CONF_KW, ranks=8, controls=_controls(CONF_KW, t=32),
                      reverb=_reverb(ir, 2, decay=2.0, wet=1.0), key=5),
        "long4": dict(kind="long", conf=CONF_KW, ranks=4, key=7, batch=_features(1, 64),
                      params=decoder_params),
        "tp2": dict(kind="tp", conf=CONF_KW, ranks=2, controls=_controls(CONF_KW, b=2),
                    reverb=_reverb(ir, 9, normal=True, decay=2.0), key=3),
        "tp4": dict(kind="tp", conf=CONF_KW, ranks=4, controls=_controls(CONF_KW, b=2),
                    reverb=_reverb(ir, 9, normal=True, decay=2.0), key=3),
        "tp17_4": dict(kind="tp", conf=conf17, ranks=4,
                       controls=_controls(conf17, t=32, seed=5),
                       reverb=_reverb(ir, 9, normal=True, decay=2.0), key=4),
        # ('data', 'model') 2 x 2: one row a data rank, its noise at its
        # global row
        "dp_tp_2x2": dict(kind="tp", conf=CONF_KW, ranks=4, n_data=2,
                          controls=_controls(CONF_KW, b=2),
                          reverb=_reverb(ir, 9, normal=True, decay=2.0), key=3),
        "dp_tp_decode_2x2": dict(kind="tp_decode", conf=CONF_KW, ranks=4, n_data=2, key=7,
                                 batch=_features(2, 64), params=decoder_params),
        "time_tp_2x2": dict(time_case, kind="time_tp", ranks=4, n_time=2, n_model=2),
        "pallas_time4": dict(kind="time", conf=PALLAS_KW, ranks=4, impl="pallas",
                             controls=_controls(PALLAS_KW, t=16), reverb=pallas_rev, key=3),
        "pallas_tp2": dict(kind="tp", conf=PALLAS_KW, ranks=2, impl="pallas",
                           controls=_controls(PALLAS_KW, b=2, t=16),
                           reverb=_reverb(ir, 9), key=3),
        "pallas_tp4": dict(kind="tp", conf=PALLAS_KW, ranks=4, impl="pallas",
                           controls=_controls(PALLAS_KW, b=2, t=16),
                           reverb=_reverb(ir, 9), key=3),
        "pallas_time_tp_2x2": dict(kind="time_tp", conf=PALLAS_KW, ranks=4, n_time=2,
                                   n_model=2, impl="pallas",
                                   controls=_controls(PALLAS_KW, t=16), reverb=pallas_rev,
                                   key=3),
        "dp4": dict(kind="dp", conf=CONF_KW, ranks=4, steps=3, batch=dp_batch,
                    params=jparams, rng=jrng),
        **{name: dict(kind="sp", conf=SP_KW, ranks=nd * nt, n_data=nd, n_time=nt,
                      steps=SP_STEPS, batch=sp_batch(), params=jparams, rng=jrng)
           for name, (nd, nt) in SP_MESHES.items()},
        "collectives4": dict(kind="collectives", conf=CONF_KW, ranks=4, **collective_inputs(4)),
        # tests/test_parallel.py:359's short shard (8 shards of one 64-sample
        # frame < n_fft//2 + 1 = 129), T = 18 over 4 time shards, B = 3 over
        # 2 data shards
        "sp_errors": dict(kind="sp_errors", conf=SP_KW, ranks=8, params=jparams, meshes={
            "short_shard": (1, 8, sp_batch(2, 8)), "t_not_divisible": (2, 4, sp_batch(4, 18)),
            "b_not_divisible": (2, 4, sp_batch(3, 16))}),
        "shardings": dict(kind="shardings", conf=CONF_KW, ranks=4, n_data=2, n_time=2,
                          x=np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)),
        **tp_train_cases(),
    }


@functools.lru_cache(maxsize=None)
def cases():
    """The case table, made once a process, at first use (not while the
    test files are collected)."""
    return make_cases()


def spawn(names):
    """A future of {name: [each rank's result]} for the named cases: one
    spawn a world size, all of its cases, in a background thread."""
    def run():
        out = {}
        table = cases()
        for world in sorted({table[k]["ranks"] for k in names}):
            mine = {k: table[k] for k in names if table[k]["ranks"] == world}
            results = run_ranks(torch_parallel_cases.run_cases, world, (mine,),
                                device="cpu", timeout=SPAWN_TIMEOUT, group_timeout=60)
            out.update({k: [r[k] for r in results] for k in mine})
        return out

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = np.mean((want - np.asarray(got, np.float64)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(want**2) / noise))


def jax_render(name):
    """JAX's sharded function on the virtual mesh, for one render case, run
    eagerly as the JAX suite runs it (under ``jax.jit`` XLA rewrites the
    oscillator's phase prefix: 1.7e-5 cycles from the eager phase, 70 dB
    on the render); the Pallas kernel in interpret mode, as
    tests/test_parallel_pallas.py runs it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    if cases()[name].get("impl") == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(_jax_sharded(name))
    return np.asarray(_jax_sharded(name))


def _jax_sharded(name):
    from ddsp_tpu.parallel import mesh as jmesh, render as jrender, tp as jtp

    case = cases()[name]
    conf, n = JaxConfig(**case["conf"]), case["ranks"]
    devices = jax.devices()[:n]
    key = jax.random.PRNGKey(case["key"])
    impl = case.get("impl")
    n_data = case.get("n_data", 1)
    if case["kind"] == "long":
        mesh = jmesh.make_mesh(n_time=n, devices=devices)
        return jrender.render_long_audio(case["params"], case["batch"], conf, mesh, key)
    if case["kind"] == "tp_decode":
        mesh = jtp.make_dp_tp_mesh(n_data=n_data, n_model=n // n_data, devices=devices)
        return jtp.decoder_apply_tp(case["params"], case["batch"], conf, mesh, key)
    if case["kind"] == "time":
        mesh = jmesh.make_mesh(n_time=n, devices=devices)
        fn = jrender.render_controls_sharded
    elif case["kind"] == "tp":
        mesh = jtp.make_dp_tp_mesh(n_data=n_data, n_model=n // n_data, devices=devices)
        fn = jtp.render_controls_tp
    else:
        mesh = jtp.make_time_tp_mesh(case["n_time"], case["n_model"], devices=devices)
        fn = jtp.render_controls_time_tp
    rev = {k: jnp.asarray(v) for k, v in case["reverb"].items()}
    ctl = {k: jnp.asarray(v) for k, v in case["controls"].items()}
    return fn(rev, ctl, conf, mesh, key, impl=impl)


def port_unsharded(name):
    """The port's unsharded render of the case on the CPU (the exact fill,
    the JAX suite's XLA oracle)."""
    case = cases()[name]
    conf = Config(**case["conf"])
    key = PRNGKey(case["key"])
    with torch.no_grad():
        if case["kind"] in ("long", "tp_decode"):
            decoder = decoder_from_jax(case["params"], conf)
            return decoder_apply(decoder, {k: torch.from_numpy(v) for k, v in case["batch"].items()},
                                 conf, key).numpy()
        ctl = {k: torch.from_numpy(v) for k, v in case["controls"].items()}
        harm, _ = oscillator_bank(ctl["f0"], ctl["c"], ctl["a"], sample_rate=conf.sample_rate,
                                  hop=conf.hop_length)
        noise = filtered_noise(ctl["H"], key, conf.hop_length)
        reverb = torch_parallel_cases.reverb_module(case["reverb"], conf)
        imp = reverb_impulse(reverb, conf)
        return fft_convolve(harm + noise, imp[None, :], kernel_len=imp.shape[-1]).numpy()


def exact_local_delta_total(f0_pad, hop, sample_rate):
    """``ddsp_tpu/parallel/render.py:_local_delta_total`` with its float32
    sum of the shard's fractional increments made exact, as the port's
    (grid parts summed exactly, residuals apart)."""
    from ddsp_tpu.ops.interp import hop_weight_cumsum

    w = f0_pad[..., 0] / sample_rate
    csum = jnp.asarray(hop_weight_cumsum(hop))[-1]
    delta = w[:, :-2] * csum[0] + w[:, 1:-1] * csum[1] + w[:, 2:] * csum[2]
    delta = delta - jnp.floor(delta)
    hi = jnp.floor(delta * 4096.0) * (1.0 / 4096.0)
    tot_hi = jnp.sum(hi, axis=1)
    total = (tot_hi - jnp.floor(tot_hi)) + jnp.sum(delta - hi, axis=1)
    return total - jnp.floor(total)


def jax_collectives(case):
    """{name: (loss, its gradient in x, or in w for
    ``torch_parallel_cases.W_GRADS``)} of JAX's twins of
    torch_parallel_cases.collectives_case's functions:
    ``jax.value_and_grad`` through a ``jax.shard_map`` over the case's
    ranks, ``out_specs=P()`` (each loss a psum, so one invariant value).
    The ``pvary`` functions run with ``check_vma=True``, where JAX tracks
    which values vary by rank and transposes ``pvary`` (here by its new
    name, ``pcast(..., to='varying')``) into a ``psum``."""
    from jax.sharding import Mesh, PartitionSpec as P

    n = case["ranks"]
    mesh = Mesh(np.array(jax.devices()[:n]), ("i",))
    lax = jax.lax
    shift = [(i, i + 1) for i in range(n - 1)]

    def pvary(v):
        return lax.pcast(v, "i", to="varying")

    bodies = {
        "psum": lambda x, w, c: lax.psum(jnp.sum(w * x), "i"),
        "psum_squared": lambda x, w, c: lax.psum(jnp.sum(w * x * x), "i") ** 2,
        "all_gather": lambda x, w, c: lax.psum(jnp.sum(c * lax.all_gather(x, "i")), "i"),
        "ppermute_shift_edge": lambda x, w, c: lax.psum(jnp.sum(c[0] * jnp.where(
            lax.axis_index("i") == 0, 2.0 * x, lax.ppermute(x, "i", shift))), "i"),
        "ppermute_partial": lambda x, w, c: lax.psum(jnp.sum(
            c[1] * x * lax.ppermute(x, "i", [(0, 2), (3, 1)])), "i"),
        "pvary": lambda x, w, c: lax.psum(jnp.sum(c[0] * pvary(w) * x), "i"),
        "pvary_psum": lambda x, w, c: lax.psum(jnp.sum(
            c[1] * x * pvary(lax.psum(jnp.sum(pvary(w) * x), "i"))), "i"),
    }
    x, w, c = (jnp.asarray(case[k], jnp.float32) for k in ("x", "w", "c"))
    out = {}
    for name, body in bodies.items():
        f = jax.shard_map(lambda xs, w_, cs, b=body: b(xs[0], w_, cs[0]), mesh=mesh,
                          in_specs=(P("i"), P(), P("i")), out_specs=P(),
                          check_vma=name.startswith("pvary"))
        if name in torch_parallel_cases.W_GRADS:
            val, g = jax.value_and_grad(lambda w_: f(x, w_, c))(w)
        else:
            val, g = jax.value_and_grad(lambda x_: f(x_, w, c))(x)
        out[name] = (float(val), np.asarray(g))
    return out


def jax_train_steps(name, starts):
    """JAX's jitted step for the case's steps on the virtual mesh, on the
    float32 loss matmul: the DP x SP step (``ddsp_tpu.parallel.sp``) on a
    ('data', 'time') mesh or a ``make_mesh3`` one, or the DP x TP step
    (``ddsp_tpu.parallel.tp.make_tp_train_step``).  [(metrics, the
    parameters after as a port ``Decoder``, the gradient of JAX's loss at
    ``starts[i]`` (port ``Decoder`` state dicts) with step i's noise key
    as a ``Decoder``)]."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ddsp_tpu.parallel import tp as jtp
    from ddsp_tpu.parallel.mesh import make_mesh, make_mesh3
    from ddsp_tpu.parallel.sp import make_sp_loss, make_sp_train_step
    from ddsp_tpu.training.trainer import init_state, loss_fn
    from ddsp_tpu_torch.models.convert import decoder_from_state_dict, decoder_to_jax

    case = cases()[name]
    jconf, conf = JaxConfig(**case["conf"], osc_impl="xla"), Config(**case["conf"])
    devices = jax.devices()[:case["ranks"]]
    if case["kind"] == "tp_train":
        mesh = jtp.make_dp_tp_mesh(case["n_data"], case["ranks"] // case["n_data"],
                                   devices=devices)
        loss = functools.partial(loss_fn, decode=lambda p, b, c, k: jtp.decoder_apply_tp(
            p, b, c, mesh, k))
        step = jtp.make_tp_train_step(jconf, mesh)
    else:
        mesh = (make_mesh3(case["n_data"], case["n_time"], case["n_model"], devices=devices)
                if "n_model" in case else
                make_mesh(n_data=case["n_data"], n_time=case["n_time"], devices=devices))
        loss = make_sp_loss(jconf, mesh)
        step = make_sp_train_step(jconf, mesh)
    state = jax.device_put(init_state(jax.random.PRNGKey(0), jconf), NamedSharding(mesh, P()))
    batch = {k: jax.device_put(v, NamedSharding(mesh, P("data", "time") if (
        k == "audio" and case["kind"] == "sp") else P("data")))
             for k, v in case["batch"].items()}
    grad = jax.jit(jax.grad(lambda p, b, k: loss(p, b, jconf, k)[0]))

    def tree(t):
        return decoder_from_jax(jax.tree_util.tree_map(np.asarray, t), conf)

    out = []
    for start in starts:
        at = decoder_to_jax(decoder_from_state_dict(start, conf))
        g = grad(at, batch, jax.random.split(state.rng)[1])
        state, m = step(state, batch)
        out.append(({k: float(v) for k, v in m.items()}, tree(state.params), tree(g)))
    return out


# the step tests' criteria (tests/test_torch_parallel_sp.py,
# tests/test_torch_parallel_tp_train.py)
LOSS_RTOL, GRAD_NORM_RTOL, LEAF_RTOL = 1e-5, 5e-5, 2e-3
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def check_train_steps(name, ranks):
    """Hold a case's parallel steps (every rank's results) to JAX's jitted
    step and the port's single-device step, each free-running from the
    same state, and each step's gradient leaves, before Adam, to JAX's
    gradient and the single step's from the same parameters and key:
    every rank's metrics equal and its state checksum bit-equal; loss and
    terms within LOSS_RTOL relative, ``grad_norm`` within GRAD_NORM_RTOL;
    each leaf within LEAF_RTOL of its norm; the parameters after each
    step at allclose(PARAM_RTOL, PARAM_ATOL)."""
    case = cases()[name]
    conf = Config(**case["conf"])
    assert len(ranks) == case["ranks"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["checksum"], ranks[0]["checksum"])
        assert r["metrics"] == ranks[0]["metrics"]
    got = ranks[0]
    init = decoder_from_jax(case["params"], conf)
    names = [k for k, _ in init.named_parameters()]
    starts = [init.state_dict()] + [{k: torch.from_numpy(v) for k, v in p.items()}
                                    for p in got["params"][:-1]]
    jax_steps = jax_train_steps(name, starts)
    single = torch_parallel_cases.single_steps(case, starts, "cpu")
    for i, ((jm, jparams, jgrads), (fm, fparams, _, sgrads)) in enumerate(zip(jax_steps, single)):
        m = got["metrics"][i]
        assert set(m) == set(jm) == set(fm), (set(m), set(jm), set(fm))
        for want, tag in ((jm, "jax"), (fm, "single")):
            for k in m:
                rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
                _close(m[k], want[k], rtol, f"step {i} {k} vs {tag}")
        for want, tag in (([p.detach().numpy() for p in jgrads.parameters()], "jax"),
                          (sgrads, "single")):
            for k, g, w in zip(names, got["grads"][i], want):
                diff = np.linalg.norm(np.asarray(g, np.float64) - w)
                assert diff <= LEAF_RTOL * np.linalg.norm(w), (i, k, tag, diff, np.linalg.norm(w))
        for want, tag in (({k: v.numpy() for k, v in jparams.state_dict().items()}, "jax"),
                          (fparams, "single")):
            for k, v in want.items():
                np.testing.assert_allclose(got["params"][i][k], v, rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=f"step {i} {k} vs {tag}")


RENDER_GRAD_NAMES = ("c", "a", "H", "reverb.noise", "reverb.decay", "reverb.wet")


def jax_tp_render_grads(name):
    """``jax.grad`` of sum(render * w) through JAX's ``render_controls_tp``
    on the case's mesh, in the controls c, a, H and the reverb
    parameters, run eagerly as the JAX suite runs the render."""
    from ddsp_tpu.parallel import tp as jtp

    case = cases()[name]
    conf, n = JaxConfig(**case["conf"]), case["ranks"]
    mesh = jtp.make_dp_tp_mesh(n_data=case["n_data"], n_model=n // case["n_data"],
                               devices=jax.devices()[:n])
    key = jax.random.PRNGKey(case["key"])
    ctl = {k: jnp.asarray(v) for k, v in case["controls"].items()}
    rev = {k: jnp.asarray(v) for k, v in case["reverb"].items()}
    w = jnp.asarray(case["w"])

    def loss(c, a, h, rev_):
        out = jtp.render_controls_tp(rev_, dict(ctl, c=c, a=a, H=h), conf, mesh, key)
        return jnp.sum(out * w)

    gc, ga, gh, grev = jax.grad(loss, argnums=(0, 1, 2, 3))(ctl["c"], ctl["a"], ctl["H"], rev)
    return [np.asarray(g) for g in (gc, ga, gh, grev["noise"], grev["decay"], grev["wet"])]


def port_unsharded_render_grads(name):
    """The same gradients of the port's unsharded render on the CPU."""
    from ddsp_tpu_torch.models.synths import noise_apply, oscillator_apply, reverb_apply

    case = cases()[name]
    conf = Config(**case["conf"])
    ctl = {k: torch.from_numpy(v) for k, v in case["controls"].items()}
    leaves = [ctl[k].requires_grad_(True) for k in ("c", "a", "H")]
    reverb = torch_parallel_cases.reverb_module(case["reverb"], conf)
    leaves += [reverb.noise, reverb.decay, reverb.wet]
    harm, _ = oscillator_apply(ctl, conf)
    out = reverb_apply(reverb, harm + noise_apply(ctl, conf, PRNGKey(case["key"])), conf)
    grads = torch.autograd.grad((out * torch.from_numpy(case["w"])).sum(), leaves)
    return [g.numpy() for g in grads]
