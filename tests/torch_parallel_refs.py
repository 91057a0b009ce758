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
                    params=jax.tree_util.tree_map(np.asarray, jstate.params),
                    rng=np.asarray(jstate.rng).astype(np.int64)),
        "shardings": dict(kind="shardings", conf=CONF_KW, ranks=4, n_data=2, n_time=2,
                          x=np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)),
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


