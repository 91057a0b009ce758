"""The numbers behind tests/test_torch_parallel*.py's floors: where the
port's sharded renders and the JAX package's part, and why JAX's sharded
functions are run eagerly there.

    JAX_PLATFORMS=cpu python tests/parallel_numerics_report.py [--renders [--only=a,b]]

Prints (1) the error of a shard's phase-increment total, JAX's
``parallel/render.py:_local_delta_total`` and the port's, against float64,
on a 110 -> 440 Hz glide of 5,168 frames (44.1 kHz, hop 512) cut into 4
shards of 1,292 frames; (2) JAX's oscillator phase under ``jax.jit``
against eager, and the jitted sharded render against the eager one, on
the 2-rank time case; with ``--renders``, (3) every render case of the
tests: the port's sharded render, JAX's own sharded function and JAX's
with the exact total, each against the unsharded oracle and each other
(the port's rank processes on CPU gloo, ~5 min); ``--only=a,b`` keeps
the named cases.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def carry_totals() -> None:
    from ddsp_tpu.parallel import render as jax_render
    from ddsp_tpu_torch.ops.interp import hop_weight_cumsum
    from ddsp_tpu_torch.parallel.render import _local_delta_total

    sr, hop, t, n = 44100, 512, 5168, 4
    f0 = (110.0 * 4.0 ** (np.arange(t + 2) / (t + 2))).astype(np.float32)
    c = hop_weight_cumsum(hop)[-1].astype(np.float32)
    w = f0 / np.float32(sr)
    delta = (w[:-2] * c[0] + w[1:-1] * c[1] + w[2:] * c[2]).astype(np.float32)
    delta = (delta - np.floor(delta)).astype(np.float64)
    local = t // n
    worst = {"jax": 0.0, "port": 0.0}
    for k in range(n):
        pad = f0[k * local:(k + 1) * local + 2][None, :, None]
        exact = np.sum(delta[k * local:(k + 1) * local]) % 1.0
        got = {"jax": float(jax_render._local_delta_total(jnp.asarray(pad), hop, sr)[0]),
               "port": float(_local_delta_total(torch.from_numpy(pad), hop, sr)[0])}
        for name, v in got.items():
            worst[name] = max(worst[name], abs((v - exact + 0.5) % 1.0 - 0.5))
    print(f"(1) a shard's phase-increment total, {n} shards of {local} frames, max |error| "
          f"(cycles): JAX {worst['jax']:.2e}, port {worst['port']:.2e}")


def jit_against_eager() -> None:
    import torch_parallel_refs as refs
    from ddsp_tpu.ops import oscillator as jax_osc
    from ddsp_tpu.ops.interp import edge_pad_frames
    from ddsp_tpu.parallel import mesh as jmesh, render as jrender
    from ddsp_tpu.config import Config as JaxConfig

    case = refs.cases()["time2"]
    conf = JaxConfig(**case["conf"])
    f0 = edge_pad_frames(jnp.asarray(case["controls"]["f0"]))[..., 0]

    def phase(f):
        return jax_osc._fundamental_phase_cycles(f, conf.hop_length, conf.sample_rate,
                                                 jnp.zeros((f.shape[0],)))

    diff = float(jnp.abs(phase(f0) - jax.jit(phase)(f0)).max())
    mesh = jmesh.make_mesh(n_time=2, devices=jax.devices()[:2])
    rev = {k: jnp.asarray(v) for k, v in case["reverb"].items()}
    ctl = {k: jnp.asarray(v) for k, v in case["controls"].items()}
    key = jax.random.PRNGKey(case["key"])
    eager = np.asarray(jrender.render_controls_sharded(rev, ctl, conf, mesh, key))
    jitted = np.asarray(jax.jit(lambda r, c, k: jrender.render_controls_sharded(
        r, c, conf, mesh, k))(rev, ctl, key))
    print(f"(2) JAX's phase under jax.jit against eager: max |diff| {diff:.2e} cycles; the "
          f"2-rank time-sharded render jitted against eager: {refs.snr(eager, jitted):.1f} dB")


def renders() -> None:
    import torch_parallel_refs as refs
    from ddsp_tpu.parallel import render as jax_render

    names = ["time2", "time4", "time8", "halo8", "long4", "pallas_time4", "tp2", "tp4",
             "tp17_4", "dp_tp_2x2", "dp_tp_decode_2x2", "time_tp_2x2", "pallas_tp2",
             "pallas_tp4", "pallas_time_tp_2x2"]
    only = [a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--only=")]
    names = [n for n in names if not only or n in only[0]]
    port = refs.spawn(names)
    for name in names:
        oracle = refs.port_unsharded(name)
        jax_own = refs.jax_render(name)
        original = jax_render._local_delta_total
        jax_render._local_delta_total = refs.exact_local_delta_total
        try:
            jax_exact = refs.jax_render(name)
        finally:
            jax_render._local_delta_total = original
        got = port.result()[name][0]
        print(f"(3) {name}: port vs oracle {refs.snr(oracle, got):.1f} dB, JAX's own vs oracle "
              f"{refs.snr(oracle, jax_own):.1f}, port vs JAX's own {refs.snr(jax_own, got):.1f}, "
              f"port vs JAX's with the exact total {refs.snr(jax_exact, got):.1f}", flush=True)


if __name__ == "__main__":
    carry_totals()
    jit_against_eager()
    if "--renders" in sys.argv:
        renders()
