"""Where the port's bf16 train step parts from the JAX package's, stage by
stage (tests/test_torch_precision.py's TINY config and weights).

    JAX_PLATFORMS=cpu python tests/precision_stages_report.py [--torch-leaky-relu]

Prints, each as a distance relative to JAX's norm: the controls (the
controller's forward at bf16, against JAX's jitted one); the cotangent of
the loss with respect to the controls, from the same controls (the
synthesis's and the loss's backward), at bf16 and at float32; the
controller's backward from the same cotangent; and the whole train
step's gradient, with the port's float32 sums of bf16 values and with
XLA CPU's per-add sums.  ``--torch-leaky-relu`` builds the port's MLPs
with ``torch.nn.LeakyReLU`` (the slope as the derivative at 0) in place of
``models/nn.LeakyReLU``.
"""

import copy
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def rel(want, got) -> float:
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


def whole(want_leaves, got_leaves):
    """(whole distance, worst leaf's) of two leaf lists."""
    want = [np.asarray(w, np.float64) for w in want_leaves]
    got = [np.asarray(g, np.float64) for g in got_leaves]
    d = np.sqrt(sum(np.sum((w - g) ** 2) for w, g in zip(want, got)))
    return d / np.sqrt(sum(np.sum(w**2) for w in want)), max(rel(w, g) for w, g in zip(want, got))


def grads_of(model):
    g = copy.deepcopy(model)
    for a, p in zip(g.parameters(), model.parameters()):
        a.data = torch.zeros_like(p) if p.grad is None else p.grad
    return g


def main(torch_leaky: bool) -> None:
    from test_torch_precision import TINY, _batch, _xla_cpu_sum

    from ddsp_tpu.config import Config as JaxConfig
    from ddsp_tpu.models import controller as jc, synths as js
    from ddsp_tpu.training import trainer as jt
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models import nn as port_nn
    from ddsp_tpu_torch.models.controller import controller_apply
    from ddsp_tpu_torch.models.convert import decoder_from_jax, decoder_to_jax
    from ddsp_tpu_torch.models.synths import noise_apply, oscillator_apply, reverb_apply
    from ddsp_tpu_torch.ops.fir import PRNGKey, split
    from ddsp_tpu_torch.training import trainer

    if torch_leaky:
        port_nn.LeakyReLU = torch.nn.LeakyReLU
    params = jc.decoder_init(jax.random.PRNGKey(3), JaxConfig(**TINY))
    jkey = jax.random.split(jax.random.PRNGKey(7))[1]
    for dtype in ("bfloat16", "float32"):
        conf = Config(**TINY, compute_dtype=dtype)
        jconf = JaxConfig(**TINY, compute_dtype=dtype, osc_impl="xla")
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)
        decoder = decoder_from_jax(jax.tree_util.tree_map(np.asarray, params), conf)
        batch = _batch(conf, conf.batch_size)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jctl = jax.jit(lambda p, b: jc.controller_apply(p, b, compute_dtype=jdt)[0])(
            params["controller"], batch)
        with torch.no_grad():
            pctl, _ = controller_apply(decoder.controller, tb, compute_dtype=tdt)
        print(f"[{dtype}] controls forward: " + ", ".join(
            f"{k} {rel(jctl[k], pctl[k].numpy()):.2e}" for k in "caH"))

        def jloss(ctl, p):
            def decode(pp, b, c_, key):
                harm, _ = js.oscillator_apply(ctl, c_)
                return js.reverb_apply(pp["reverb"], harm + js.noise_apply(ctl, c_, key), c_)
            return jt.loss_fn(p, batch, jconf, jkey, decode=decode)[0]

        jct = jax.jit(jax.grad(jloss))(jctl, params)
        ctl = {k: torch.tensor(np.asarray(v), requires_grad=k != "f0") for k, v in jctl.items()}

        def pdecode(pp, b, c_, key):
            harm, _ = oscillator_apply(ctl, c_)
            return reverb_apply(pp.reverb, harm + noise_apply(ctl, c_, key), c_)

        model = copy.deepcopy(decoder)
        loss, _ = trainer.loss_fn(model, tb, conf, split(PRNGKey(7))[1], decode=pdecode)
        loss.backward()
        print(f"[{dtype}] d loss / d controls from the same controls: " + ", ".join(
            f"{k} {rel(jct[k], ctl[k].grad.numpy()):.2e}" for k in "caH"))

        ct = {k: jct[k] for k in "caH"}
        jg = jax.jit(lambda p, c: jax.vjp(lambda q: {
            k: v for k, v in jc.controller_apply(q, batch, compute_dtype=jdt)[0].items()
            if k != "f0"}, p)[1](c)[0])(params["controller"], ct)
        jgrads = jax.jit(jax.grad(lambda p: jt.loss_fn(p, batch, jconf, jkey)[0]))(params)
        for sums in ("float32", "xla_cpu"):
            if sums == "xla_cpu":
                port_nn._rounded_sum = _xla_cpu_sum
            model = copy.deepcopy(decoder)
            out, _ = controller_apply(model.controller, tb, compute_dtype=tdt)
            torch.autograd.backward([out[k] for k in "caH"],
                                    [torch.from_numpy(np.asarray(ct[k])) for k in "caH"])
            got = jax.tree_util.tree_leaves(decoder_to_jax(grads_of(model))["controller"])
            w, worst = whole(jax.tree_util.tree_leaves(jg), got)
            print(f"[{dtype}, {sums} sums] controller backward from the same cotangent: "
                  f"whole {w:.2e}, worst leaf {worst:.2e}")
            model = copy.deepcopy(decoder)
            loss, _ = trainer.loss_fn(model, tb, conf, split(PRNGKey(7))[1])
            loss.backward()
            w, worst = whole(jax.tree_util.tree_leaves(jgrads),
                             jax.tree_util.tree_leaves(decoder_to_jax(grads_of(model))))
            print(f"[{dtype}, {sums} sums] the train step's gradient: whole {w:.2e}, "
                  f"worst leaf {worst:.2e}")
        port_nn._rounded_sum = _rounded_sum


if __name__ == "__main__":
    from ddsp_tpu_torch.models.nn import _rounded_sum

    main("--torch-leaky-relu" in sys.argv)
