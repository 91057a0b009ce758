"""Where a serving slot's difference from its lone stream comes from.

    python -m ddsp_tpu_torch.utils.slot_parity [--slots=256] [--hops=100]
        [--check=0,1,255] [--device=cuda|cpu] [--out=FILE.json]

``chip_smoke.py`` phase 3 holds slots of a ``MultiStreamServer`` against
lone single-stream runs (``runtime/streaming.py``).  At full ``Config()``
width with seeded random weights and tone blocks (as phase 3 drives it),
for ``osc_impl`` 'auto' and 'xla', this measures for each checked slot i:

* ``slot_vs_lone1``: max |slot i - the lone stream at batch 1|, phase 3's
  comparison;
* ``slot_vs_loneN``: against the lone stream at the server's batch N,
  slot i's blocks in every row, row 0 read (its noise key is slot i's);
* ``lone1_vs_loneN``: the lone stream against itself at batch 1 and N;
* ``probes``: over every hop of the batch-1 stream, each stage run on
  that stream's own inputs once at batch 1 and once on the inputs
  replicated to N rows, max |row 0 - batch 1|: features (CREPE and
  loudness), controller, oscillator (K5 on the card), filtered noise,
  reverb, and the whole synthesis hop.

A stage whose probe is 0 computes a row the same at any batch size; the
others round differently at batch 1 and at batch N (different library
kernels for the two shapes).  Prints one JSON object and, given
``--out``, writes it to that file.  Full width needs a CUDA device;
``--device=cpu`` runs the same at the small width of the CPU tests.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import numpy as np
import torch

from ddsp_tpu_torch.config import Config

PROBES = ("features", "controller", "oscillator", "noise", "reverb", "hop")
# the CPU tests' serving width (tests/test_torch_serving.py)
SMALL = dict(sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
             decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16,
             reverb_length=300, crepe_window=1024, crepe_sample_rate=16000)


def tone_blocks(n_streams: int, n_hops: int, hop: int, sample_rate: int, seed: int):
    """(n_hops, N, hop) float32: a tone per stream (110-880 Hz) plus noise."""
    rng = np.random.default_rng(seed)
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.0, (n_streams, 1))
    t = np.arange(n_hops * hop) / sample_rate
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((n_streams, t.size))
    return x.astype(np.float32).reshape(n_streams, n_hops, hop).transpose(1, 0, 2).copy()


def lone_stream(params, crepe, conf, key, blocks, device, batch: int = 1,
                flush: bool = False):
    """Single-stream oracle over one slot's (n_hops, hop) blocks, run on
    ``batch`` copies of the stream: row 0's audio (n_hops, hop), with the
    flush step's tail hop as one more row if ``flush``, and the CREPE
    pitch bin of every frame."""
    from ddsp_tpu_torch.runtime import streaming

    feat_step = streaming.make_feature_stream_step(crepe, conf)
    synth_step = streaming.make_synth_stream_step(params, conf, key)
    fs = streaming.feature_stream_init(conf, batch=batch, device=device)
    ss = streaming.synth_stream_init(conf, batch=batch, device=device)
    outs, bins = [], []
    for b in blocks:
        x = torch.from_numpy(b).to(device).reshape(1, -1).expand(batch, -1).contiguous()
        frame, fs = feat_step(fs, x)
        out, ss = synth_step(ss, frame)
        outs.append(out[0].cpu().numpy())
        bins.append(round(float(frame["normalized_cents"][0, 0, 0]) * 359))
    if flush:
        outs.append(streaming.make_synth_stream_flush(params, conf, key)(ss)[0][0].cpu().numpy())
    return np.stack(outs), np.array(bins)


def _rows(x, n: int, axis: int = 0):
    """``x`` (a tensor, dict or NamedTuple of them) with its batch axis
    repeated to n rows; the GRU state's batch axis is its second."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 0:
            return x
        reps = [1] * x.dim()
        reps[axis] = n
        return x.repeat(*reps)
    if isinstance(x, dict):
        return {k: _rows(v, n, axis) for k, v in x.items()}
    return type(x)(*(_rows(getattr(x, f), n, 1 if f == "hidden" else axis) for f in x._fields))


def _max_diff(row0, one) -> float:
    if isinstance(one, dict):
        return max(_max_diff(row0[k], one[k]) for k in one)
    return float((row0[:1] - one).abs().max())


@torch.no_grad()
def stage_probes(params, crepe, conf, key, blocks, device, n: int) -> Dict[str, float]:
    """Each stage of the lone stream's hops on its own inputs at batch 1
    and replicated to ``n`` rows: max |row 0 - batch 1| per stage."""
    from ddsp_tpu_torch.models.controller import controller_apply
    from ddsp_tpu_torch.models.synths import osc_fill, reverb_ir_spectra, reverb_live
    from ddsp_tpu_torch.ops.fir import filtered_noise
    from ddsp_tpu_torch.ops.oscillator import render_hop_rows
    from ddsp_tpu_torch.runtime import streaming

    feat_step = streaming.make_feature_stream_step(crepe, conf)
    synth_step = streaming.make_synth_stream_step(params, conf, key)
    ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)
    fill = osc_fill(conf.osc_impl, device)
    fs = streaming.feature_stream_init(conf, device=device)
    ss = streaming.synth_stream_init(conf, device=device)
    worst = dict.fromkeys(PROBES, 0.0)

    def probe(name, fn, *args):
        one = fn(*args)
        worst[name] = max(worst[name], _max_diff(fn(*(_rows(a, n) for a in args)), one))
        return one

    for b in blocks:
        x = torch.from_numpy(b).to(device).reshape(1, -1)
        frame = probe("features", lambda s, y: feat_step(s, y)[0], fs, x)
        probe("hop", lambda s, f: synth_step(s, f)[0], ss, frame)
        if int(ss.n_seen) >= 1:  # a hop is rendered: probe its stages
            ctrl = probe("controller", lambda f, s: controller_apply(
                params.controller, f, s.hidden)[0], frame, ss)
            pad = [torch.cat([ss.prev[k], ss.cur[k], ctrl[k]], dim=1) for k in ("f0", "c", "a")]
            harm = probe("oscillator", lambda f0, c, a, p: render_hop_rows(
                f0, c, a, sample_rate=conf.sample_rate, hop=conf.hop_length,
                initial_phase=p, fill=fill)[0], *pad, ss.phase)
            noise = probe("noise", lambda h: filtered_noise(
                h, key, conf.hop_length, frame_offset=ss.n_seen - 1), ss.pending["H"])
            probe("reverb", lambda s, y: reverb_live(params.reverb, s, y, conf, ir_spec=ir_spec)[0],
                  ss.reverb_hist, harm + noise)
        frame, fs = feat_step(fs, x)
        _, ss = synth_step(ss, frame)
    return worst


def run(device, conf: Config, n_slots: int, hops: int, check: Sequence[int], seed: int = 0,
        impls: Sequence[str] = ("auto", "xla")) -> Dict:
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.ops.fir import PRNGKey, fold_in
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer

    params, crepe = decoder_init(conf, seed=seed), crepe_init(conf.crepe_capacity, seed=seed + 1)
    params, crepe = params.to(device).eval(), crepe.to(device).eval()
    blocks = tone_blocks(n_slots, hops, conf.hop_length, conf.sample_rate, seed)
    key = PRNGKey(seed, device)
    result = {"slots": n_slots, "hops": hops, "seed": seed}
    for impl in impls:
        conf_i = conf.replace(osc_impl=impl)
        server = MultiStreamServer(params, crepe, conf_i, n_slots, noise_seed=seed, device=device)
        out = np.stack([server.process(b) for b in blocks], axis=1)
        del server
        per_slot = {}
        for i in check:
            k = fold_in(key, i)
            one, _ = lone_stream(params, crepe, conf_i, k, blocks[:, i], device)
            many, _ = lone_stream(params, crepe, conf_i, k, blocks[:, i], device, batch=n_slots)
            per_slot[str(i)] = dict(
                slot_vs_lone1=float(np.abs(out[i] - one).max()),
                slot_vs_loneN=float(np.abs(out[i] - many).max()),
                lone1_vs_loneN=float(np.abs(one - many).max()),
                peak=float(np.abs(one).max()),
                probes=stage_probes(params, crepe, conf_i, k, blocks[:, i], device, n_slots))
        result[impl] = per_slot
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--slots", type=int, default=256)
    p.add_argument("--hops", type=int, default=100)
    p.add_argument("--check", default="0,1,255")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("slot_parity: no CUDA device (pass --device=cpu)")
    conf = Config() if device.type == "cuda" else Config(**SMALL)
    check = [int(i) for i in args.check.split(",")]
    result = run(device, conf, args.slots, args.hops, check)
    if device.type == "cuda":
        from ddsp_tpu_torch.utils.profiling import card_name

        result["device"] = card_name(device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
