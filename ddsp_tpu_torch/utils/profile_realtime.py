"""Where one real-time stream's hop time goes on the GPU, and what
disturbs it.

    python -m ddsp_tpu_torch.utils.profile_realtime [--hops=200] [--window=1]
        [--out=FILE.json]

At the full default ``Config()`` width with seeded random weights, batch 1,
in this order:

1. ``lone_steps``: the feature and synth stream steps of
   ``runtime/streaming.py``, a hop as ``BlockSynthesizer.process`` runs
   it (copy in, the two steps, copy back), one call a hop of tone plus
   noise, back to back;
2. ``block``: ``BlockSynthesizer.process`` over the same hops, each hop
   alternated with row 1's (each goes first on every other hop), so that
   the host's drift through the run falls on both;
3. ``loopback``: ``run_file_loopback`` over a 2 s WAV, each of the
   ``process`` calls it makes;
4. ``threaded``: ``ThreadedSynthesizer`` with hops pushed at the hop's
   pace, each ``process`` call of its worker, and the underruns;
5. ``multistream_1``: ``MultiStreamServer(n_streams=1)`` over the same
   hops, and how far its output is from the lone stream that its slot 0
   equals (noise key ``fold_in(key, 0)``); how far ``BlockSynthesizer``
   is from the lone steps keyed ``PRNGKey(0)``;
6. a ``torch.profiler`` window over rows 1, 2 and 5: kernel launches and
   the card's busy time a hop (``--window=0`` leaves it out);
7. rows 1-5 again, after the profiler windows have closed.

Each timed row gives the per-call median, p90, p99 and max in ms and the
calls at or over the hop's deadline (hop / sample rate).  Prints one JSON
object and, given ``--out``, writes it to that file.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer
from ddsp_tpu_torch.utils.profiling import card_name


class TimedBlockSynthesizer(BlockSynthesizer):
    """A ``BlockSynthesizer`` that keeps the wall time of every ``process``
    call in ``call_ms``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.call_ms = []

    def process(self, block: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = super().process(block)
        self.call_ms.append(1e3 * (time.perf_counter() - t0))
        return out


class timed_synthesizers:
    """Within this context ``run_file_loopback`` and ``ThreadedSynthesizer``
    build a :class:`TimedBlockSynthesizer`; ``made`` lists each one built."""

    def __enter__(self):
        from ddsp_tpu_torch.runtime import jack_io, threaded

        self.made, self._modules = [], (jack_io, threaded)
        made = self.made

        class Recorded(TimedBlockSynthesizer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        for m in self._modules:
            m.BlockSynthesizer = Recorded
        return self

    def __exit__(self, *exc):
        for m in self._modules:
            m.BlockSynthesizer = BlockSynthesizer


def call_stats(ms, deadline_ms: float) -> dict:
    """Per-call median, p90, p99 and max, and the calls at or over the
    deadline."""
    a = np.asarray(ms, np.float64)
    return {"calls": int(a.size), "median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)), "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()), "missed": int((a >= deadline_ms).sum())}


def run_threaded(params, crepe, conf, blocks, device) -> dict:
    """Hops pushed at the hop's pace; the worker's calls and the underruns."""
    from ddsp_tpu_torch.runtime.threaded import ThreadedSynthesizer

    hop, sr = conf.hop_length, conf.sample_rate
    with timed_synthesizers() as made:
        synth = ThreadedSynthesizer(params, crepe, conf, device=device)
    try:
        t_start = time.perf_counter()
        for i, b in enumerate(blocks):
            time.sleep(max(0.0, t_start + i * hop / sr - time.perf_counter()))
            synth.push(b)
            synth.pull(hop)
        deadline = time.monotonic() + 60.0
        while synth._synth.blocks < len(blocks) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        synth.close()
    return {"call_ms": made.made[0].call_ms, "underruns": synth.underruns}


def run_loopback(params, crepe, conf, device, seed: int, seconds: float) -> dict:
    """``run_file_loopback`` over a WAV of tone plus noise."""
    from ddsp_tpu_torch.data.audio_io import write_wav
    from ddsp_tpu_torch.runtime.jack_io import run_file_loopback
    from ddsp_tpu_torch.utils.slot_parity import tone_blocks

    hop, sr = conf.hop_length, conf.sample_rate
    with tempfile.TemporaryDirectory() as tmp:
        in_path, out_path = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        write_wav(in_path, tone_blocks(1, int(seconds * sr) // hop, hop, sr, seed).reshape(-1),
                  sr)
        with timed_synthesizers() as made:
            stats = run_file_loopback(params, crepe, conf, in_path, out_path, device=device)
    return {"call_ms": made.made[0].call_ms, **stats}


def lone_steps(params, crepe, conf, device, noise_seed: int = 0):
    """block -> block: the feature and synth stream steps keyed
    ``PRNGKey(noise_seed)``, with the copies ``BlockSynthesizer.process``
    makes."""
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.runtime import streaming

    feat = streaming.make_feature_stream_step(crepe, conf)
    synth = streaming.make_synth_stream_step(params, conf, PRNGKey(noise_seed, device))
    state = [streaming.feature_stream_init(conf, device=device),
             streaming.synth_stream_init(conf, device=device)]
    # library algorithms picked before the first timed call, as
    # BlockSynthesizer does; the state this produces is discarded
    synth(state[1], feat(state[0], torch.zeros((1, conf.hop_length), device=device))[0])

    def step(block):
        x = torch.tensor(np.asarray(block, np.float32).reshape(1, -1), device=device)
        frame, state[0] = feat(state[0], x)
        out, state[1] = synth(state[1], frame)
        return out[0].cpu().numpy()

    return step


def timed_calls(step, blocks) -> list:
    ms = []
    for b in blocks:
        t0 = time.perf_counter()
        step(b)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def timed_rows(params, crepe, conf, blocks, device, seed: int, seconds: float) -> dict:
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer

    deadline_ms = 1e3 * conf.hop_length / conf.sample_rate
    steps = (("lone_steps", lone_steps(params, crepe, conf, device)),
             ("block", BlockSynthesizer(params, crepe, conf, device=device).process))
    ms = {name: [] for name, _ in steps}
    for i, b in enumerate(blocks):
        for name, step in steps[:: 1 if i % 2 == 0 else -1]:
            ms[name] += timed_calls(step, [b])
    rows = {name: call_stats(ms[name], deadline_ms) for name, _ in steps}
    loop = run_loopback(params, crepe, conf, device, seed, seconds)
    rows["loopback"] = dict(call_stats(loop.pop("call_ms"), deadline_ms), **loop)
    thr = run_threaded(params, crepe, conf, blocks, device)
    rows["threaded"] = dict(call_stats(thr["call_ms"], deadline_ms), underruns=thr["underruns"])
    server = MultiStreamServer(params, crepe, conf, 1, device=device)
    rows["multistream_1"] = call_stats(
        timed_calls(lambda b: server.process(b[None]), blocks), deadline_ms)
    return rows


def profiled(step, blocks, device) -> dict:
    """Launches and the card's busy time a hop over a profiler window."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for b in blocks:
            step(b)
        wall_ms = 1e3 * (time.perf_counter() - t0) / len(blocks)
    kernels = [k for e in prof.events() for k in e.kernels]
    busy_ms = 1e-3 * sum(k.duration for k in kernels) / len(blocks)
    return {"wall_ms_per_hop": wall_ms, "busy_ms_per_hop": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernels_per_hop": len(kernels) / len(blocks)}


def profile(hops: int, seed: int = 0, device="cuda", conf=None,
            loopback_seconds: float = 2.0, window: bool = True) -> dict:
    """The rows above at ``conf`` (default: the full ``Config()``)."""
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.ops.fir import PRNGKey, fold_in
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
    from ddsp_tpu_torch.utils.slot_parity import lone_stream, tone_blocks

    conf = Config() if conf is None else conf
    device = torch.device(device)
    params = decoder_init(conf, seed=seed).to(device).eval()
    crepe = crepe_init(conf.crepe_capacity, seed=seed + 1).to(device).eval()
    blocks = tone_blocks(1, hops, conf.hop_length, conf.sample_rate, seed)[:, 0]
    rows = (params, crepe, conf, blocks, device, seed, loopback_seconds)
    result = {"hops": hops, "deadline_ms": 1e3 * conf.hop_length / conf.sample_rate,
              "before_profiler": timed_rows(*rows)}

    server = MultiStreamServer(params, crepe, conf, 1, device=device)
    many = np.stack([server.process(b[None])[0] for b in blocks] + [server.flush()[0]])
    one, _ = lone_stream(params, crepe, conf, fold_in(PRNGKey(0, device), 0), blocks, device,
                         flush=True)
    synth = BlockSynthesizer(params, crepe, conf, device=device)
    block = np.stack([synth.process(b) for b in blocks] + [synth.flush()])
    lone, _ = lone_stream(params, crepe, conf, PRNGKey(0, device), blocks, device, flush=True)
    result["vs_lone"] = {
        name: {"bit_equal": bool(np.array_equal(got, want)),
               "max_abs_diff": float(np.abs(got - want).max()), "peak": float(np.abs(want).max())}
        for name, got, want in (("multistream_1", many, one), ("block", block, lone))}

    if window:
        few = blocks[: min(30, hops)]
        synth = BlockSynthesizer(params, crepe, conf, device=device)
        server = MultiStreamServer(params, crepe, conf, 1, device=device)
        result["profiled"] = {
            "lone_steps": profiled(lone_steps(params, crepe, conf, device), few, device),
            "block": profiled(synth.process, few, device),
            "multistream_1": profiled(lambda b: server.process(b[None]), few, device)}
    result["after_profiler"] = timed_rows(*rows)
    return result


def main(argv=None) -> int:
    args = dict(a[2:].split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    if not torch.cuda.is_available():
        print("profile_realtime: needs a CUDA device", file=sys.stderr)
        return 2
    result = profile(int(args.get("hops", "200")), window=args.get("window", "1") != "0")
    result["card"] = card_name()
    print(json.dumps(result), flush=True)
    out = args.get("out")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
