"""JACK host loop for live synthesis, and its offline stand-in over WAV files.

Counterpart of ``ddsp_tpu/runtime/jack_io.py`` (reference rt/synth.py:1-89:
a JACK client taking mic audio through the model to the speakers, with
port auto-wiring and missed-deadline counting).  The JACK-Client package
is optional: without it this module still imports (``HAS_JACK`` False)
and :func:`run_file_loopback` drives the same :class:`BlockSynthesizer`
from a WAV file.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import Crepe
from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer

try:  # pragma: no cover - exercised only on hosts with JACK
    import jack  # type: ignore

    HAS_JACK = True
except Exception:  # ModuleNotFoundError or a libjack load failure
    jack = None
    HAS_JACK = False


def run_jack(
    params: Decoder,
    crepe: Crepe,
    conf: Config,
    client_name: str = "ddsp-tpu-rt",
    device="cuda",
) -> None:
    """Stream mic -> synthesizer -> speakers through a JACK client until the
    server shuts down (or Ctrl-C).

    The reference's port auto-wiring (rt/synth.py:66-83): the first
    physical capture port feeds ``input_1``, ``output_1`` feeds the first
    physical playback port.  All synthesis state lives in the
    BlockSynthesizer; the audio thread mutates nothing else.
    """
    if not HAS_JACK:
        raise RuntimeError(
            "JACK-Client is not installed; use run_file_loopback for offline "
            "streaming or install `JACK-Client`."
        )
    synth = BlockSynthesizer(params, crepe, conf, device=device)
    client = jack.Client(client_name)
    if client.blocksize != conf.hop_length:
        client.blocksize = conf.hop_length
    event = threading.Event()

    @client.set_process_callback
    def process(frames):  # noqa: ANN001
        for i, o in zip(client.inports, client.outports):
            mic = np.frombuffer(i.get_buffer(), dtype="float32")
            o.get_buffer()[:] = synth.process(mic).astype("float32").tobytes()

    @client.set_shutdown_callback
    def shutdown(status, reason):  # noqa: ANN001
        event.set()

    client.inports.register("input_1")
    client.outports.register("output_1")
    with client:
        capture = client.get_ports(is_physical=True, is_output=True)
        playback = client.get_ports(is_physical=True, is_input=True)
        for src, dest in zip(capture, client.inports):
            client.connect(src, dest)
        for src, dest in zip(client.outports, playback):
            client.connect(src, dest)
        try:
            event.wait()
        except KeyboardInterrupt:
            pass


def run_file_loopback(
    params: Decoder,
    crepe: Crepe,
    conf: Config,
    in_path: str,
    out_path: str,
    max_blocks: Optional[int] = None,
    device="cuda",
) -> dict:
    """Offline stand-in for the JACK loop: WAV in -> block synth -> WAV out.

    Returns {'blocks', 'missed_deadlines', 'realtime_factor'}.  The stream
    runs one hop behind its input (its first block is pipeline fill), so
    that block is dropped and the final buffered frame flushed: the output
    covers exactly the ``blocks * hop`` input samples consumed.  The WAV is
    peak-limited to 0.9 and written as 16-bit PCM.
    """
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.ops.resample import resample

    audio, sr = read_wav(in_path)
    mono = audio.mean(0) if audio.shape[0] > 1 else audio[0]
    if sr != conf.sample_rate:
        mono = resample(torch.from_numpy(np.ascontiguousarray(mono)), sr,
                        conf.sample_rate).numpy()
    hop = conf.hop_length
    n_blocks = len(mono) // hop
    if max_blocks:
        n_blocks = min(n_blocks, max_blocks)

    synth = BlockSynthesizer(params, crepe, conf, device=device)
    out = []
    t0 = time.perf_counter()
    for i in range(n_blocks):
        out.append(synth.process(mono[i * hop : (i + 1) * hop]))
    wall = time.perf_counter() - t0
    if out:
        out = out[1:] + [synth.flush()]  # drop the latency block, render the tail
    rendered = np.concatenate(out) if out else np.zeros(0, np.float32)
    peak = np.abs(rendered).max() if rendered.size else 0.0
    write_wav(out_path, rendered / max(1.0, peak / 0.9), conf.sample_rate)
    return {
        "blocks": n_blocks,
        "missed_deadlines": synth.missed_deadlines,
        "realtime_factor": (n_blocks * hop / conf.sample_rate) / wall if wall else 0.0,
    }
