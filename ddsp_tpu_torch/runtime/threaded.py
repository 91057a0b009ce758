"""Decoupled real-time synthesis: audio thread <-> model worker thread.

Counterpart of ``ddsp_tpu/runtime/threaded.py``.  The audio callback only
moves samples through the lock-free native ring buffers
(``ddsp_tpu_torch.native``); a worker thread drains the input ring hop by
hop, runs the :class:`BlockSynthesizer` on its device and fills the output
ring.  The callback's cost is a copy of the block, so the model cannot
make it miss a deadline: a slow hop shows as an underrun instead.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import Crepe
from ddsp_tpu_torch.native import RingBuffer
from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer


class ThreadedSynthesizer:
    """Real-time facade: ``push`` / ``pull`` from the audio thread, the
    model on a background worker.

    Args:
      latency_hops: output buffering target; more absorbs model jitter at
        the cost of latency (total latency ~ (latency_hops + 1) * hop).
      ring_hops: capacity of each ring, in hops.
      force_python_ring: the Python rings instead of the native ones.

    The :class:`BlockSynthesizer` (and with it the kernel build and the
    warm-up) is made on the caller's thread, before the worker starts.
    """

    def __init__(
        self,
        params: Decoder,
        crepe: Crepe,
        conf: Config,
        latency_hops: int = 2,
        ring_hops: int = 64,
        force_python_ring: bool = False,
        device="cuda",
    ):
        self.conf = conf
        self.hop = conf.hop_length
        self._synth = BlockSynthesizer(params, crepe, conf, device=device)
        cap = self.hop * ring_hops
        self._in = RingBuffer(cap, force_python=force_python_ring)
        self._out = RingBuffer(cap, force_python=force_python_ring)
        self.underruns = 0
        self.latency_hops = latency_hops
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        # pre-fill the output with silence to absorb the worker's jitter
        self._out.write(np.zeros(latency_hops * self.hop, np.float32))
        self._thread.start()

    # --- audio-thread side (lock-free, constant cost) -----------------------
    def push(self, mic_block: np.ndarray) -> None:
        """Feed captured samples (any length); never blocks."""
        self._in.write(np.asarray(mic_block, np.float32).reshape(-1))
        self._work.set()

    def pull(self, n: int) -> np.ndarray:
        """Fetch n output samples; zero-fills (and counts) an underrun."""
        got = self._out.read(n)
        if len(got) < n:
            self.underruns += 1
            got = np.concatenate([got, np.zeros(n - len(got), np.float32)])
        return got

    def process(self, mic_block: np.ndarray) -> np.ndarray:
        """push + pull, for callback-style hosts."""
        self.push(mic_block)
        return self.pull(len(mic_block))

    # --- worker side ---------------------------------------------------------
    def _worker(self) -> None:
        dev = self._synth.device
        # a thread starts on cuda:0 whatever the caller's current device is
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while not self._stop.is_set():
                if self._in.readable() < self.hop:
                    self._work.wait(timeout=0.1)
                    self._work.clear()
                    continue
                self._out.write(self._synth.process(self._in.read(self.hop)))

    def close(self) -> None:
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
