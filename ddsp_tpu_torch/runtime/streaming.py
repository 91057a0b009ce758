"""Streaming runtime: one feature frame and one synthesized hop per call.

Counterpart of the feature and synth stream steps of
``ddsp_tpu/runtime/streaming.py``.  State is an explicit NamedTuple of
tensors threaded through the step functions:

* the GRU hidden state advances once per feature frame;
* hop t is rendered only once frame t+1 is known (one hop of lookahead),
  so each hop's interpolation context is exact;
* noise is keyed by absolute frame and the reverb keeps the IR's whole
  memory, so a stream equals an offline render.

The single stream is the oracle that every slot of the multi-stream step
(``runtime/multistream.py``) is held against.  ``BlockSynthesizer`` is
the single client's real-time path: one hop of mic samples in, one hop of
synthesis out, with missed deadlines counted.  It runs the multi-stream
step at one slot keyed as the lone stream, which equals the two steps
here bit for bit with fewer launches a hop (469 against 648 at full
width on an H100, ``utils/profile_realtime.py``); on the card each hop
launches the slot kernel K5 once, at N = 1.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import Decoder, controller_apply
from ddsp_tpu_torch.models.crepe import Crepe, crepe_forward, pitch_argmax
from ddsp_tpu_torch.models.synths import (
    ReverbLiveState,
    osc_fill,
    reverb_ir_spectra,
    reverb_live,
    reverb_live_init,
)
from ddsp_tpu_torch.ops.fir import PRNGKey, filtered_noise
from ddsp_tpu_torch.ops.oscillator import render_hop_rows
from ddsp_tpu_torch.ops.resample import resample
from ddsp_tpu_torch.ops.spectral import a_weighted_loudness
from ddsp_tpu_torch.utils.profiling import named_scope


class SynthStreamState(NamedTuple):
    hidden: torch.Tensor  # (layers, B, H) GRU state
    phase: torch.Tensor  # (B,) fundamental phase, cycles
    prev: Dict[str, torch.Tensor]  # controls of frame t-1 {f0, c, a}
    cur: Dict[str, torch.Tensor]  # controls of frame t (not yet rendered)
    pending: Dict[str, torch.Tensor]  # noise mags {H} of frame t
    n_seen: torch.Tensor  # frames consumed so far (int64 scalar)
    reverb_hist: ReverbLiveState  # frequency-delay line


def _zero_controls(conf: Config, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "f0": torch.zeros((batch, 1, 1), device=device),
        "c": torch.full((batch, 1, conf.n_harmonics), 1.0 / conf.n_harmonics,
                        device=device),
        "a": torch.zeros((batch, 1, 1), device=device),
    }


def synth_stream_init(conf: Config, batch: int = 1, device=None) -> SynthStreamState:
    return SynthStreamState(
        hidden=torch.zeros(
            (conf.decoder_gru_layers, batch, conf.decoder_gru_units), device=device
        ),
        phase=torch.zeros((batch,), device=device),
        prev=_zero_controls(conf, batch, device),
        cur=_zero_controls(conf, batch, device),
        pending={"H": torch.zeros((batch, 1, conf.n_noise_filters), device=device)},
        n_seen=torch.zeros((), dtype=torch.int64, device=device),
        reverb_hist=reverb_live_init(conf, batch, conf.hop_length, device),
    )


def _render_hop(params: Decoder, state: SynthStreamState, next_ctrl, conf: Config,
                noise_key: torch.Tensor, ir_spec):
    """Render the hop of ``state.cur`` with (prev, cur, next) context."""
    def cat(k):
        return torch.cat([state.prev[k], state.cur[k], next_ctrl[k]], dim=1)

    harm, phase = render_hop_rows(
        cat("f0"), cat("c"), cat("a"),
        sample_rate=conf.sample_rate,
        hop=conf.hop_length,
        initial_phase=state.phase,
        fill=osc_fill(conf.osc_impl, state.phase.device),
    )
    noise = filtered_noise(
        state.pending["H"], noise_key, conf.hop_length,
        frame_offset=state.n_seen - 1,
    )
    wet, hist = reverb_live(
        params.reverb, state.reverb_hist, harm + noise, conf, ir_spec=ir_spec
    )
    return wet, phase, hist


def make_synth_stream_step(params: Decoder, conf: Config, noise_key: torch.Tensor):
    """(state, feature_frame) -> (audio_block (B, hop), state).

    ``feature_frame``: {'f0', 'normalized_cents', 'loudness'}, each
    (B, 1, 1): ONE new frame.  Returns the hop of the previous frame
    (zeros while the pipeline fills).  The reverb IR partition spectra are
    computed once here, since the weights are fixed.
    """
    refuse_z(conf, "make_synth_stream_step", "an MFCC stream step and a second recurrent state")
    with torch.no_grad():
        ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)

    @torch.no_grad()
    def step(state: SynthStreamState, frame: Dict[str, torch.Tensor]):
        controls, hidden = controller_apply(params.controller, frame, state.hidden)
        new_ctrl = {k: controls[k] for k in ("f0", "c", "a")}
        first = state.n_seen == 0
        # while filling (first frame) prev/cur snap to the incoming frame
        prev_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.prev.items()}
        cur_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.cur.items()}
        wet, phase, hist = _render_hop(
            params, state._replace(prev=prev_r, cur=cur_r), new_ctrl, conf,
            noise_key, ir_spec,
        )
        have_output = state.n_seen >= 1
        new_state = SynthStreamState(
            hidden=hidden,
            phase=torch.where(have_output, phase, state.phase),
            prev=cur_r,
            cur=new_ctrl,
            pending={"H": controls["H"]},
            n_seen=state.n_seen + 1,
            reverb_hist=ReverbLiveState(*(
                torch.where(have_output, h, o)
                for h, o in zip(hist, state.reverb_hist)
            )),
        )
        return torch.where(have_output, wet, 0.0), new_state

    return step


def make_synth_stream_flush(params: Decoder, conf: Config, noise_key: torch.Tensor):
    """state -> (tail_block, state): render the last buffered frame with a
    right-edge clamp (offline parity)."""
    with torch.no_grad():
        ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)

    @torch.no_grad()
    def flush(state: SynthStreamState):
        wet, phase, hist = _render_hop(
            params, state, state.cur, conf, noise_key, ir_spec
        )
        return wet, state._replace(phase=phase, reverb_hist=hist)

    return flush


# --- feature streaming -------------------------------------------------------
class FeatureStreamState(NamedTuple):
    buffer: torch.Tensor  # (B, window) rolling input samples


def feature_stream_init(conf: Config, batch: int = 1, window: int = 4096,
                        device=None) -> FeatureStreamState:
    return FeatureStreamState(buffer=torch.zeros((batch, window), device=device))


def make_feature_stream_step(crepe: Crepe, conf: Config):
    """(state, audio_hop (B, hop)) -> (feature_frame, state).

    The newest frame's loudness (rectangular STFT frame over the last
    n_fft samples) and CREPE f0 (last ``crepe_window`` samples after
    resampling): exactly one frame per hop.  Its parts are the spans
    ``features.loudness`` (with the buffer's roll), ``features.resample``
    and ``features.crepe`` (with the window's normalisation and the argmax).
    """
    crepe_win_orig = int(
        np.ceil(conf.crepe_window * conf.sample_rate / conf.crepe_sample_rate)
    ) + 64

    @torch.no_grad()
    def step(state: FeatureStreamState, audio_hop: torch.Tensor):
        with named_scope("features.loudness", device=True):
            buf = torch.cat([state.buffer[:, audio_hop.shape[-1]:], audio_hop], dim=-1)
            loud = a_weighted_loudness(
                buf[:, -conf.n_fft:], conf.n_fft, conf.hop_length, conf.sample_rate
            )  # (B, 1, 1): exactly one frame fits the window
        with named_scope("features.resample", device=True):
            rs = resample(buf[:, -crepe_win_orig:], conf.sample_rate,
                          conf.crepe_sample_rate)
        with named_scope("features.crepe", device=True):
            window = rs[:, -conf.crepe_window:]
            mean = window.mean(dim=-1, keepdim=True)
            std = window.std(dim=-1, keepdim=True) + 1e-8  # ddof=1
            probs = crepe_forward(crepe, (window - mean) / std)
            freq, _, normalized_cents = pitch_argmax(probs[:, None, :])
        frame = {"f0": freq, "normalized_cents": normalized_cents, "loudness": loud}
        return frame, FeatureStreamState(buffer=buf)

    return step


# --- host-side block synthesizer --------------------------------------------
class BlockSynthesizer:
    """Mic block in -> synthesized block out, with deadline tracking.

    One client's stream: the counterpart of the reference's JACK process
    callback (rt/synth.py:40-56) without the JACK dependency
    (``runtime/jack_io.py``).  Its output is that of the feature and synth
    stream steps above keyed ``PRNGKey(noise_seed)``; the multi-stream step
    at one slot (``lone=True``) computes it with fewer launches.  ``params``
    and ``crepe`` (``Decoder`` and ``Crepe`` modules) are moved to
    ``device`` in place.
    """

    def __init__(
        self,
        params: Decoder,
        crepe: Crepe,
        conf: Config,
        noise_seed: int = 0,
        device="cuda",
    ):
        from ddsp_tpu_torch.runtime import multistream  # which imports this module

        refuse_z(conf, "BlockSynthesizer", "an MFCC stream step and a second recurrent state a slot")
        self.device = resolve_device(device)
        self.conf = conf
        self.hop = conf.hop_length
        params = params.to(self.device).eval()
        crepe = crepe.to(self.device).eval()
        key = PRNGKey(noise_seed, self.device)
        self._step = multistream.make_multistream_step(params, crepe, conf, key, lone=True)
        self._flush = multistream.make_multistream_flush(params, conf, key, lone=True)
        self._state = multistream.multistream_init(conf, 1, self.device)
        self.missed_deadlines = 0
        self.blocks = 0
        # build the kernel and pick library algorithms before the first
        # deadline-bound callback; the state this produces is discarded
        self._step(self._state, torch.zeros((1, self.hop), device=self.device))[0].cpu()

    def process(self, block: np.ndarray) -> np.ndarray:
        """One hop of input samples -> one hop of output samples.  The
        deadline covers the host copies too: the steps only queue work on
        the card, and the copy back waits for it."""
        if block.shape[-1] != self.hop:
            raise ValueError(f"block has {block.shape[-1]} samples, the hop is {self.hop}")
        t0 = time.perf_counter()
        x = torch.tensor(np.asarray(block, np.float32).reshape(1, -1), device=self.device)
        out, self._state = self._step(self._state, x)
        out = out[0].cpu().numpy()
        self.blocks += 1
        if time.perf_counter() - t0 >= self.hop / self.conf.sample_rate:
            self.missed_deadlines += 1
        return out

    def flush(self) -> np.ndarray:
        """Render the final buffered frame (right-edge clamp, offline parity).

        The step runs one frame behind its input (frame t renders once
        frame t+1 is known), so at stream end the last consumed frame is
        still pending; call this once after the final ``process`` to emit
        that tail hop (the reference's RT loop drops it, rt/synth.py:44-56).
        """
        out, self._state = self._flush(self._state)
        return out[0].cpu().numpy()
