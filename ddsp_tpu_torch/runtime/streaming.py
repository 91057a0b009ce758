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
(``runtime/multistream.py``) is held against.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import Decoder, controller_apply
from ddsp_tpu_torch.models.crepe import Crepe, crepe_forward, pitch_argmax
from ddsp_tpu_torch.models.synths import (
    ReverbLiveState,
    reverb_ir_spectra,
    reverb_live,
    reverb_live_init,
)
from ddsp_tpu_torch.ops.fir import filtered_noise
from ddsp_tpu_torch.ops.oscillator import render_hop_rows
from ddsp_tpu_torch.ops.resample import resample
from ddsp_tpu_torch.ops.spectral import a_weighted_loudness


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
    resampling): exactly one frame per hop.
    """
    crepe_win_orig = int(
        np.ceil(conf.crepe_window * conf.sample_rate / conf.crepe_sample_rate)
    ) + 64

    @torch.no_grad()
    def step(state: FeatureStreamState, audio_hop: torch.Tensor):
        buf = torch.cat([state.buffer[:, audio_hop.shape[-1]:], audio_hop], dim=-1)
        loud = a_weighted_loudness(
            buf[:, -conf.n_fft:], conf.n_fft, conf.hop_length, conf.sample_rate
        )  # (B, 1, 1): exactly one frame fits the window
        rs = resample(buf[:, -crepe_win_orig:], conf.sample_rate,
                      conf.crepe_sample_rate)
        window = rs[:, -conf.crepe_window:]
        mean = window.mean(dim=-1, keepdim=True)
        std = window.std(dim=-1, keepdim=True) + 1e-8  # ddof=1
        probs = crepe_forward(crepe, (window - mean) / std)
        freq, _, normalized_cents = pitch_argmax(probs[:, None, :])
        frame = {"f0": freq, "normalized_cents": normalized_cents, "loudness": loud}
        return frame, FeatureStreamState(buffer=buf)

    return step
