"""Multi-stream serving runtime: N concurrent real-time streams, one card.

Counterpart of ``ddsp_tpu/runtime/multistream.py``.  N independent
streams share the batch rows ("slots") of one step:

* each slot has its own frame counter, GRU hidden, phase, control context
  and reverb history, so slots join and leave without disturbing their
  neighbours (``reset_slots``);
* slot ``i`` equals a lone stream whose noise key is ``fold_in(key, i)``:
  the noise folds (slot, absolute frame);
* one step runs every slot through features (CREPE + loudness), the
  controller, the oscillator kernel, noise and reverb; each stage is a
  ``record_function`` range, so a ``torch.profiler`` trace attributes
  device time to it (utils/profile_serving.py).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit ``"cpu"`` they raise.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.controller import Decoder, controller_apply
from ddsp_tpu_torch.models.crepe import Crepe
from ddsp_tpu_torch.models.synths import (
    ReverbLiveState,
    reverb_ir_spectra,
    reverb_live,
    reverb_live_init,
)
from ddsp_tpu_torch.ops.fir import PRNGKey, convolve_designed_fir, fold_in, noise_from_counts
from ddsp_tpu_torch.ops.oscillator import render_hop_rows
from ddsp_tpu_torch.runtime.streaming import (
    FeatureStreamState,
    _zero_controls,
    feature_stream_init,
    make_feature_stream_step,
)


class MultiStreamState(NamedTuple):
    feat: FeatureStreamState  # rolling input buffers (N, window)
    hidden: torch.Tensor  # (layers, N, H) GRU state
    phase: torch.Tensor  # (N,) fundamental phase, cycles
    prev: Dict[str, torch.Tensor]  # controls of frame t-1, (N, 1, .)
    cur: Dict[str, torch.Tensor]  # controls of frame t (not yet rendered)
    pending: Dict[str, torch.Tensor]  # noise mags {H} of frame t
    n_seen: torch.Tensor  # (N,) per-slot frames consumed (int64)
    reverb_hist: ReverbLiveState  # frequency-delay line, (N, ...)


def multistream_init(conf: Config, n_streams: int, device=None) -> MultiStreamState:
    return MultiStreamState(
        feat=feature_stream_init(conf, batch=n_streams, device=device),
        hidden=torch.zeros(
            (conf.decoder_gru_layers, n_streams, conf.decoder_gru_units),
            device=device,
        ),
        phase=torch.zeros((n_streams,), device=device),
        prev=_zero_controls(conf, n_streams, device),
        cur=_zero_controls(conf, n_streams, device),
        pending={"H": torch.zeros((n_streams, 1, conf.n_noise_filters), device=device)},
        n_seen=torch.zeros((n_streams,), dtype=torch.int64, device=device),
        reverb_hist=reverb_live_init(conf, n_streams, conf.hop_length, device),
    )


def _slot_row_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """(N, 2) noise keys: slot i's is the key ``frame_noise`` gives row 0
    of a lone batch-1 stream keyed ``fold_in(key, i)``."""
    return fold_in(fold_in(key, torch.arange(n, device=key.device)), 0)


def _slot_noise(
    row_keys: torch.Tensor, offsets: torch.Tensor, block_size: int, dtype
) -> torch.Tensor:
    """(N,) per-slot absolute frame indices -> (N, 1, block) uniform noise,
    row i equal to ``frame_noise(fold_in(key, i), 1, 1, block, offsets[i])``."""
    counts = offsets[:, None] * block_size + torch.arange(
        block_size, device=offsets.device
    )
    return noise_from_counts(row_keys, counts, dtype)[:, None, :]


def _where_rows(mask: torch.Tensor, new: MultiStreamState,
                old: MultiStreamState) -> MultiStreamState:
    """Per-slot select: rows where ``mask`` take ``new``, others ``old``.

    The slot axis leads every tensor except ``hidden``'s (layers, N, H)."""
    n = mask.shape[0]

    def rows(o, nw, axis=0):
        shape = [1] * o.dim()
        shape[axis] = n
        return torch.where(mask.reshape(shape), nw, o)

    def rows_dict(o, nw):
        return {k: rows(o[k], nw[k]) for k in o}

    return MultiStreamState(
        feat=FeatureStreamState(buffer=rows(old.feat.buffer, new.feat.buffer)),
        hidden=rows(old.hidden, new.hidden, 1),
        phase=rows(old.phase, new.phase),
        prev=rows_dict(old.prev, new.prev),
        cur=rows_dict(old.cur, new.cur),
        pending=rows_dict(old.pending, new.pending),
        n_seen=rows(old.n_seen, new.n_seen),
        reverb_hist=ReverbLiveState(*(
            rows(o, nw) for o, nw in zip(old.reverb_hist, new.reverb_hist)
        )),
    )


def _render_slots(params: Decoder, conf: Config, ir_spec, row_keys, prev, cur,
                  nxt, phase, pending_h, n_seen, reverb_hist):
    """One hop of every slot from its (prev, cur, next) controls."""
    def cat(k):
        return torch.cat([prev[k], cur[k], nxt[k]], dim=1)

    with record_function("oscillator"):
        harm, new_phase = render_hop_rows(
            cat("f0"), cat("c"), cat("a"),
            sample_rate=conf.sample_rate,
            hop=conf.hop_length,
            initial_phase=phase,
        )
    with record_function("noise"):
        offsets = torch.clamp(n_seen - 1, min=0)
        noise_frames = _slot_noise(row_keys, offsets, conf.hop_length, harm.dtype)
        noise = convolve_designed_fir(pending_h, noise_frames)
    with record_function("reverb"):
        wet, hist = reverb_live(
            params.reverb, reverb_hist, harm + noise, conf, ir_spec=ir_spec
        )
    return wet, new_phase, hist


def make_multistream_step(
    params: Decoder,
    crepe: Crepe,
    conf: Config,
    noise_key: torch.Tensor,
    masked: bool = False,
):
    """(state, blocks (N, hop)) -> (out_blocks (N, hop), state).

    Mirrors the single-stream pipeline (one feature frame per hop, one
    frame of render lookahead, zeros while each slot's pipeline fills)
    with every per-slot condition taken row by row.

    With ``masked=True`` the signature is (state, blocks, active), where
    ``active`` is an (N,) bool tensor: every slot is computed but only
    active rows commit to the returned state, so inactive slots are frozen
    exactly (their output rows are garbage and must be ignored).
    """
    feat_step = make_feature_stream_step(crepe, conf)
    slot_keys = functools.lru_cache(maxsize=None)(  # once per slot count
        functools.partial(_slot_row_keys, noise_key)
    )
    with torch.no_grad():
        ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)

    @torch.no_grad()
    def step(state: MultiStreamState, blocks: torch.Tensor):
        with record_function("features"):
            frame, feat = feat_step(state.feat, blocks)
        with record_function("controller"):
            controls, hidden = controller_apply(params.controller, frame, state.hidden)
        new_ctrl = {k: controls[k] for k in ("f0", "c", "a")}

        first = (state.n_seen == 0)[:, None, None]  # slot pipelines filling
        prev_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.prev.items()}
        cur_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.cur.items()}
        wet, phase, hist = _render_slots(
            params, conf, ir_spec, slot_keys(blocks.shape[0]), prev_r, cur_r,
            new_ctrl, state.phase, state.pending["H"], state.n_seen,
            state.reverb_hist,
        )
        have_output = state.n_seen >= 1  # (N,)
        new_state = MultiStreamState(
            feat=feat,
            hidden=hidden,
            phase=torch.where(have_output, phase, state.phase),
            prev=cur_r,
            cur=new_ctrl,
            pending={"H": controls["H"]},
            n_seen=state.n_seen + 1,
            reverb_hist=ReverbLiveState(*(
                torch.where(have_output.reshape((-1,) + (1,) * (h.dim() - 1)), h, o)
                for h, o in zip(hist, state.reverb_hist)
            )),
        )
        return torch.where(have_output[:, None], wet, 0.0), new_state

    if not masked:
        return step

    def step_masked(state: MultiStreamState, blocks: torch.Tensor,
                    active: torch.Tensor):
        out, new_state = step(state, blocks)
        return out, _where_rows(active, new_state, state)

    return step_masked


def make_multistream_flush(params: Decoder, conf: Config, noise_key: torch.Tensor):
    """state -> (tail_blocks (N, hop), state): render every slot's final
    buffered frame with a right-edge clamp (single-stream flush)."""
    slot_keys = functools.lru_cache(maxsize=None)(  # once per slot count
        functools.partial(_slot_row_keys, noise_key)
    )
    with torch.no_grad():
        ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)

    @torch.no_grad()
    def flush(state: MultiStreamState):
        wet, phase, hist = _render_slots(
            params, conf, ir_spec, slot_keys(state.phase.shape[0]), state.prev,
            state.cur, state.cur, state.phase, state.pending["H"],
            state.n_seen, state.reverb_hist,
        )
        return wet, state._replace(phase=phase, reverb_hist=hist)

    return flush


def reset_slots(conf: Config, state: MultiStreamState, slots) -> MultiStreamState:
    """``state`` with the given slot rows reset to a fresh stream (a new
    client takes over the slot); other slots are untouched.

    ``slots``: int index, sequence of indices, or (N,) bool mask.
    """
    n = state.n_seen.shape[0]
    mask = np.zeros((n,), bool)
    mask[np.asarray(slots)] = True
    device = state.n_seen.device
    return _where_rows(
        torch.from_numpy(mask).to(device),
        multistream_init(conf, n, device),
        state,
    )


class MultiStreamServer:
    """Host-side wrapper: N synthesizer slots behind one device step.

    Feed (N, hop) input blocks, get (N, hop) synthesized blocks; ``reset``
    a slot when its client leaves and a new one joins.  ``params`` and
    ``crepe_params`` (``Decoder`` and ``Crepe`` modules) are moved to
    ``device`` in place.
    """

    def __init__(
        self,
        params: Decoder,
        crepe_params: Crepe,
        conf: Config,
        n_streams: int,
        noise_seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.conf = conf
        self.n_streams = n_streams
        self.hop = conf.hop_length
        params = params.to(self.device).eval()
        crepe_params = crepe_params.to(self.device).eval()
        key = PRNGKey(noise_seed, self.device)
        self._step = make_multistream_step(params, crepe_params, conf, key)
        self._flush = make_multistream_flush(params, conf, key)
        self.state = multistream_init(conf, n_streams, self.device)
        self.blocks = 0
        # build the kernel and pick library algorithms before the first
        # deadline-bound call; the result is discarded
        self._step(self.state, torch.zeros((n_streams, self.hop), device=self.device))

    def process(self, blocks: np.ndarray) -> np.ndarray:
        if blocks.shape != (self.n_streams, self.hop):
            raise ValueError(
                f"blocks must be {(self.n_streams, self.hop)}, got {blocks.shape}"
            )
        x = torch.from_numpy(np.asarray(blocks, np.float32)).to(self.device)
        out, self.state = self._step(self.state, x)
        self.blocks += 1
        return out.cpu().numpy()

    def flush(self) -> np.ndarray:
        out, self.state = self._flush(self.state)
        return out.cpu().numpy()

    def reset(self, slots) -> None:
        self.state = reset_slots(self.conf, self.state, slots)
