"""The served streams, replayed by the plain reference.

A slot of the multi-stream server is one client's stream: every call
takes the slot's newest 512 samples, measures one feature frame from the
last 4096 samples it has heard (A-weighted loudness over the last n_fft,
CREPE over the last 1024 samples at 16 kHz of a resampled tail), advances
the controller one frame, and returns the hop of the frame before, so
that each hop is rendered with its next frame known.  Noise is keyed by
(slot, absolute frame) and the reverb carries the impulse's whole memory,
so a slot's output over N calls is an offline render of its first N - 1
frames, delayed by one call.

CREPE's pitch is an argmax, and with seeded weights the two best bins can
lie within rounding of each other.  So the replay takes the bin that the
program served at each frame, as a served model's check takes its served
tokens, and reports by how much the reference's own activation at that
bin lies below its best.  Likewise each hop's oscillator starts from the
fundamental phase the program carried into it: a float32 phase drifts
from the exact running sum by its rounding every hop (inaudibly: every
harmonic moves with the fundamental), which would swamp every other
difference within a few hundred hops.  Each hop's phase advance is then
held against the exact one on its own (``judge.serving_numbers``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import dsp, threefry

FEATURE_BUFFER = 4096  # samples each slot keeps for its features
CREPE_RATE = 16000
CREPE_WINDOW = 1024


def served_bins(f0: torch.Tensor):
    """The pitch bins that served f0 values name, and whether each f0 is
    that bin's frequency (to 1e-5)."""
    bins = torch.round((1200.0 * torch.log2(f0.double() / 10.0) - dsp.CENTS_0)
                       / dsp.CENTS_STEP).clamp(0, dsp.N_BINS - 1)
    ok = (dsp.bin_hz(bins) - f0.double()).abs() <= 1e-5 * f0.double()
    return bins.long(), ok


def replay(wd: Dict[str, torch.Tensor], wc: Dict[str, torch.Tensor], conf: dict,
           blocks: torch.Tensor, f0, phase, noise_seed: int,
           slots: torch.Tensor, window_rows: int = 1024) -> Dict[str, torch.Tensor]:
    """blocks (S, K, hop): a sample of slots' inputs over all K calls; f0
    (S, K): the f0 the program served at each call, or None to serve the
    reference's own argmax; phase (S, K): the program's fundamental phase
    after each call, from which each hop's oscillator starts, or None to
    start each from the running sum; ``slots``: their slot numbers.
    Returns {'out': (S, K, hop) the reference's output, 'f0' and 'phase'
    (S, K) that it followed, 'advance': (S, K - 1) each rendered frame's
    exact phase advance in cycles, 'gap': (S, K) the reference's best
    activation less its activation at the served bin (inf where the served
    f0 is no bin's)}."""
    s, k, hop = blocks.shape
    sr = conf["sample_rate"]
    dev = blocks.device
    x = torch.cat([blocks.new_zeros(s, FEATURE_BUFFER), blocks.reshape(s, k * hop)], 1)
    n_fft = conf["n_fft"]
    start = hop + FEATURE_BUFFER  # the end of the first call's buffer
    loud = dsp.loudness(x[:, start - n_fft:].unfold(-1, n_fft, hop)[:, :k], sr)
    # CREPE reads the last 1024 samples at 16 kHz of the buffer's last
    # ceil(1024 sr / 16000) + 64 samples, resampled on their own
    tail = int(math.ceil(CREPE_WINDOW * sr / CREPE_RATE)) + 64
    g = math.gcd(sr, CREPE_RATE)
    n_out = int(math.ceil((CREPE_RATE // g) * tail / (sr // g)))
    m = torch.as_tensor(dsp.sinc_resample_matrix(
        tail, sr, CREPE_RATE, slice(n_out - CREPE_WINDOW, n_out)), dtype=torch.float32,
        device=dev)
    tails = x[:, start - tail:].unfold(-1, tail, hop)[:, :k].reshape(s * k, tail)
    probs = []
    for i in range(0, s * k, window_rows):
        probs.append(dsp.crepe_probs(wc, dsp.normalise(tails[i:i + window_rows] @ m.T)))
    probs = torch.cat(probs).reshape(s, k, dsp.N_BINS)

    if f0 is None:
        f0 = dsp.bin_hz(probs.argmax(-1).float())
    bins, ok = served_bins(f0)
    gap = probs.max(-1).values - probs.gather(-1, bins[..., None])[..., 0]
    gap = torch.where(ok, gap, torch.full_like(gap, float("inf")))

    ctl, _ = dsp.controls(wd, conf, (bins.float() / (dsp.N_BINS - 1))[..., None],
                          loud[..., None])
    f0c = f0[..., None].float()

    def pad(v):  # frames 0 .. K-2 with frame 0 before the first, as it starts
        return torch.cat([v[:, :1], v], 1)

    t = k - 1
    key = threefry.seed_key(noise_seed, dev)
    row_keys = threefry.derive(threefry.derive(key, slots.to(dev)), 0)
    samples = torch.arange(t * hop, device=dev).expand(s, t * hop)
    noise = threefry.uniform_pm1(row_keys, samples).reshape(s, t, hop)
    dry, advance = [], []
    for i in range(s):  # one slot at a time: (T hop, harmonics) is large
        sl = slice(i, i + 1)
        p0 = None if phase is None else phase[sl, :t]
        harm, adv = dsp.harmonic(pad(f0c[sl]), pad(ctl["c"][sl]), pad(ctl["a"][sl]), sr, hop,
                                 phase0=p0)
        dry.append(harm + dsp.filtered_noise(ctl["H"][sl, :t], noise[sl]))
        advance.append(adv)
    dry, advance = torch.cat(dry), torch.cat(advance)
    if phase is None:  # the running sum's phase after each call
        phase = torch.cat([advance.new_zeros(s, 1), torch.cumsum(advance, -1)], 1)
        phase = phase - torch.floor(phase)
    ir = dsp.reverb_ir(wd, conf["reverb_length"] or sr, sr)
    wet = dsp.causal_convolve(dry, ir).reshape(s, t, hop)
    out = torch.cat([wet.new_zeros(s, 1, hop), wet], 1)
    return {"out": out, "f0": f0, "phase": phase, "advance": advance, "gap": gap}
