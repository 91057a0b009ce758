#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ddsp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them; every
   kernel source in ``ddsp_tpu_torch/csrc/`` is built with nvcc for
   sm_90a, one nvcc per source, all started together;
2. kernel vs plain: ``osc_hop_slots`` is held against its plain
   PyTorch version at the serving shape (N=256, hop 512, H=180) and at a
   ragged shape (N=13, hop 128, H=40), SNR > 90 dB; both are timed with
   CUDA events beside the kernel's bound;
3. the serving step at full default width: ``MultiStreamServer`` with 256
   slots and seeded random weights for 100 hops of tone plus noise.  The
   kernel's launch count must grow by one per hop; slots 0, 1 and 255 must
   equal lone single-stream runs with the same CREPE pitch bins; the
   median ms per hop is printed for 256, 1024 and 2048 slots against the
   11.6 ms hop deadline;
4. the socket server: ``StreamServer`` at full width on a unix socket, four
   concurrent clients streaming 1 s each, each equal to its slot driven
   through ``MultiStreamServer``;
5. the frame oscillator kernels ``osc_frames_fwd`` / ``osc_frames_bwd``
   against their plain version and its autograd, at the training shape
   (B=16, T=172, hop 512, H=180, h_start 0) and a ragged one (B=2, T=18,
   hop 128, H=40, h_start 8): forward SNR > 90 dB, each gradient > 80 dB,
   two backward runs bit-equal; kernels, plain forward and plain
   forward + backward timed with CUDA events beside the bounds;
6. one train step at full ``Config()`` width, batch 2, on the card
   (kernels) and on the CPU (plain path) from the same weights, batch and
   key: the step's gradients, leaf by leaf, within 1e-3 of the CPU's in
   norm (plus 1e-6 of the whole gradient's norm), ``grad_norm`` within
   1e-3 relative, loss within max(1e-2, 1e-6 |loss|); the updated
   parameters at allclose(rtol=2e-3, atol=3e-3), a sanity check only,
   since one Adam step moves a parameter by at most lr = 1e-3;
7. the training CLI at full width: ``ddsp_tpu_torch.training.train.main``
   on synthetic WAV files, batch 16, 30 steps in windows of 10, a
   checkpoint every 10 steps.  The backward kernel must launch once per
   step and the forward kernel once per step plus once per
   reconstruction dump; every logged loss is finite; the last checkpoint
   restores with equal parameters; median ms per step is printed.
   Phases 1-7 run on the default 'auto' STFT route (float32 torch.stft),
   and the power-STFT kernels must not launch in phase 7.
8. the power-STFT kernels ``stft_power_fwd`` (K3) / ``stft_power_bwd``
   (K4) against their plain versions at the training shape (B=16, 88,064
   samples, n_fft 2048 ... 64 at hop n_fft/4) and a ragged one (B=3, 5,000
   samples, n_fft 256 and 64): forward SNR > 90 dB, the backward within
   the JAX suite's bf16 criterion (max |diff| <= 5e-3 max |g|, cosine >
   0.9999), two backward runs bit-equal; per size and summed over the six,
   the kernels, the plain versions and torch.stft + |X|^2 (forward and
   autograd backward) timed with CUDA events beside the bounds;
9. one finetune step at full width, batch 2, on the kernel route
   (``set_stft_impl('pallas')``, bf16 loss spectrograms, weighted pitch
   decode), card (K1-K4) vs CPU (plain versions) from the same weights,
   audio and key: equal argmax pitch centres (the audio seed is chosen so),
   loss within 1e-4 relative, grad_norm within 1e-3 relative, every
   gradient leaf, decoder and CREPE with its BatchNorm statistics, within
   5e-3 of its norm (plus 1e-6 of the whole gradient's norm);
10. the training CLI at full width on the kernel route: 10 decoder steps,
   then ``--finetune_crepe=10 --pitch_decode=weighted`` at batch 16.  The
   K3 and K4 launches must equal the counts derived from the steps, sizes
   and cached target batches; every logged loss is finite; the finetune
   checkpoint restores with equal parameters, CREPE and its BatchNorm
   statistics included; median ms per finetune step, and per decoder step
   on 'pallas' beside 'auto' (alternating in this call), are printed.
   The STFT route is reset to 'auto' afterwards, whatever happens.

The line before the last is a JSON object describing each kernel (launches
on its main path, agreement with its plain version, kernel, plain, bound
and library times); the last line is ``{"ok": true, "device": {...}}``.
Without CUDA the script exits non-zero and prints no result.  It imports
nothing of jax or ddsp_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_SLOTS = 256
N_HOPS = 100
CHECK_SLOTS = (0, 1, 255)
DEADLINE_SLOTS = (256, 1024, 2048)
KERNEL_SNR_FLOOR_DB = 90.0
SLOT_ATOL = 1e-5  # slot vs lone stream (the JAX contract's tolerance)
# H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Cheapest known evaluation of one (sample, harmonic) point: rotate the
# harmonic's (sin, cos) by the fundamental's rotor (4 FMA-pipe
# instructions), three window multiply-adds, and the exact re-seed every
# 8 harmonics amortised (~2): 9 FMAs, 18 FLOP.
FLOP_PER_POINT = 18
# The frame backward per point: the (sin, cos) rotation, the seed
# amortised, and three window sums each for harm, the phase derivative
# and the window-amplitude gradient: 14 FMAs, 28 FLOP.
FLOP_PER_POINT_BWD = 28
GRAD_SNR_FLOOR_DB = 80.0
FRAME_SHAPES = ((16, 172, 512, 180, 0), (2, 18, 128, 40, 8))  # B, T, hop, H, h_start
TRAIN_STEPS, TRAIN_WINDOW = 30, 10
PARAM_RTOL, PARAM_ATOL = 2e-3, 3e-3  # __graft_entry__.py's one-step criterion
# __graft_entry__.py holds the loss to 1e-2 at its tiny width, where the
# loss is O(1-100).  Random full-width weights give a loss of ~5.6e4, whose
# float32 ulp is 3.9e-3; there 1e-6 relative (16 ulps) is the criterion.
LOSS_ATOL, LOSS_RTOL = 1e-2, 1e-6
# Card vs CPU gradients: each leaf's |g_card - g_cpu| (L2) within
# GRAD_RTOL of |g_cpu| plus GRAD_FLOOR of the whole gradient's norm, so a
# leaf holding a millionth of the gradient cannot fail on rounding alone;
# the 1e-3 is test_torch_training.py's grad_norm tolerance against JAX.
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
# The power-STFT kernels: bf16 tensor-core peak of the H100 SXM at 700 W
# (NVIDIA data sheet, dense); the training shape (B, samples) and the six
# MSS sizes at hop n_fft/4; a ragged shape; the backward's criterion, the
# JAX suite's for its bf16 kernel (tests/test_pallas_stft.py:52-58).
PEAK_BF16_FLOPS = 989e12
STFT_FFTS = (2048, 1024, 512, 256, 128, 64)
STFT_TRAIN = (16, 88064)
STFT_RAGGED, STFT_RAGGED_FFTS = (3, 5000), (256, 64)
STFT_GRAD_MAX_REL, STFT_GRAD_COS = 5e-3, 0.9999
# One finetune step card vs CPU on the kernel route: loss within 1e-4
# relative (the parity tests' train-step criterion), grad_norm within
# GRAD_RTOL, each leaf within 5e-3 of its norm (plus GRAD_FLOOR of the
# total): the bf16 criterion above, since K4's casts round on both sides
# from float32 inputs that differ in their last bits.
FT_LOSS_RTOL, FT_GRAD_RTOL = 1e-4, 5e-3
# The finetune comparison's sensitivity grows with f0: the decoded f0
# differs card vs CPU by ~1e-6 relative (float32 convolutions in another
# order), and the oscillator accumulates that error over 88,064 samples of
# phase, times the harmonic number.  Random CREPE weights decode an f0 that
# their seed sets more than the audio does: about 1468 Hz for seed 0, 323 Hz
# for 1, 97-231 Hz for 2.  At 1468 Hz the loss differs by 9e-5 and
# grad_norm by 1.4e-3 card vs CPU on the float32 torch.stft route as well,
# with no kernel of this slice involved, so the check takes seed 2, whose
# f0 is a bass note.
FT_PARAM_SEED = 2
FT_AUDIO_SEEDS = (1, 2, 3, 4, 5)
FT_CLI_STEPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    ref = np.asarray(ref, np.float64)
    noise = ref - np.asarray(est, np.float64)
    p_noise = np.mean(noise**2)
    return float("inf") if p_noise == 0 else float(
        10 * np.log10(np.mean(ref**2) / p_noise)
    )


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tone_blocks(n_streams: int, n_hops: int, hop: int, sample_rate: int, seed: int):
    """(n_hops, N, hop) float32: a tone per stream (110-880 Hz) plus noise."""
    rng = np.random.default_rng(seed)
    f = 110.0 * 2.0 ** rng.uniform(0.0, 3.0, (n_streams, 1))
    t = np.arange(n_hops * hop) / sample_rate
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((n_streams, t.size))
    return x.astype(np.float32).reshape(n_streams, n_hops, hop).transpose(1, 0, 2).copy()


def build_kernels():
    """Build every ``csrc/*.cu`` at once (one nvcc each, in parallel) and
    print each library and its ptxas register/spill report."""
    from concurrent.futures import ThreadPoolExecutor

    from ddsp_tpu_torch.ops.cuda import build

    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log(f"[build] {os.path.relpath(lib, ROOT)}")
        ptxas = lib.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[build] ptxas: {line.strip()}")


# --------------------------------------------------------------- phase 2


def kernel_inputs(n: int, hop: int, h: int, device, seed: int):
    """The kernel's operands as the serving hop produces them: phase in
    cycles, Nyquist-normalised amplitude rows, loudness in [0, 1]."""
    import torch

    from ddsp_tpu_torch.ops.interp import hop_weights

    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.0, 1.0, (3, n, h))
    amps /= amps.sum(-1, keepdims=True)
    arrays = [rng.uniform(0.0, 1.0, (n, hop)), *amps, rng.uniform(0.0, 1.0, (n, 3))]
    tensors = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    return tensors + [torch.as_tensor(hop_weights(hop), device=device)]


def kernel_bound_ms(n: int, hop: int, h: int):
    flops = FLOP_PER_POINT * n * hop * h
    n_bytes = 4 * (n * hop + 3 * n * h + 3 * n + 3 * hop + n * hop)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel(device):
    import torch

    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda

    result = {}
    for n, hop, h in ((N_SLOTS, 512, 180), (13, 128, 40)):
        inputs = kernel_inputs(n, hop, h, device, seed=n)
        got = osc_cuda.osc_hop_slots(*inputs)
        torch.cuda.synchronize()
        want = osc_cuda.render_hop_slots_plain(*inputs)
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        require(np.isfinite(got_np).all(), f"kernel output not finite at {(n, hop, h)}")
        snr = snr_db(want_np, got_np)
        err = float(np.abs(got_np - want_np).max())
        require(snr > KERNEL_SNR_FLOOR_DB,
                f"kernel vs plain SNR {snr:.2f} dB <= {KERNEL_SNR_FLOOR_DB} at {(n, hop, h)}")
        kernel_ms = cuda_ms(lambda: osc_cuda.osc_hop_slots(*inputs), iters=200)
        plain_ms = cuda_ms(lambda: osc_cuda.render_hop_slots_plain(*inputs), iters=20)
        bound_ms, bound_by = kernel_bound_ms(n, hop, h)
        log(f"[kernel] N={n} hop={hop} H={h}: SNR {snr:.2f} dB, max |err| {err:.3e}, "
            f"kernel {kernel_ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        if n == N_SLOTS:
            result = dict(snr_db=snr, max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    log("[kernel] library_ms: null -- no single PyTorch call computes a harmonic "
        "sine-bank sum; the nearest is the plain einsum version timed above")
    return result


# --------------------------------------------------------------- phase 3


def lone_stream(params, crepe, conf, key, blocks, device):
    """Single-stream oracle over one slot's (n_hops, hop) blocks: audio and
    the CREPE pitch bin of every frame."""
    import torch

    from ddsp_tpu_torch.runtime import streaming

    feat_step = streaming.make_feature_stream_step(crepe, conf)
    synth_step = streaming.make_synth_stream_step(params, conf, key)
    fs = streaming.feature_stream_init(conf, device=device)
    ss = streaming.synth_stream_init(conf, device=device)
    outs, bins = [], []
    for b in blocks:
        frame, fs = feat_step(fs, torch.from_numpy(b).to(device).reshape(1, -1))
        out, ss = synth_step(ss, frame)
        outs.append(out.cpu().numpy()[0])
        bins.append(round(float(frame["normalized_cents"][0, 0, 0]) * 359))
    return np.stack(outs), np.array(bins)


def batched_bins(crepe, conf, blocks, device):
    """(N, n_hops) CREPE bins of the batched feature step."""
    import torch

    from ddsp_tpu_torch.runtime import streaming

    step = streaming.make_feature_stream_step(crepe, conf)
    fs = streaming.feature_stream_init(conf, batch=blocks.shape[1], device=device)
    bins = []
    for b in blocks:
        frame, fs = step(fs, torch.from_numpy(b).to(device))
        bins.append(torch.round(frame["normalized_cents"][:, 0, 0] * 359).cpu().numpy())
    return np.stack(bins, axis=1).astype(np.int64)


def hop_times(server, blocks):
    times, outs = [], []
    for b in blocks:
        t0 = time.perf_counter()
        outs.append(server.process(b))  # returns host numpy: the step is done
        times.append(1e3 * (time.perf_counter() - t0))
    return np.stack(outs, axis=1), times


def phase_serving(device):
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda
    from ddsp_tpu_torch.ops.fir import PRNGKey, fold_in
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer

    conf = Config()
    deadline_ms = 1e3 * conf.hop_length / conf.sample_rate
    params, crepe = decoder_init(conf, seed=SEED), crepe_init(conf.crepe_capacity, seed=SEED + 1)
    blocks = tone_blocks(N_SLOTS, N_HOPS, conf.hop_length, conf.sample_rate, SEED)
    server = MultiStreamServer(params, crepe, conf, N_SLOTS, noise_seed=SEED, device=device)

    osc_cuda.LAUNCHES = 0  # counts from here to the read below: the main path
    out, times = hop_times(server, blocks)
    launches = osc_cuda.LAUNCHES
    log(f"[serving] N={N_SLOTS} x {N_HOPS} hops at full width: {launches} kernel launches")
    require(out.shape == (N_SLOTS, N_HOPS, conf.hop_length), f"output shape {out.shape}")
    require(np.isfinite(out).all(), "serving output not finite")
    require(np.abs(out[:, 2:]).max() > 1e-3, "serving output is silent")
    require(launches == N_HOPS, f"{launches} kernel launches for {N_HOPS} hops")
    median = {N_SLOTS: statistics.median(times[5:])}

    bins = batched_bins(crepe, conf, blocks, device)
    key = PRNGKey(SEED, device)
    worst_snr, worst_err = float("inf"), 0.0
    for i in CHECK_SLOTS:
        want, want_bins = lone_stream(params, crepe, conf, fold_in(key, i), blocks[:, i], device)
        require(np.array_equal(bins[i], want_bins), f"slot {i}: CREPE bins differ from lone stream")
        err = float(np.abs(out[i] - want).max())
        snr = snr_db(want, out[i])
        log(f"[serving] slot {i} vs lone stream: max |err| {err:.3e}, SNR {snr:.2f} dB, "
            f"peak |audio| {np.abs(want).max():.3f}, bins equal")
        worst_snr, worst_err = min(worst_snr, snr), max(worst_err, err)
    require(worst_err <= SLOT_ATOL, f"slot vs lone stream max |err| {worst_err:.3e} > {SLOT_ATOL}")

    for n in DEADLINE_SLOTS[1:]:
        big = MultiStreamServer(params, crepe, conf, n, noise_seed=SEED, device=device)
        _, t = hop_times(big, tone_blocks(n, 25, conf.hop_length, conf.sample_rate, SEED + n))
        median[n] = statistics.median(t[5:])
        del big
    fits = [n for n in DEADLINE_SLOTS if median[n] <= deadline_ms]
    for n in DEADLINE_SLOTS:
        log(f"[serving] N={n}: median {median[n]:.3f} ms/hop "
            f"({'within' if n in fits else 'over'} the {deadline_ms:.1f} ms deadline)")
    log(f"[serving] real-time slots per card (largest N measured within the deadline): "
        f"{max(fits) if fits else 0}")
    return launches, params, crepe, conf


# --------------------------------------------------------------- phase 4


def phase_socket(device, params, crepe, conf):
    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
    from ddsp_tpu_torch.runtime.server import StreamServer, stream_blocks

    n_streams, n_clients = 8, 4
    n_hops = int(np.ceil(conf.sample_rate / conf.hop_length))  # ~1 s each
    blocks = tone_blocks(n_clients, n_hops, conf.hop_length, conf.sample_rate, SEED + 7)
    address = os.path.join(tempfile.mkdtemp(), "serve.sock")
    server = StreamServer(params, crepe, conf, address, n_streams=n_streams,
                          noise_seed=SEED, device=device).start()
    results, errors = {}, []

    def client(i):
        try:
            results[i] = stream_blocks(address, blocks[:, i], timeout=120)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    osc_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        require(not any(t.is_alive() for t in threads), "socket clients hung")
    finally:
        server.close()
    wall = time.perf_counter() - t0
    require(not errors, "; ".join(errors))
    log(f"[socket] {n_clients} clients x {n_hops} blocks in {wall:.2f} s, "
        f"{osc_cuda.LAUNCHES} kernel launches")

    ref = MultiStreamServer(params, crepe, conf, n_streams, noise_seed=SEED, device=device)
    feed = np.zeros((n_hops, n_streams, conf.hop_length), np.float32)
    for i, (_, slot) in results.items():
        feed[:, slot] = blocks[:, i]
    want = np.stack([ref.process(b) for b in feed] + [ref.flush()], axis=1)
    for i, (audio, slot) in sorted(results.items()):
        require(audio.shape == (n_hops + 1, conf.hop_length), f"client {i} got {audio.shape}")
        err = float(np.abs(audio - want[slot]).max())
        log(f"[socket] client {i} (slot {slot}) vs MultiStreamServer: max |err| {err:.3e}")
        require(err <= SLOT_ATOL, f"client {i} differs from its slot by {err:.3e}")

# --------------------------------------------------------------- phase 5


def frame_operands(b: int, t: int, hop: int, h: int, h_start: int, device, seed: int):
    """The frame kernels' operands as the training step makes them: phase
    in cycles, Nyquist-normalised amplitude rows (44.1 kHz, f0 80-600 Hz),
    loudness in [0, 1], and a Gaussian audio gradient."""
    import torch

    from ddsp_tpu_torch.ops.oscillator import nyquist_normalized_amps

    rng = np.random.default_rng(seed)
    f0 = torch.tensor(rng.uniform(80.0, 600.0, (b, t + 2, 1)), dtype=torch.float32)
    amps = torch.tensor(rng.uniform(0.01, 1.0, (b, t + 2, h)), dtype=torch.float32)
    amps = nyquist_normalized_amps(f0, amps, 44100, h_start=h_start)
    arrays = (rng.uniform(0.0, 1.0, (b, t, hop)), amps.numpy(),
              rng.uniform(0.0, 1.0, (b, t + 2)), rng.standard_normal((b, t * hop)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def frame_bounds_ms(b: int, t: int, hop: int, h: int):
    """(forward, backward) bounds: each a (ms, "operations" | "bytes")."""
    points = b * t * hop * h
    samples, rows = b * t * hop, b * (t + 2)
    fwd_bytes = 4 * (samples + rows * h + rows + 3 * hop + samples)
    # in: g, phase, amps_pad, loud_pad, w; out: dphase, d amps_pad, d loud_pad
    bwd_bytes = 4 * (2 * samples + rows * h + rows + 3 * hop + samples + rows * h + rows)
    out = []
    for flop, n_bytes in ((FLOP_PER_POINT * points, fwd_bytes),
                          (FLOP_PER_POINT_BWD * points, bwd_bytes)):
        t_ops, t_bytes = flop / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return out


def phase_frames(device):
    import torch

    from ddsp_tpu_torch.ops.cuda import osc_frames

    result = {}
    for b, t, hop, h, h_start in FRAME_SHAPES:
        shape = f"B={b} T={t} hop={hop} H={h} h_start={h_start}"
        phase, amps, loud, g = frame_operands(b, t, hop, h, h_start, device, seed=b * t)
        got = osc_frames.osc_frames_fwd(phase, amps, loud, h_start)
        grads = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start)
        again = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start)
        torch.cuda.synchronize()
        want = osc_frames.render_from_phase_plain(phase, amps, loud, h_start)
        want_grads = osc_frames.render_from_phase_bwd_plain(g, phase, amps, loud, h_start)
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        require(np.isfinite(got_np).all(), f"frame forward not finite at {shape}")
        fwd_snr = snr_db(want_np, got_np)
        fwd_err = float(np.abs(got_np - want_np).max())
        require(fwd_snr > KERNEL_SNR_FLOOR_DB,
                f"frame forward vs plain SNR {fwd_snr:.2f} dB <= {KERNEL_SNR_FLOOR_DB} at {shape}")
        grad_snr, grad_err = {}, {}
        for name, a, c, c2 in zip(("dphase", "damps", "dloud"), want_grads, grads, again):
            a_np, c_np = a.cpu().numpy(), c.cpu().numpy()
            require(np.isfinite(c_np).all(), f"{name} not finite at {shape}")
            require(torch.equal(c, c2), f"{name} differs between two backward runs at {shape}")
            grad_snr[name] = snr_db(a_np, c_np)
            grad_err[name] = float(np.abs(c_np - a_np).max())
            require(grad_snr[name] > GRAD_SNR_FLOOR_DB,
                    f"{name} vs autograd SNR {grad_snr[name]:.2f} dB <= {GRAD_SNR_FLOOR_DB} at {shape}")
        del want, want_grads, got, grads, again
        fwd_ms = cuda_ms(lambda: osc_frames.osc_frames_fwd(phase, amps, loud, h_start), iters=20)
        bwd_ms = cuda_ms(lambda: osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start), iters=20)
        plain_ms = cuda_ms(
            lambda: osc_frames.render_from_phase_plain(phase, amps, loud, h_start), iters=3, warmup=1)
        plain_bwd_ms = cuda_ms(
            lambda: osc_frames.render_from_phase_bwd_plain(g, phase, amps, loud, h_start),
            iters=3, warmup=1)
        (fb_ms, fb_by), (bb_ms, bb_by) = frame_bounds_ms(b, t, hop, h)
        log(f"[frames] {shape}: forward SNR {fwd_snr:.2f} dB, max |err| {fwd_err:.3e}, "
            f"kernel {fwd_ms:.5f} ms, plain {plain_ms:.5f} ms, bound {fb_ms:.5f} ms ({fb_by})")
        log(f"[frames] {shape}: backward SNR " + ", ".join(
            f"{k} {v:.2f} dB (max |err| {grad_err[k]:.3e})" for k, v in grad_snr.items())
            + f"; bit-equal on rerun; kernel {bwd_ms:.5f} ms, plain forward+backward "
            f"{plain_bwd_ms:.5f} ms, bound {bb_ms:.5f} ms ({bb_by})")
        if (b, t, hop, h, h_start) == FRAME_SHAPES[0]:
            result["osc_frames_fwd"] = dict(
                snr_db=fwd_snr, max_abs_err=fwd_err, ms=fwd_ms, plain_ms=plain_ms,
                bound_ms=fb_ms, bound_by=fb_by)
            result["osc_frames_bwd"] = dict(
                snr_db=min(grad_snr.values()), max_abs_err=max(grad_err.values()),
                grad_snr_db=grad_snr, grad_max_abs_err=grad_err, ms=bwd_ms,
                plain_ms=plain_bwd_ms, bound_ms=bb_ms, bound_by=bb_by)
        del phase, amps, loud, g
        torch.cuda.empty_cache()
    log("[frames] library_ms: null -- no single PyTorch call computes a harmonic "
        "sine-bank render or its gradient; the nearest is the plain version timed above")
    return result


# --------------------------------------------------------------- phase 6


def feature_batch(conf, n: int, seed: int):
    """A seeded numpy training batch {f0, normalized_cents, loudness, audio}."""
    rng = np.random.default_rng(seed)
    t = conf.frames_per_example
    return {
        "f0": rng.uniform(100.0, 400.0, (n, t, 1)).astype(np.float32),
        "normalized_cents": rng.uniform(0.0, 1.0, (n, t, 1)).astype(np.float32),
        "loudness": rng.uniform(0.0, 1.0, (n, t, 1)).astype(np.float32),
        "audio": (0.1 * rng.standard_normal((n, conf.example_length))).astype(np.float32),
    }


def step_gradients(params, batch, conf, key):
    """The gradients ``make_train_step`` takes from this state: its loss
    under the noise key it splits from ``key``, differentiated leaf by
    leaf (a leaf the loss does not reach gets zeros, as in the step)."""
    import torch

    from ddsp_tpu_torch.ops.fir import split
    from ddsp_tpu_torch.training import trainer

    names, leaves = zip(*params.named_parameters())
    loss, _ = trainer.loss_fn(params, batch, conf, split(key)[1])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach().cpu().double()
            for n, p, g in zip(names, leaves, grads)}


def worst_leaf(g_gpu, g_cpu, rtol: float = GRAD_RTOL):
    """(leaf, criterion, |diff| / |g_cpu| of that leaf) of the leaf whose
    card gradient is furthest from the CPU's: |diff| within ``rtol`` of
    the leaf's norm plus GRAD_FLOOR of the whole gradient's norm."""
    import torch

    total = float(torch.sqrt(sum((g * g).sum() for g in g_cpu.values())))
    crit = {k: float((g_gpu[k] - g).norm() / (rtol * g.norm() + GRAD_FLOOR * total))
            for k, g in g_cpu.items()}
    leaf = max(crit, key=crit.get)
    rel = float((g_gpu[leaf] - g_cpu[leaf]).norm() / g_cpu[leaf].norm().clamp_min(1e-300))
    return leaf, crit[leaf], rel


def phase_train_step(device):
    """One full-width train step on the card and on the CPU from the same
    weights, batch and key: gradients leaf by leaf, then the step.  The
    gradients are also compared with the loss's log term off
    (``mss_alpha`` 0), which shows how much of their spread is float32
    rounding magnified by ``log2(S + eps)`` in low-power bins."""
    import copy

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import trainer

    conf = Config(batch_size=2)
    conf_linear = Config(batch_size=2, mss_alpha=0.0)
    batch = feature_batch(conf, conf.batch_size, SEED + 3)
    decoder = decoder_init(conf, seed=SEED)
    step = trainer.make_train_step(conf)
    out = {}
    for dev in (device, torch.device("cpu")):
        params = copy.deepcopy(decoder).to(dev)
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads = step_gradients(params, on_dev, conf, PRNGKey(SEED, dev))
        linear = step_gradients(params, on_dev, conf_linear, PRNGKey(SEED, dev))
        state = trainer.TrainState(0, params, trainer.make_optimizer(conf).init(
            list(params.parameters())), PRNGKey(SEED, dev))
        t0 = time.perf_counter()
        state, metrics = step(state, on_dev)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        log(f"[train-step] {dev}: loss {loss:.6f}, grad_norm {grad_norm:.6f}, "
            f"{time.perf_counter() - t0:.2f} s")
        out[dev.type] = (loss, grad_norm, grads, linear, {
            k: v.detach().cpu().double() for k, v in state.params.state_dict().items()})
    (l_gpu, n_gpu, g_gpu, lin_gpu, p_gpu) = out["cuda"]
    (l_cpu, n_cpu, g_cpu, lin_cpu, p_cpu) = out["cpu"]
    loss_tol = max(LOSS_ATOL, LOSS_RTOL * abs(l_cpu))
    require(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) < loss_tol,
            f"train-step loss card {l_gpu} vs CPU {l_cpu} (tolerance {loss_tol:.3e})")
    norm_err = abs(n_gpu - n_cpu) / n_cpu
    require(np.isfinite(n_gpu) and norm_err <= GRAD_RTOL,
            f"train-step grad_norm card {n_gpu} vs CPU {n_cpu}: {norm_err:.3e} relative > {GRAD_RTOL}")
    leaf, worst_grad, rel = worst_leaf(g_gpu, g_cpu)
    log(f"[train-step] card vs CPU gradients, {len(g_cpu)} leaves: grad_norm "
        f"{norm_err:.3e} relative; worst leaf {leaf}: |diff| {rel:.3e} of its norm, "
        f"criterion {worst_grad:.4f} (< 1 passes)")
    lin_leaf, lin_crit, lin_rel = worst_leaf(lin_gpu, lin_cpu)
    log(f"[train-step] same with the log term off (mss_alpha 0), for information: worst "
        f"leaf {lin_leaf}: |diff| {lin_rel:.3e} of its norm, criterion {lin_crit:.4f}")
    require(worst_grad < 1.0, f"train-step gradient of {leaf} differs: criterion {worst_grad:.4f} >= 1")
    worst = max(float(((p_gpu[k] - p_cpu[k]).abs() / (PARAM_ATOL + PARAM_RTOL * p_cpu[k].abs())).max())
                for k in p_cpu)
    log(f"[train-step] card vs CPU: |loss diff| {abs(l_gpu - l_cpu):.3e} (< {loss_tol:.3e}); "
        f"worst param |diff| / (atol + rtol |cpu|) = {worst:.4f} (< 1 passes; one Adam "
        f"step cannot fail it)")
    require(worst < 1.0, f"train-step params differ: criterion {worst:.4f} >= 1")


# --------------------------------------------------------------- phase 7


def write_tones(data_dir: str, sample_rate: int, seed: int, n: int = 3, seconds: float = 10.0):
    """``n`` harmonic tones with gliding pitch as WAV files."""
    from ddsp_tpu_torch.data.audio_io import write_wav

    os.makedirs(data_dir, exist_ok=True)
    for i, audio in enumerate(tone_batch(n, int(seconds * sample_rate), sample_rate, seed)):
        write_wav(os.path.join(data_dir, f"tone{i}.wav"), audio, sample_rate)


def phase_training(device):
    """The training CLI at full width; returns the launch counts of its run."""
    import contextlib
    import io

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.ops.cuda import osc_frames, stft
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import train, trainer

    conf = Config()
    work = tempfile.mkdtemp()
    data_dir, ckpt_dir = os.path.join(work, "data"), os.path.join(work, "ckpt")
    write_tones(data_dir, conf.sample_rate, SEED + 11)
    argv = [f"--data_dir={data_dir}", f"--checkpoint_dir={ckpt_dir}",
            f"--num_steps={TRAIN_STEPS}", f"--device_steps={TRAIN_WINDOW}",
            f"--checkpoint_every={TRAIN_WINDOW}", f"--batch_size={conf.batch_size}",
            f"--device={device.type}"]
    stdout = io.StringIO()
    osc_frames.FWD_LAUNCHES = osc_frames.BWD_LAUNCHES = 0  # the main path from here
    stft.FWD_LAUNCHES = stft.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        state = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = osc_frames.FWD_LAUNCHES, osc_frames.BWD_LAUNCHES
    require(stft.FWD_LAUNCHES == stft.BWD_LAUNCHES == 0,
            "the 'auto' STFT route launched the power-STFT kernels")
    for line in stdout.getvalue().splitlines():
        log(f"[train] | {line}")
    require(f" on {device.type}" in stdout.getvalue(), "features were not extracted on the card")
    rows = [json.loads(line) for line in open(os.path.join(ckpt_dir, "metrics.jsonl"))]
    require([r["step"] for r in rows] == list(range(TRAIN_WINDOW, TRAIN_STEPS + 1, TRAIN_WINDOW)),
            f"logged steps {[r['step'] for r in rows]}")
    require(all(np.isfinite(r["loss"]) and np.isfinite(r["loss_mean"]) for r in rows),
            "a logged loss is not finite")
    dumps = len([f for f in os.listdir(os.path.join(ckpt_dir, "audio")) if f.endswith(".wav")])
    n_dump = dumps // 2  # each dump forward writes two examples
    require(bwd == TRAIN_STEPS, f"backward kernel launched {bwd} times in {TRAIN_STEPS} steps")
    require(fwd == TRAIN_STEPS + n_dump,
            f"forward kernel launched {fwd} times for {TRAIN_STEPS} steps + {n_dump} dump(s)")
    latest = trainer.latest_checkpoint(ckpt_dir)
    require(latest is not None and latest.endswith(f"step_{TRAIN_STEPS:08d}"),
            f"latest checkpoint {latest}")
    restored = trainer.restore_checkpoint(latest, trainer.init_state(PRNGKey(99), conf, device))
    require(restored.step == TRAIN_STEPS, f"restored step {restored.step}")
    for (k, a), (_, b) in zip(restored.params.state_dict().items(),
                              state.params.state_dict().items()):
        require(torch.equal(a, b), f"restored parameter {k} differs")
    window_ms = [1e3 * (b["time"] - a["time"]) / TRAIN_WINDOW for a, b in zip(rows, rows[1:])]
    ms = statistics.median(window_ms)
    log(f"[train] {TRAIN_STEPS} steps at batch {conf.batch_size}, full width: "
        f"{wall:.1f} s in all (features, {len(rows)} windows, checkpoints, {n_dump} dump); "
        f"losses {[round(r['loss_mean'], 4) for r in rows]}; "
        f"forward kernel {fwd} launches, backward kernel {bwd}")
    log(f"[train] steady state: median {ms:.3f} ms per train step over windows 2-{len(rows)} "
        f"({1e3 / ms:.2f} steps/s); checkpoint {os.path.basename(latest)} restores equal")
    return {"osc_frames_fwd": fwd, "osc_frames_bwd": bwd}, ms


# --------------------------------------------------------------- phase 8


def stft_operands(b: int, length: int, n_fft: int, device, seed: int):
    """The power-STFT kernels' operands as the loss makes them: hop blocks
    of a reflect-padded noise signal at hop n_fft/4, and a Gaussian
    magnitude gradient (the loss's dmag is sign-like, O(1/elements))."""
    import torch

    from ddsp_tpu_torch.ops.spectral import hop_blocks

    rng = np.random.default_rng(seed)
    x = torch.tensor(0.1 * rng.standard_normal((b, length)), dtype=torch.float32)
    hop = n_fft // 4
    xb, n_frames = hop_blocks(x, n_fft, hop)
    dmag = rng.standard_normal((b, n_frames, n_fft // 2 + 1)) / (n_frames * (n_fft // 2 + 1))
    return (x.to(device), xb.contiguous().to(device), hop, n_frames,
            torch.tensor(dmag, dtype=torch.float32, device=device))


def stft_bounds_ms(b: int, n_blocks: int, hop: int, n_frames: int, n_fft: int):
    """(forward, backward) bounds, each (ms, "operations" | "bytes"): the
    forward's 4 B T n_fft bins flops (re and im products) at the bf16
    tensor-core peak, or its bytes (xb and the bf16 matrices in, |S|^2
    out); the backward twice the flops (the re/im recompute and the
    transposed products), reading xb, dmag and the matrices, writing dxb."""
    bins = n_fft // 2 + 1
    flops = 4 * b * n_frames * n_fft * bins
    x_bytes, mag_bytes, w_bytes = 4 * b * n_blocks * hop, 4 * b * n_frames * bins, 2 * 2 * n_fft * bins
    out = []
    for f, n_bytes in ((flops, x_bytes + w_bytes + mag_bytes),
                       (2 * flops, 2 * x_bytes + w_bytes + mag_bytes)):
        t_ops, t_bytes = f / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES_PER_S
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return out


def check_stft(device, b: int, length: int, n_fft: int, seed: int):
    """K3 and K4 against their plain versions at one shape; returns the
    operands and the agreement numbers."""
    import torch

    from ddsp_tpu_torch.ops.cuda import stft

    x, xb, hop, n_frames, dmag = stft_operands(b, length, n_fft, device, seed)
    shape = f"B={b} L={length} n_fft={n_fft} hop={hop}"
    got = stft.stft_power_fwd(xb, n_fft, hop, n_frames)
    dxb = stft.stft_power_bwd(xb, dmag, n_fft, hop, n_frames)
    again = stft.stft_power_bwd(xb, dmag, n_fft, hop, n_frames)
    torch.cuda.synchronize()
    want = stft.stft_power_plain(xb, n_fft, hop, n_frames)
    want_dxb = stft.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames)
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    g_np, wg_np = dxb.cpu().numpy(), want_dxb.cpu().numpy()
    require(np.isfinite(got_np).all() and np.isfinite(g_np).all(), f"STFT kernels not finite at {shape}")
    fwd_snr, bwd_snr = snr_db(want_np, got_np), snr_db(wg_np, g_np)
    fwd_err = float(np.abs(got_np - want_np).max())
    bwd_rel = float(np.abs(g_np - wg_np).max() / np.abs(wg_np).max())
    cos = float(np.sum(g_np.astype(np.float64) * wg_np)
                / (np.linalg.norm(g_np.astype(np.float64)) * np.linalg.norm(wg_np)))
    require(fwd_snr > KERNEL_SNR_FLOOR_DB,
            f"stft_power_fwd vs plain SNR {fwd_snr:.2f} dB <= {KERNEL_SNR_FLOOR_DB} at {shape}")
    require(bwd_rel <= STFT_GRAD_MAX_REL and cos > STFT_GRAD_COS,
            f"stft_power_bwd vs plain at {shape}: max |diff| {bwd_rel:.3e} of max |g| "
            f"(limit {STFT_GRAD_MAX_REL}), cosine {cos:.8f} (limit {STFT_GRAD_COS})")
    require(torch.equal(dxb, again), f"stft_power_bwd differs between two runs at {shape}")
    log(f"[stft] {shape}: forward SNR {fwd_snr:.2f} dB, max |err| {fwd_err:.3e}; backward "
        f"SNR {bwd_snr:.2f} dB, max |diff| {bwd_rel:.3e} of max |g|, cosine {cos:.8f}, "
        f"bit-equal on rerun")
    return (x, xb, hop, n_frames, dmag), dict(
        fwd_snr=fwd_snr, fwd_err=fwd_err, bwd_snr=bwd_snr,
        bwd_err=float(np.abs(g_np - wg_np).max()), bwd_rel=bwd_rel, cos=cos)


def phase_stft(device):
    """K3 / K4 against their plain versions at the training shape (all six
    MSS sizes) and a ragged one, timed beside their bounds, the plain
    versions and torch.stft."""
    import torch

    from ddsp_tpu_torch.ops.cuda import stft
    from ddsp_tpu_torch.ops.fir import hann_window

    for n_fft in STFT_RAGGED_FFTS:
        check_stft(device, *STFT_RAGGED, n_fft, seed=n_fft + 1)
    rows = []
    b, length = STFT_TRAIN
    for n_fft in STFT_FFTS:
        (x, xb, hop, n_frames, dmag), agree = check_stft(device, b, length, n_fft, seed=n_fft)
        window = hann_window(n_fft, torch.float32, device)

        def library_fwd():
            spec = torch.stft(x, n_fft, hop_length=hop, window=window, center=True,
                              pad_mode="reflect", return_complex=True)
            return spec.real * spec.real + spec.imag * spec.imag

        leaf = x.clone().requires_grad_(True)
        lib_out = torch.stft(leaf, n_fft, hop_length=hop, window=window, center=True,
                             pad_mode="reflect", return_complex=True)
        lib_mag = lib_out.real * lib_out.real + lib_out.imag * lib_out.imag
        lib_dmag = dmag.transpose(1, 2).contiguous()
        (fb_ms, fb_by), (bb_ms, bb_by) = stft_bounds_ms(b, xb.shape[1], hop, n_frames, n_fft)
        row = dict(
            n_fft=n_fft, hop=hop, frames=n_frames, **agree,
            fwd_ms=cuda_ms(lambda: stft.stft_power_fwd(xb, n_fft, hop, n_frames), iters=20),
            bwd_ms=cuda_ms(lambda: stft.stft_power_bwd(xb, dmag, n_fft, hop, n_frames), iters=10),
            plain_fwd_ms=cuda_ms(lambda: stft.stft_power_plain(xb, n_fft, hop, n_frames), iters=10),
            plain_bwd_ms=cuda_ms(
                lambda: stft.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames), iters=10),
            library_fwd_ms=cuda_ms(library_fwd, iters=20),
            library_bwd_ms=cuda_ms(
                lambda: torch.autograd.grad(lib_mag, leaf, lib_dmag, retain_graph=True), iters=20),
            fwd_bound_ms=fb_ms, fwd_bound_by=fb_by, bwd_bound_ms=bb_ms, bwd_bound_by=bb_by)
        log(f"[stft] n_fft={n_fft}: K3 {row['fwd_ms']:.5f} ms (bound {fb_ms:.5f}, {fb_by}; "
            f"plain {row['plain_fwd_ms']:.5f}; torch.stft+|X|^2 {row['library_fwd_ms']:.5f}), "
            f"K4 {row['bwd_ms']:.5f} ms (bound {bb_ms:.5f}, {bb_by}; plain "
            f"{row['plain_bwd_ms']:.5f}; torch.stft autograd backward {row['library_bwd_ms']:.5f})")
        rows.append(row)
        del x, xb, dmag, leaf, lib_out, lib_mag, lib_dmag
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in (
        "fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms",
        "library_bwd_ms", "fwd_bound_ms", "bwd_bound_ms")}
    log(f"[stft] six sizes summed (B={b}, L={length}): K3 {total['fwd_ms']:.5f} ms (bound "
        f"{total['fwd_bound_ms']:.5f}, plain {total['plain_fwd_ms']:.5f}, torch.stft "
        f"{total['library_fwd_ms']:.5f}); K4 {total['bwd_ms']:.5f} ms (bound "
        f"{total['bwd_bound_ms']:.5f}, plain {total['plain_bwd_ms']:.5f}, torch.stft backward "
        f"{total['library_bwd_ms']:.5f})")

    def bound_by(kind):  # the kind that binds most of the summed bound
        ops = sum(r[f"{kind}_bound_ms"] for r in rows if r[f"{kind}_bound_by"] == "operations")
        return "operations" if ops >= total[f"{kind}_bound_ms"] / 2 else "bytes"

    per_scale = [{k: r[k] for k in ("n_fft", "hop", "frames", "fwd_ms", "bwd_ms", "fwd_bound_ms",
                                    "bwd_bound_ms", "library_fwd_ms", "library_bwd_ms")}
                 for r in rows]
    return {
        "stft_power_fwd": dict(
            snr_db=min(r["fwd_snr"] for r in rows), max_abs_err=max(r["fwd_err"] for r in rows),
            ms=total["fwd_ms"], plain_ms=total["plain_fwd_ms"], bound_ms=total["fwd_bound_ms"],
            bound_by=bound_by("fwd"), library_ms=total["library_fwd_ms"],
            library="torch.stft(center=True, pad_mode='reflect', window=hann) then |X|^2, "
                    "six sizes summed", per_scale=per_scale),
        "stft_power_bwd": dict(
            snr_db=min(r["bwd_snr"] for r in rows), max_abs_err=max(r["bwd_err"] for r in rows),
            max_rel_err=max(r["bwd_rel"] for r in rows), min_cosine=min(r["cos"] for r in rows),
            ms=total["bwd_ms"], plain_ms=total["plain_bwd_ms"], bound_ms=total["bwd_bound_ms"],
            bound_by=bound_by("bwd"), library_ms=total["library_bwd_ms"],
            library="autograd backward of the torch.stft + |X|^2 above, six sizes summed"),
    }


# --------------------------------------------------------------- phase 9


def tone_batch(n: int, length: int, sample_rate: int, seed: int) -> np.ndarray:
    """(n, length) five-partial tones, each gliding up one octave from
    110-440 Hz, plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / sample_rate
    rows = []
    for _ in range(n):
        f = 110.0 * 2.0 ** rng.uniform(0.0, 2.0) * 2.0 ** (t * sample_rate / length)
        phase = 2 * np.pi * np.cumsum(f) / sample_rate
        audio = sum((0.3 / k) * np.sin(k * phase) for k in range(1, 6))
        audio += 0.005 * rng.standard_normal(t.size)
        rows.append(audio)
    return np.stack(rows).astype(np.float32)


def finetune_gradients(params, batch, conf, key):
    """The gradients ``make_finetune_step`` takes from this state, leaf by
    leaf (BatchNorm statistics included), and the loss."""
    import torch

    from ddsp_tpu_torch.ops.fir import split
    from ddsp_tpu_torch.training import trainer

    names, leaves = zip(*params.named_parameters())
    loss, _ = trainer.loss_fn_e2e(params, batch, conf, split(key)[1])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g).detach().cpu().double()
                         for n, p, g in zip(names, leaves, grads)}


def pitch_centres(params, audio, conf, device):
    import torch

    from ddsp_tpu_torch.models.autoencoder import encode

    with torch.no_grad():
        features = encode(params, torch.from_numpy(audio).to(device), conf)
    return features["probabilities"].argmax(-1).cpu().numpy(), features["f0"].cpu().numpy()


def phase_finetune_step(device):
    """One full-width finetune step on the card (K1-K4) and on the CPU
    (their plain versions) from the same weights, audio and key, on the
    kernel route ('pallas', bf16 loss spectrograms, weighted decode)."""
    import copy

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.autoencoder import autoencoder_init
    from ddsp_tpu_torch.models.crepe import make_statistics_trainable
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    conf = Config(batch_size=2, pitch_decode="weighted")
    params0 = autoencoder_init(PRNGKey(FT_PARAM_SEED), conf)
    make_statistics_trainable(params0["crepe"])
    cpu = torch.device("cpu")
    set_stft_impl("pallas")
    try:
        # Random CREPE weights leave near-ties between pitch bins; an argmax
        # that falls differently on card and CPU moves f0 by 20 cents or
        # more, a difference that is not a fault.  Take the first audio
        # seed whose centres agree.
        for audio_seed in FT_AUDIO_SEEDS:
            audio = tone_batch(conf.batch_size, conf.example_length, conf.sample_rate, audio_seed)
            on_card, f0 = pitch_centres(copy.deepcopy(params0).to(device), audio, conf, device)
            differ = int((on_card != pitch_centres(params0, audio, conf, cpu)[0]).sum())
            log(f"[finetune-step] weights seed {FT_PARAM_SEED}, audio seed {audio_seed}: "
                f"{differ} of {on_card.size} argmax centres differ card vs CPU; decoded f0 "
                f"{f0.min():.2f}-{f0.max():.2f} Hz")
            if differ == 0:
                break
        require(differ == 0, f"no audio seed of {FT_AUDIO_SEEDS} gives equal argmax centres")
        out, on_auto = {}, {}
        for dev in (device, cpu):
            params = copy.deepcopy(params0).to(dev)
            batch = {"audio": torch.from_numpy(audio).to(dev)}
            set_stft_impl("auto")  # for information: the float32 torch.stft route
            on_auto[dev.type] = finetune_gradients(params, batch, conf, PRNGKey(SEED, dev))[1]
            set_stft_impl("pallas")
            loss, grads = finetune_gradients(params, batch, conf, PRNGKey(SEED, dev))
            state = trainer.TrainState(0, params, trainer.make_optimizer(conf).init(
                list(params.parameters())), PRNGKey(SEED, dev))
            t0 = time.perf_counter()
            state, metrics = trainer.make_finetune_step(conf)(state, batch)
            step_loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
            log(f"[finetune-step] {dev}: loss {step_loss:.6f}, grad_norm {grad_norm:.6f}, "
                f"{time.perf_counter() - t0:.2f} s")
            out[dev.type] = (loss, grad_norm, grads)
    finally:
        set_stft_impl("auto")
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = out["cuda"], out["cpu"]
    loss_err, norm_err = abs(l_gpu - l_cpu) / abs(l_cpu), abs(n_gpu - n_cpu) / n_cpu
    require(np.isfinite(l_gpu) and loss_err <= FT_LOSS_RTOL,
            f"finetune loss card {l_gpu} vs CPU {l_cpu}: {loss_err:.3e} relative > {FT_LOSS_RTOL}")
    require(np.isfinite(n_gpu) and norm_err <= GRAD_RTOL,
            f"finetune grad_norm card {n_gpu} vs CPU {n_cpu}: {norm_err:.3e} relative > {GRAD_RTOL}")
    leaf, crit, rel = worst_leaf(g_gpu, g_cpu, FT_GRAD_RTOL)
    crepe = [k for k in g_cpu if k.startswith("crepe.")]
    share = float(torch.sqrt(sum((g_cpu[k] ** 2).sum() for k in crepe))
                  / torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values())))

    def crepe_worst(gpu, ref):  # the largest |diff| / |g| of a CREPE leaf
        rels = {k: float((gpu[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-300)) for k in crepe}
        k = max(rels, key=rels.get)
        return k, rels[k]

    log(f"[finetune-step] card vs CPU, {len(g_cpu)} leaves ({len(crepe)} CREPE, BatchNorm "
        f"statistics among them): loss {loss_err:.3e} relative, grad_norm {norm_err:.3e} "
        f"relative; worst leaf {leaf}: |diff| {rel:.3e} of its norm, criterion {crit:.4f} "
        f"(< 1 passes)")
    log("[finetune-step] for information: CREPE holds {:.2e} of the gradient's norm; its worst "
        "leaf {} is {:.3e} of its norm apart on the kernel route, and {} {:.3e} on the float32 "
        "torch.stft route".format(share, *crepe_worst(g_gpu, g_cpu),
                                  *crepe_worst(on_auto["cuda"], on_auto["cpu"])))
    require(crit < 1.0, f"finetune gradient of {leaf} differs: criterion {crit:.4f} >= 1")


# --------------------------------------------------------------- phase 10


def phase_finetune_cli(device, auto_ms: float):
    """The training CLI at full width on the kernel route: 10 decoder
    steps, then 10 finetune steps; returns the STFT kernels' launch
    counts."""
    import contextlib
    import io

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.data import dataset
    from ddsp_tpu_torch.ops.cuda import osc_frames, stft
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import train, trainer

    conf = Config()
    work = tempfile.mkdtemp()
    data_dir, ckpt_dir = os.path.join(work, "data"), os.path.join(work, "ckpt")
    write_tones(data_dir, conf.sample_rate, SEED + 11)
    argv = [f"--data_dir={data_dir}", f"--checkpoint_dir={ckpt_dir}",
            f"--num_steps={FT_CLI_STEPS}", f"--device_steps={FT_CLI_STEPS}",
            f"--finetune_crepe={FT_CLI_STEPS}", "--pitch_decode=weighted",
            f"--batch_size={conf.batch_size}", "--log_every=1", f"--device={device.type}"]
    stdout = io.StringIO()
    set_stft_impl("pallas")
    try:
        # the main path from here
        stft.FWD_LAUNCHES = stft.BWD_LAUNCHES = 0
        osc_frames.FWD_LAUNCHES = osc_frames.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            state = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"stft_power_fwd": stft.FWD_LAUNCHES, "stft_power_bwd": stft.BWD_LAUNCHES,
                    "osc_frames_fwd": osc_frames.FWD_LAUNCHES,
                    "osc_frames_bwd": osc_frames.BWD_LAUNCHES}
        for line in stdout.getvalue().splitlines():
            log(f"[finetune-cli] | {line}")
        rows = [json.loads(line) for line in open(os.path.join(ckpt_dir, "metrics.jsonl"))]
        ft_rows = [json.loads(line)
                   for line in open(os.path.join(ckpt_dir, "finetune_metrics.jsonl"))]
        require(rows and all(np.isfinite(r["loss"]) for r in rows), "a decoder loss is not finite")
        require([r["step"] for r in ft_rows] == list(range(1, FT_CLI_STEPS + 1)),
                f"finetune logged steps {[r['step'] for r in ft_rows]}")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in ft_rows),
                "a finetune loss is not finite")

        # exact launch counts: the target-spectrum cache (6 sizes a batch of
        # examples), then per decoder step 6 forward (the cached target is
        # not transformed) and 6 backward; per finetune step 12 forward
        # (prediction and target) and 6 backward; dumps run no loss
        n_sizes = len(conf.mss_ffts)
        n = len(dataset.load_examples(conf.replace(data_dir=data_dir)))
        frames_bins = sum((conf.example_length // int(f * (1 - conf.mss_overlap)) + 1)
                          * (f // 2 + 1) for f in conf.mss_ffts)
        cached = n * frames_bins * 4 <= trainer._SPECTRA_CACHE_BYTES
        cache_fwd = n_sizes * -(-n // conf.batch_size) if cached else 0
        want_fwd = cache_fwd + FT_CLI_STEPS * n_sizes * (1 if cached else 2) \
            + FT_CLI_STEPS * 2 * n_sizes
        want_bwd = 2 * FT_CLI_STEPS * n_sizes
        log(f"[finetune-cli] {n} examples, target spectra cached: {cached}; K3 launched "
            f"{launches['stft_power_fwd']} times (expected {want_fwd}), K4 "
            f"{launches['stft_power_bwd']} (expected {want_bwd}); K1 {launches['osc_frames_fwd']}, "
            f"K2 {launches['osc_frames_bwd']}")
        require(launches["stft_power_fwd"] == want_fwd,
                f"K3 launched {launches['stft_power_fwd']} times, expected {want_fwd}")
        require(launches["stft_power_bwd"] == want_bwd,
                f"K4 launched {launches['stft_power_bwd']} times, expected {want_bwd}")

        ft_dir = os.path.join(ckpt_dir, "finetune")
        latest = trainer.latest_checkpoint(ft_dir)
        require(latest is not None and latest.endswith(f"step_{FT_CLI_STEPS:08d}"),
                f"latest finetune checkpoint {latest}")
        restored = trainer.restore_checkpoint(
            latest, trainer.init_finetune_state(PRNGKey(99), conf, device=device))
        require(restored.step == FT_CLI_STEPS, f"restored finetune step {restored.step}")
        want_sd = state.params.state_dict()
        for k, v in restored.params.state_dict().items():
            require(torch.equal(v, want_sd[k]), f"restored finetune parameter {k} differs")
        n_stats = sum(1 for k, _ in restored.params.named_parameters() if "running_" in k)
        require(n_stats == 12, f"{n_stats} BatchNorm statistics among the finetune leaves")
        ft_ms = statistics.median(
            1e3 * (b["time"] - a["time"]) for a, b in zip(ft_rows[1:], ft_rows[2:]))
        log(f"[finetune-cli] {FT_CLI_STEPS} decoder + {FT_CLI_STEPS} finetune steps at batch "
            f"{conf.batch_size}, full width: {wall:.1f} s in all; finetune losses "
            f"{[round(r['loss'], 3) for r in ft_rows]}; checkpoint {os.path.basename(latest)} "
            f"restores equal, CREPE and its 12 BatchNorm statistics included")
        log(f"[finetune-cli] steady state: median {ft_ms:.3f} ms per finetune step "
            f"(steps 3-{FT_CLI_STEPS}, logged every step)")

        # the decoder step on each route, alternating in this call
        step_ms = decoder_step_ms(device, ("auto", "pallas", "pallas", "auto"))
    finally:
        set_stft_impl("auto")
    log(f"[finetune-cli] decoder train step at batch {conf.batch_size}: 'pallas' "
        f"{statistics.median(step_ms['pallas']):.3f} ms, 'auto' "
        f"{statistics.median(step_ms['auto']):.3f} ms (medians, alternating, synchronised "
        f"steps); phase 7's 'auto' CLI window median {auto_ms:.3f} ms")
    return launches, ft_ms, step_ms


def decoder_step_ms(device, order, steps: int = 5):
    """{impl: [ms per synchronised decoder train step]} at full width,
    batch 16, running the routes in ``order``."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.ops.spectral import set_stft_impl
    from ddsp_tpu_torch.training import trainer

    conf = Config()
    state = trainer.init_state(PRNGKey(SEED), conf, device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in feature_batch(conf, conf.batch_size, SEED + 5).items()}
    step = trainer.make_train_step(conf)
    times = {impl: [] for impl in order}
    for impl in order:
        set_stft_impl(impl)
        state, _ = step(state, batch)  # warm-up
        torch.cuda.synchronize()
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            times[impl].append(1e3 * (time.perf_counter() - t0))
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ddsp_tpu_torch  # noqa: F401 -- fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    from ddsp_tpu_torch.ops.spectral import set_stft_impl

    build_kernels()
    set_stft_impl("auto")
    kernel = phase_kernel(device)
    launches, params, crepe, conf = phase_serving(device)
    phase_socket(device, params, crepe, conf)
    frames = phase_frames(device)
    phase_train_step(device)
    train_launches, auto_ms = phase_training(device)
    try:
        stft_kernels = phase_stft(device)
        phase_finetune_step(device)
        ft_launches, _, _ = phase_finetune_cli(device, auto_ms)
    finally:
        set_stft_impl("auto")

    no_library = ("null: no single PyTorch call computes a harmonic sine-bank render or its "
                  "gradient; the nearest is the plain version")
    kernels = [dict(
        name="osc_hop_slots", route="cuda", source="ddsp_tpu_torch/csrc/osc_hop_slots.cu",
        replaces="ddsp_tpu/ops/pallas/oscillator.py:446", tpu_function="_kernel_banked",
        launches=launches, library_ms=None, library=no_library, **kernel)]
    for name, line, tpu in (("osc_frames_fwd", 152, "_kernel_banked2"),
                            ("osc_frames_bwd", 777, "_kernel_banked2_bwd")):
        kernels.append(dict(
            name=name, route="cuda", source="ddsp_tpu_torch/csrc/osc_frames.cu",
            replaces=f"ddsp_tpu/ops/pallas/oscillator.py:{line}", tpu_function=tpu,
            launches=train_launches[name], library_ms=None, library=no_library,
            **frames[name]))
    for name, line, tpu in (("stft_power_fwd", 113, "_fwd_kernel"),
                            ("stft_power_bwd", 139, "_bwd_kernel")):
        kernels.append(dict(
            name=name, route="cuda", source="ddsp_tpu_torch/csrc/stft_power.cu",
            replaces=f"ddsp_tpu/ops/pallas/stft.py:{line}", tpu_function=tpu,
            launches=ft_launches[name], **stft_kernels[name]))
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    # one card driven, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
