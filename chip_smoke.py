#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ddsp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them; every
   kernel source in ``ddsp_tpu_torch/csrc/`` is built with nvcc for
   sm_90a, one nvcc per source, all started together;
2. kernel vs plain: ``osc_hop_slots`` on the card's default fill (the
   rotation fill of ``_kernel_banked``) is held against its plain PyTorch
   version on that fill at the serving shapes (N=256, 1024 and 2048 slots,
   hop 512, H=180), at the real-time hop's (N=1, hop 512, H=180) and at a
   ragged shape (N=13, hop 128, H=40), SNR > 90 dB, and so is its exact
   fill ('xla'); all are timed with CUDA events beside the bound, the
   kernel also inside a CUDA graph (its device time: a call from Python
   takes longer on the host than the kernel on the card);
3. the serving step at full default width: ``MultiStreamServer`` with 256
   slots and seeded random weights for 100 hops of tone plus noise.  The
   kernel's launch count must grow by one per hop, all on the rotation fill
   (``osc_impl`` 'auto' on the card); slots 0, 1 and 255 must
   equal lone single-stream runs at batch 1 within 2e-5 absolute (the
   lone stream itself moves by up to 1.14e-5 between batch 1 and 256,
   ``utils/slot_parity.py``), with the same CREPE pitch bins, and slot 0
   its lone stream run on 256 rows within 1e-5; the median ms per hop is
   printed for 256, 1024 and 2048 slots against the 11.6 ms hop deadline,
   and at 1024 and 2048 the kernel must launch once a hop on the rotation
   fill too;
4. the socket server: ``StreamServer`` at full width on a unix socket, four
   concurrent clients streaming 1 s each, each equal to its slot driven
   through ``MultiStreamServer``;
5. the frame oscillator kernels ``osc_frames_fwd`` (K1) / ``osc_frames_bwd``
   (K2 and its overlap-add kernel) on the card's default rotation fill
   against their plain versions on that fill, at the training shape
   (B=16, T=172, hop 512, H=180, h_start 0) and a ragged one (B=2, T=18,
   hop 128, H=40, h_start 8): forward SNR > 90 dB, each gradient > 80 dB,
   two backward runs bit-equal, the overlap-add kernel bit-equal to its
   plain version; K1, K2 with its overlap-add, K2 alone and the
   overlap-add timed with CUDA events a call and replayed from a CUDA
   graph, beside the bounds, the plain versions, ``torch.index_add`` for
   the overlap-add and the exact fill's kernels; the ptxas registers and
   spills of ``osc_frames.cu``'s kernels logged;
6. one train step at full ``Config()`` width, batch 2, on the float32
   reverb route (``reverb_grad_matmul_dtype='float32'``, as in phases 9
   and 12, which this phase's criterion was set on), on the card
   (kernels) and on the CPU (plain path) from the same weights, batch and
   key: the step's gradients, leaf by leaf, within 1e-3 of the CPU's in
   norm (plus 1e-6 of the whole gradient's norm), ``grad_norm`` within
   1e-3 relative, loss within max(1e-2, 1e-6 |loss|), the card on the
   rotation fill and the CPU on the exact fill (``osc_impl`` 'auto'); the updated
   parameters at allclose(rtol=2e-3, atol=3e-3), a sanity check only,
   since one Adam step moves a parameter by at most lr = 1e-3;
7. the training CLI at full width: ``ddsp_tpu_torch.training.train.main``
   on synthetic WAV files, batch 16, 30 steps in windows of 10, a
   checkpoint every 10 steps.  The backward kernel and its overlap-add
   must launch once per step and the forward kernel once per step plus
   once per reconstruction dump, every launch on the rotation fill; the
   default
   bf16 reverb backward launches S1 (``ct_conv``) once per step, through
   the fused d/dsignal entry; every logged loss is finite; the last checkpoint
   restores with equal parameters; median ms per step is printed.
   Phases 1-7 run on the default 'auto' STFT route (float32 torch.stft),
   and the power-STFT kernels must not launch in phase 7.
8. the power-STFT kernels ``stft_power_fwd`` (K3) / ``stft_power_bwd``
   (K4) against their plain versions at the training shape (B=16, 88,064
   samples, n_fft 2048 ... 64 at hop n_fft/4) and a ragged one (B=3, 5,000
   samples, n_fft 256 and 64): forward SNR > 90 dB, the backward within
   the JAX suite's bf16 criterion (max |diff| <= 5e-3 max |g|, cosine >
   0.9999), two backward runs bit-equal; per size and summed over the six,
   the kernels (K4: its recompute and shifted-product launches), the plain
   versions and torch.stft + |X|^2 (forward and autograd backward) timed
   with CUDA events beside the bounds, a call from Python and (the kernels
   always, torch.stft where it captures) replayed from a CUDA graph;
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
   and cached target batches (K4's recompute launches equal to K4's),
   S1's its 20 steps (through the fused
   d/dsignal), K1/K2 on the rotation fill, K2's overlap-add once per K2
   launch; every logged loss is
   finite; the finetune
   checkpoint restores with equal parameters, CREPE and its BatchNorm
   statistics included; median ms per finetune step, and per decoder step
   on 'pallas' beside 'auto' (alternating in this call), are printed.
   The STFT route is reset to 'auto' afterwards, whatever happens.
11. the oscillator's variant kernels through the port of the oscillator
   sweeps (``ddsp_tpu_torch.utils.osc_sweep``: the counterparts of
   ``_pallas_forward`` / ``_pallas_backward``) at the training shape and
   the ragged one (h_start 8; 0 for K7, which has none): K7
   (``osc_cheb_fwd``), K6 (``osc_banked_bwd``), S2 (``osc_fill_only``),
   every K8 option set of K1/K2 (``osc_frames_fwd[...]`` /
   ``osc_frames_bwd[...]``) and K5 over frame rows with h_start.  Each is
   held against its plain version (float32 forward > 90 dB, gradients > 80
   dB, bf16 > 60 dB) and against a float64 oracle on two batch rows
   (float32 at the same floors; bf16 and K6 > 45 dB with cosine > 0.9999;
   K7 > 90 dB at its default resync 32, the other cadences recorded), K6
   against K2 at the bf16 floor (both bank dtypes); backward reruns
   bit-equal; in the SASS (``cuobjdump``) of the instantiation the
   training shape runs, K6 has tensor-core products and S2 none, S2 no
   shared-memory store, and S2 as many fragment transposes (MOVM) as K6
   and two bf16 packs (F2FP) a transpose, so no fill chain was dropped;
   kernel, plain version and bound timed; the launches of every kernel
   equal to the count the sweep implies.
12. one full-width train step at batch 2 under
   ``set_osc_bwd_contract_dtype('bfloat16')``, card vs CPU (the plain
   backward with the same casts) from the same weights, batch and key:
   phase 9's bf16 criterion (each gradient leaf within 5e-3 of its norm
   plus 1e-6 of the total, grad_norm 1e-3, loss as phase 6); the bf16 K2
   on the rotation fill launches once for the gradients and once in the
   step.  The setting is
   reset to None afterwards, whatever happens.
13. S1, the permuted-CT convolution of the bf16 reverb backward
   (``ct_conv``, ``ddsp_tpu_torch.utils.ct_conv_ab``): against its plain
   version at the training shape (16 complex rows of 98,304, (n1, n2) =
   (384, 256)) and a ragged one (3 rows of 6144, (96, 64)), >= 70 dB, and
   against a float64 FFT convolution on two rows, >= 44 dB, reruns
   bit-equal; kernel, plain version and cuFFT's ifft(fft(z) K) timed with
   CUDA events beside the bound; the fused d/dsignal entry
   (``ct_conv_dsignal``) at the training shape against its plain version,
   >= 70 dB, bit-equal on rerun, timed beside the plain version, the
   unfused route and cuFFT's float32 correlation; the reverb's float32 and
   bf16 routes fwd+bwd, interleaved (``utils/profile_reverb_grad``); then
   one full-width train step at batch 2 on the default bf16 reverb route,
   card vs CPU, at phase 9's bf16 criterion (each leaf within 5e-3 of its
   norm plus 1e-6 of the total, grad_norm 1e-3, loss as phase 6), S1
   launched exactly once for the gradients and once in the step, each
   time through the fused entry.
14. the single-stream real-time path at full ``Config()`` width, batch 1,
   seeded random weights: ``BlockSynthesizer`` over 200 hops of tone plus
   noise and its flush, bit-equal to ``utils/slot_parity.lone_stream`` plus
   the flush step, K5 launched exactly 1 (warm-up) + 200 + 1 (flush)
   times, all on the rotation fill, counted from its construction to the
   flush; every hop's K5 output in the lone-stream run held against its
   plain version on the same operands, SNR > 90 dB; the median and p99 ms
   per ``process`` call and ``missed_deadlines`` against the 11.61 ms hop,
   printed, not judged; ``ThreadedSynthesizer`` with the 200 hops pushed
   at the hop's pace, its output past the latency pre-fill bit-equal to
   that run (its underruns and its worker's ms a call printed);
   ``run_file_loopback`` over a 2 s synthetic WAV, its output equal to a
   BlockSynthesizer run written the same way (its ms a call printed);
   ``oscillator_live`` (batch 1, 4 frames with context) against its plain
   version on the card > 90 dB, K1 launched once a call on the rotation
   fill; last, the card's busy ms and kernel launches a hop over a
   profiled window;
15. the precision options: one full-width train step at batch 2 with
   ``compute_dtype='bfloat16'``, card vs CPU, at phase 9's bf16 criterion;
   CREPE at full width with ``crepe_compute_dtype='bfloat16'`` through
   ``f0_encoder_apply`` on two 2 s tones, card vs CPU, argmax bins equal
   (the first audio seed whose bins agree, as phase 9 chooses), the
   logits' agreement printed.
16. offline reconstruction at full ``Config()`` width: a 60 s, 48 kHz,
   stereo 16-bit WAV (a seeded gliding tone plus noise), phase 9's seeded
   weights written as a Lightning ``.ckpt`` (``save_torch_decoder``) and a
   CREPE ``.pth``; ``python -m ddsp_tpu_torch.reconstruct`` on it with
   ``--export_torch`` in a process of its own: exit 0, its stats JSON, a
   finite, not silent output WAV of the prepared length, the export read
   back bit-equal; in this process ``reconstruct_file`` (counted from 0)
   launches K1 once on the rotation fill and no other hand kernel, and
   writes the CLI's output again; K1 on that call's operands (B=1, T =
   5,168 frames) against its plain version in frame chunks > 90 dB, timed
   a call and in a CUDA graph beside its bound and its rot floor estimate;
   the warm call's wall seconds and real-time factor, and the card's busy
   ms and launches over one profiled call, printed; the card against the
   CPU's plain path on the file's first 4 s: f0 bins equal, loudness
   within 1e-5, audio > 100 dB.
17. the parallel layer (``ddsp_tpu_torch.parallel``): one spawn of 8 gloo
   ranks sharing ``cuda:0`` (``parallel.launch.run_ranks``, a hard time
   limit; a rank that fails or hangs fails the phase) prints which
   collectives gloo takes for CUDA tensors, then runs, on ranks 0..n-1,
   ``render_long_audio`` on 4 time shards over phase 16's 60 s file's
   features (T = 5,168) with phase 16's decoder, a 344-frame render whose
   reverb halo spans two left shards, ``render_controls_tp`` at B = 16,
   T = 172 on 4 and 8 model ranks (h_start 0/45/90/135; 180 harmonics
   padded to 184, 23 a shard), ``render_controls_time_tp`` on 2 x 2 over
   the file, and three ``make_parallel_train_step`` steps at full width,
   global batch 16, on 2 and on 4 ranks; then a nccl world of one rank
   runs the long render and one DP step.  Each render against the
   unsharded card render > 70 dB, every rank's copy equal, K1 launched
   once a rank on the rotation fill at that rank's h_start, and every
   time shard but the first entering K1 at a nonzero phase; each DP step
   against the single-card step from the same state (rank 0's parameters
   and key before it) at phase 9's bf16 criterion, K2 and S1 once a step
   on every rank, the replicas' state checksums bit-equal after the
   steps (the free-running single-card steps printed beside, not judged:
   Adam parts the two runs); K1 at the TP shard shape (B=16, T=172, hop
   512, H=45, h_start 135) against its plain version > 90 dB and timed.
   Wall ms per rank beside the unsharded run, printed with the card's
   name and power limit: the ranks share one card, so they are not
   scale-out figures.
18. the spectrogram experiments at their full sizes.  Style transfer at
   ``StyleTransferConfig()`` (n_fft 2048, hop 512, kernel 17, 4096
   features, 44.1 kHz): a 3 s harmonic glide as content and
   ``utils/gl_quality_curve.fixture_audio`` as style, 20 L-BFGS steps on
   the zoom line search (after one untimed evaluation, cuDNN's first
   call), each timed with its loss evaluations, stepsize and line-search
   steps, and a 21st under the profiler (the card's busy ms and its
   costliest kernels); the loss and the Gram distance must fall; the
   card's extractor draw against the CPU's on its first 2^20 elements;
   the first two steps on the CPU from the card's extractor, the iterate
   within 1e-4 of its displacement, loss and stepsize within 1e-4
   relative, line-search steps equal.  Then the 512-iteration Griffin-Lim
   inversion of the result, timed a run and an iteration, its spectral
   convergence printed; 8 iterations card vs CPU > 90 dB; and the
   Griffin-Lim quality curve (64 ... 5000 iterations) on the fixture.
   DeepDream on CREPE ``Config().crepe_capacity`` with seeded weights:
   ``dream_file`` on a 4 s, 16 kHz WAV (63,488 samples after the
   truncation) at the reference's 20 iterations, lr 10, layer 2; the
   activation norm must rise; the first 3 iterations card vs CPU > 80 dB
   (at this length lr 10 magnifies float noise to ~94 dB even between
   two CPU runs) and the norm within 1e-5; ms an iteration printed.

The line before the last is a JSON object describing each kernel (launches
on its main path, the real-time path's launches of K5 and K1 as
``launches_realtime``, the reconstruction's K1 launches as
``launches_reconstruct`` with its timing at that shape, phase 17's
launches of K1, K2 and S1 as ``launches_parallel`` and K1 at the TP
shard shape as ``parallel_tp_shard``, agreement with its
plain version, kernel, plain, bound and library times); the last line is
``{"ok": true, "device": {...}}``.
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
DEADLINE_HOPS = 25  # hops timed at each N above N_SLOTS
KERNEL_SNR_FLOOR_DB = 90.0
# A slot vs its lone stream at the server's batch size, and a socket
# client vs its slot: the JAX contract's 1e-5 (tests/test_multistream.py).
SLOT_ATOL = 1e-5
# A slot vs its lone stream at batch 1: the lone stream itself moves by up
# to 1.14e-5 between batch 1 and batch 256 at full width on an H100, on
# either fill (utils/slot_parity.py: the controller's and the noise
# filter's library calls round differently at the two batch sizes, ~1e-6,
# and synthesis and the seeded reverb, peak |audio| ~30, carry it to the
# output; K5 and the reverb compute a row alike at any batch size).  So
# this comparison is held at twice that.
SLOT_BATCH_ATOL = 2e-5
# H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Cheapest known evaluation of one (sample, harmonic) point, counted from
# K7 (csrc/osc_cheb.cu), which holds > 90 dB against float64 at full width
# (phase 11): the recurrence (one multiply, one subtract), two window
# multiply-adds (hop % 256 == 0), and two exact sines every 32 harmonics,
# each ~24 FLOP (the split phase's 7 operations, sinf's reduction and
# polynomial): 2 + 4 + 48/32 = 7.5 FLOP.  The bound of K1, K5 and K7.
FLOP_PER_POINT = 7.5
# The frame backward per point: the (sin, cos) rotation, the seed
# amortised, and three window sums each for harm, the phase derivative
# and the window-amplitude gradient: 14 FMAs, 28 FLOP.
FLOP_PER_POINT_BWD = 28
GRAD_SNR_FLOOR_DB = 80.0
# K6 and S2 per point: the rotation of a (sine, cosine) pair (4 multiplies,
# 2 adds) and its exact seeds amortised (~1.5 FLOP) at the fp32 peak; K6's
# three contractions, 2 FLOP x 3 windows each, at the bf16 dense peak.
FILL_FLOP_PER_POINT = 7.5
K6_MMA_FLOP_PER_POINT = 18
# Phase 11: bf16 variants against their plain versions, and against the
# float64 oracle (one bf16 pass measures ~54 dB, docs/PERFORMANCE.md:425).
BF16_PLAIN_FLOOR_DB, BF16_F64_FLOOR_DB, BF16_COS = 60.0, 45.0, 0.9999
VARIANT_ITERS = 20
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
# S1 (phase 13): the bf16 reverb backward's training shape (16 complex rows
# of 98,304, (n1, n2) = (384, 256)) and a ragged one ((96, 64)); against
# its plain version (the same bf16 roundings, float32 sums in another
# order: one bf16 ulp flips), and one bf16 pass against float64 (the plain
# version measures 47.4-47.6 dB on the CPU, tests/test_torch_ct_conv.py).
CT_SHAPES = ((16, 98304), (3, 6144))
CT_PLAIN_FLOOR_DB, CT_F64_FLOOR_DB = 70.0, 44.0
CT_ITERS = 20
# The real-time path (phase 14): hops of one stream at batch 1, and the
# frames of an oscillator_live block.
RT_BLOCKS = 200
RT_LIVE_FRAMES = 4
RT_PROFILE_HOPS = 30
# phase 16: offline reconstruction of a 60 s, 48 kHz stereo 16-bit WAV
RECON_SECONDS, RECON_RATE = 60, 48000
RECON_CPU_SECONDS = 4  # the card vs the CPU's plain path on the first 4 s
RECON_PLAIN_FRAMES = 1024  # K1's plain version in chunks of this many frames
RECON_LOUD_ATOL = 1e-5
# reconstruct_file's float audio on the card vs on the CPU over the first
# 4 s: 125.41 dB (H100 80GB HBM3, 700.00 W); the floor leaves a margin
# under it
RECON_AUDIO_FLOOR_DB = 100.0
# An untrained reverb (wet 0, decay 5) has an impulse response of gain ~20:
# its output (rms ~6) would clip to +-1 in the 16-bit WAV almost
# everywhere.  At this wet logit the seeded decoder's output stays inside
# +-1 (rms ~0.26 on the CPU), so the WAV checks see the amplitudes.
RECON_REVERB_WET = -6.0
# the WAV's step: |16-bit sample - the float written| stays below it
WAV_STEP = 2.0 / 32768
# K1's rot issue-slot floor at the training shape (16 x 172 x 512 =
# 1,409,024 samples, PERF.md section 6), scaled by samples: an estimate,
# not a measurement
K1_ROT_FLOOR_MS, K1_ROT_FLOOR_SAMPLES = 0.0991, 1409024


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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels' time without their Python wrapper's
    host time, which bounds ``cuda_ms`` for calls shorter than it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    """K5 on the card's default fill (the rotation fill of ``_kernel_banked``)
    against its plain version on that fill at 256, 1024 and 2048 serving
    slots, the real-time path's one slot and a ragged shape; the exact fill
    (``osc_impl`` 'xla') held and timed beside it."""
    import torch

    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda

    result = {"slots": {}}
    for n, hop, h in (*((n, 512, 180) for n in DEADLINE_SLOTS), (1, 512, 180), (13, 128, 40)):
        inputs = kernel_inputs(n, hop, h, device, seed=n)
        for fill in ("rot", "exact"):
            got = osc_cuda.osc_hop_slots(*inputs, fill=fill)
            torch.cuda.synchronize()
            want = osc_cuda.render_hop_slots_plain(*inputs, fill=fill)
            got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
            del got, want
            require(np.isfinite(got_np).all(), f"kernel output not finite at {(n, hop, h)}")
            snr = snr_db(want_np, got_np)
            err = float(np.abs(got_np - want_np).max())
            require(snr > KERNEL_SNR_FLOOR_DB,
                    f"kernel ({fill}) vs plain SNR {snr:.2f} dB <= {KERNEL_SNR_FLOOR_DB} at "
                    f"{(n, hop, h)}")
            kernel_ms = cuda_ms(lambda: osc_cuda.osc_hop_slots(*inputs, fill=fill), iters=200)
            in_graph_ms = graph_ms(lambda: osc_cuda.osc_hop_slots(*inputs, fill=fill), iters=200)
            plain_ms = cuda_ms(
                lambda: osc_cuda.render_hop_slots_plain(*inputs, fill=fill), iters=10)
            bound_ms, bound_by = kernel_bound_ms(n, hop, h)
            log(f"[kernel] N={n} hop={hop} H={h} fill={fill}: SNR {snr:.2f} dB, max |err| "
                f"{err:.3e}, kernel {kernel_ms:.5f} ms a call ({in_graph_ms:.5f} ms in a CUDA "
                f"graph), plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            row = dict(snr_db=snr, max_abs_err=err, ms=kernel_ms, graph_ms=in_graph_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            if n in DEADLINE_SLOTS or n == 1:
                result["slots"].setdefault(str(n), {})[fill] = row
            if n == N_SLOTS and fill == "rot":
                result.update(row, fill="rot")
            elif n == N_SLOTS:
                result["exact_fill"] = {k: row[k] for k in ("snr_db", "ms", "graph_ms",
                                                            "plain_ms")}
    log("[kernel] library_ms: null -- no single PyTorch call computes a harmonic "
        "sine-bank sum; the nearest is the plain einsum version timed above")
    return result


# --------------------------------------------------------------- phase 3


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
    from ddsp_tpu_torch.utils.slot_parity import lone_stream, tone_blocks

    conf = Config()
    deadline_ms = 1e3 * conf.hop_length / conf.sample_rate
    params, crepe = decoder_init(conf, seed=SEED), crepe_init(conf.crepe_capacity, seed=SEED + 1)
    blocks = tone_blocks(N_SLOTS, N_HOPS, conf.hop_length, conf.sample_rate, SEED)
    server = MultiStreamServer(params, crepe, conf, N_SLOTS, noise_seed=SEED, device=device)

    rot = osc_cuda.variant_name("rot")
    osc_cuda.LAUNCHES = 0  # counts from here to the read below: the main path
    osc_cuda.VARIANT_LAUNCHES.clear()
    out, times = hop_times(server, blocks)
    launches, by_fill = osc_cuda.LAUNCHES, dict(osc_cuda.VARIANT_LAUNCHES)
    log(f"[serving] N={N_SLOTS} x {N_HOPS} hops at full width: {launches} kernel launches "
        f"{by_fill} (osc_impl {conf.osc_impl!r})")
    require(by_fill == {rot: N_HOPS}, f"serving launched {by_fill}, not {N_HOPS} x {rot}")
    require(out.shape == (N_SLOTS, N_HOPS, conf.hop_length), f"output shape {out.shape}")
    require(np.isfinite(out).all(), "serving output not finite")
    require(np.abs(out[:, 2:]).max() > 1e-3, "serving output is silent")
    require(launches == N_HOPS, f"{launches} kernel launches for {N_HOPS} hops")
    median = {N_SLOTS: statistics.median(times[5:])}

    bins = batched_bins(crepe, conf, blocks, device)
    key = PRNGKey(SEED, device)
    worst_err = 0.0
    for i in CHECK_SLOTS:
        want, want_bins = lone_stream(params, crepe, conf, fold_in(key, i), blocks[:, i], device)
        require(np.array_equal(bins[i], want_bins), f"slot {i}: CREPE bins differ from lone stream")
        err = float(np.abs(out[i] - want).max())
        log(f"[serving] slot {i} vs lone stream (batch 1): max |err| {err:.3e}, SNR "
            f"{snr_db(want, out[i]):.2f} dB, peak |audio| {np.abs(want).max():.3f}, bins equal")
        worst_err = max(worst_err, err)
    require(worst_err <= SLOT_BATCH_ATOL,
            f"slot vs lone stream (batch 1) max |err| {worst_err:.3e} > {SLOT_BATCH_ATOL}")
    # the same stream on N_SLOTS rows: slot 0 and row 0 meet the same library calls
    want, _ = lone_stream(params, crepe, conf, fold_in(key, 0), blocks[:, 0], device,
                          batch=N_SLOTS)
    err = float(np.abs(out[0] - want).max())
    log(f"[serving] slot 0 vs lone stream on {N_SLOTS} rows (row 0): max |err| {err:.3e}")
    require(err <= SLOT_ATOL, f"slot 0 vs lone stream at batch {N_SLOTS}: {err:.3e} > {SLOT_ATOL}")

    launches_by_slots = {N_SLOTS: launches}
    for n in DEADLINE_SLOTS[1:]:
        big = MultiStreamServer(params, crepe, conf, n, noise_seed=SEED, device=device)
        blocks_n = tone_blocks(n, DEADLINE_HOPS, conf.hop_length, conf.sample_rate, SEED + n)
        osc_cuda.LAUNCHES = 0  # this N's hops, read just after
        osc_cuda.VARIANT_LAUNCHES.clear()
        _, t = hop_times(big, blocks_n)
        by_fill_n = dict(osc_cuda.VARIANT_LAUNCHES)
        require(by_fill_n == {rot: DEADLINE_HOPS} and osc_cuda.LAUNCHES == DEADLINE_HOPS,
                f"serving {n} slots launched {by_fill_n}, not {DEADLINE_HOPS} x {rot}")
        launches_by_slots[n] = osc_cuda.LAUNCHES
        median[n] = statistics.median(t[5:])
        del big
    fits = [n for n in DEADLINE_SLOTS if median[n] <= deadline_ms]
    for n in DEADLINE_SLOTS:
        log(f"[serving] N={n}: median {median[n]:.3f} ms/hop "
            f"({'within' if n in fits else 'over'} the {deadline_ms:.1f} ms deadline)")
    log(f"[serving] real-time slots per card (largest N measured within the deadline): "
        f"{max(fits) if fits else 0}")
    return ({"launches": launches, "launches_by_variant": by_fill,
             "launches_by_slots": launches_by_slots}, params, crepe, conf)


# --------------------------------------------------------------- phase 4


def phase_socket(device, params, crepe, conf):
    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda
    from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
    from ddsp_tpu_torch.runtime.server import StreamServer, stream_blocks
    from ddsp_tpu_torch.utils.slot_parity import tone_blocks

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
    """(forward, backward, overlap-add) bounds: each a (ms, "operations" |
    "bytes")."""
    points = b * t * hop * h
    samples, rows = b * t * hop, b * (t + 2)
    fwd_bytes = 4 * (samples + rows * h + rows + 3 * hop + samples)
    # in: g, phase, amps_pad, loud_pad, w; out: dphase, d amps_pad, d loud_pad
    bwd_bytes = 4 * (2 * samples + rows * h + rows + 3 * hop + samples + rows * h + rows)
    # in: da_win, dl_win; out: d amps_pad, d loud_pad (two adds an output)
    oa_bytes, oa_flop = 4 * (b * t * 3 * (h + 1) + rows * (h + 1)), 2 * rows * (h + 1)
    out = []
    for flop, n_bytes in ((FLOP_PER_POINT * points, fwd_bytes),
                          (FLOP_PER_POINT_BWD * points, bwd_bytes), (oa_flop, oa_bytes)):
        t_ops, t_bytes = flop / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return out


def ptxas_report(name: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack}} from the
    ``-Xptxas -v`` report of ``csrc/<name>.cu``'s build, the kernels named
    by their template arguments (``osc_frames_bwd_kernel<fill=rot,bf16=0>``)."""
    import re

    from ddsp_tpu_torch.ops.cuda import build

    fills = ("exact", "rot", "cheb8")  # osc::Fill
    report, entry = {}, None
    for line in build.build(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            # ..._13_osc_frames_cu_5f1431cc21osc_frames_bwd_kernelILi1ELb0EE...
            t = re.search(r"\d(osc_[a-z_]+_kernel)(?:ILi(\d)ELb([01])E)?", mangled)
            entry = (mangled if t is None else t.group(1) if t.group(2) is None
                     else f"{t.group(1)}<fill={fills[int(t.group(2))]},bf16={t.group(3)}>")
            report[entry] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            report[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            report[entry]["registers"] = int(m.group(1))
    return report


def overlap_add_library(da_win, dl_win, t: int):
    """The overlap-add as PyTorch's ``index_add`` (one call a tensor, on
    zeros): timed beside the kernel, used nowhere in the port."""
    import torch

    b, _, _, h = da_win.shape
    rows = (torch.arange(t, device=da_win.device)[:, None]
            + torch.arange(3, device=da_win.device)).reshape(-1)  # window (t, k) -> row t + k
    zeros_a = torch.zeros((b, t + 2, h), device=da_win.device)
    zeros_l = torch.zeros((b, t + 2), device=da_win.device)
    return lambda: (torch.index_add(zeros_a, 1, rows, da_win.reshape(b, 3 * t, h)),
                    torch.index_add(zeros_l, 1, rows, dl_win.reshape(b, 3 * t)))


def phase_frames(device):
    """K1 and K2 on the card's default fill (rot) against their plain
    versions on that fill, K2's overlap-add bit-equal to its plain version;
    times a call and in a CUDA graph, K2's kernel also alone; the exact
    fill's kernel times beside them."""
    import torch

    from ddsp_tpu_torch.ops.cuda import osc_frames

    regs = ptxas_report("osc_frames")
    for kernel, r in regs.items():
        log(f"[frames] ptxas {kernel}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads, "
            f"{r.get('stack')} B stack")
    result = {}
    for b, t, hop, h, h_start in FRAME_SHAPES:
        shape = f"B={b} T={t} hop={hop} H={h} h_start={h_start}"
        phase, amps, loud, g = frame_operands(b, t, hop, h, h_start, device, seed=b * t)
        got = osc_frames.osc_frames_fwd(phase, amps, loud, h_start, fill="rot")
        grads = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill="rot")
        again = osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start, fill="rot")
        _, da_win, dl_win = osc_frames.osc_frames_bwd_windows(
            g, phase, amps, loud, h_start, fill="rot")
        overlap = osc_frames.osc_overlap_add(da_win, dl_win, t)
        overlap_plain = osc_frames.overlap_add_windows(da_win, dl_win, t)
        torch.cuda.synchronize()
        for name, a, c in zip(("d amps_pad", "d loud_pad"), overlap_plain, overlap):
            require(torch.equal(a.view(torch.int32), c.view(torch.int32)),
                    f"the overlap-add kernel's {name} is not bit-equal to its plain version "
                    f"at {shape}")
        oa_err = max(float((a - c).abs().max()) for a, c in zip(overlap_plain, overlap))
        want = osc_frames.render_from_phase_variant_plain(phase, amps, loud, h_start, "rot")
        want_grads = osc_frames.render_from_phase_bwd_variant_plain(
            g, phase, amps, loud, h_start, "rot")
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
                    f"{name} vs plain SNR {grad_snr[name]:.2f} dB <= {GRAD_SNR_FLOOR_DB} at {shape}")
        del want, want_grads, got, grads, again, overlap, overlap_plain
        fwd = lambda: osc_frames.osc_frames_fwd(phase, amps, loud, h_start, fill="rot")  # noqa: E731
        bwd = lambda: osc_frames.osc_frames_bwd(  # noqa: E731
            g, phase, amps, loud, h_start, fill="rot")
        bwd_alone = lambda: osc_frames.osc_frames_bwd_windows(  # noqa: E731
            g, phase, amps, loud, h_start, fill="rot")
        oa = lambda: osc_frames.osc_overlap_add(da_win, dl_win, t)  # noqa: E731
        fwd_ms, bwd_ms = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
        alone_ms, oa_ms = cuda_ms(bwd_alone, iters=20), cuda_ms(oa, iters=20)
        fwd_graph, bwd_graph = graph_ms(fwd, iters=20), graph_ms(bwd, iters=20)
        alone_graph, oa_graph = graph_ms(bwd_alone, iters=20), graph_ms(oa, iters=20)
        exact_ms = [cuda_ms(lambda: osc_frames.osc_frames_fwd(phase, amps, loud, h_start),
                            iters=20),
                    cuda_ms(lambda: osc_frames.osc_frames_bwd(g, phase, amps, loud, h_start),
                            iters=20)]
        plain_ms = cuda_ms(
            lambda: osc_frames.render_from_phase_variant_plain(phase, amps, loud, h_start, "rot"),
            iters=3, warmup=1)
        plain_bwd_ms = cuda_ms(
            lambda: osc_frames.render_from_phase_bwd_variant_plain(
                g, phase, amps, loud, h_start, "rot"), iters=3, warmup=1)
        oa_plain_ms = cuda_ms(lambda: osc_frames.overlap_add_windows(da_win, dl_win, t), iters=20)
        oa_library = overlap_add_library(da_win, dl_win, t)
        oa_library_ms = cuda_ms(oa_library, iters=20)
        (fb_ms, fb_by), (bb_ms, bb_by), (ob_ms, ob_by) = frame_bounds_ms(b, t, hop, h)
        log(f"[frames] {shape}: forward SNR {fwd_snr:.2f} dB, max |err| {fwd_err:.3e}, "
            f"kernel {fwd_ms:.5f} ms a call, {fwd_graph:.5f} in a graph, plain "
            f"{plain_ms:.5f} ms, bound {fb_ms:.5f} ms ({fb_by})")
        log(f"[frames] {shape}: backward SNR " + ", ".join(
            f"{k} {v:.2f} dB (max |err| {grad_err[k]:.3e})" for k, v in grad_snr.items())
            + f"; bit-equal on rerun; kernel + overlap-add {bwd_ms:.5f} ms a call, "
            f"{bwd_graph:.5f} in a graph; kernel alone {alone_ms:.5f} / {alone_graph:.5f}; "
            f"plain backward {plain_bwd_ms:.5f} ms, bound {bb_ms:.5f} ms ({bb_by})")
        log(f"[frames] {shape}: overlap-add bit-equal to its plain version; kernel "
            f"{oa_ms:.5f} ms a call, {oa_graph:.5f} in a graph; plain (8 launches) "
            f"{oa_plain_ms:.5f} ms; torch.index_add x2 {oa_library_ms:.5f} ms; bound "
            f"{ob_ms:.5f} ms ({ob_by})")
        log(f"[frames] {shape}: the exact fill ('xla'), for the record: forward "
            f"{exact_ms[0]:.5f} ms, backward {exact_ms[1]:.5f} ms")
        if (b, t, hop, h, h_start) == FRAME_SHAPES[0]:
            result["osc_frames_fwd"] = dict(
                snr_db=fwd_snr, max_abs_err=fwd_err, ms=fwd_ms, graph_ms=fwd_graph,
                plain_ms=plain_ms, bound_ms=fb_ms, bound_by=fb_by, fill="rot",
                exact_fill_ms=exact_ms[0],
                ptxas={k: v for k, v in regs.items() if k.startswith("osc_frames_fwd")})
            result["osc_frames_bwd"] = dict(
                snr_db=min(grad_snr.values()), max_abs_err=max(grad_err.values()),
                grad_snr_db=grad_snr, grad_max_abs_err=grad_err, ms=bwd_ms,
                graph_ms=bwd_graph, kernel_alone_ms=alone_ms, kernel_alone_graph_ms=alone_graph,
                plain_ms=plain_bwd_ms, bound_ms=bb_ms, bound_by=bb_by, fill="rot",
                exact_fill_ms=exact_ms[1], timed="the kernel and its overlap-add (ms, "
                "graph_ms); the kernel alone (kernel_alone_ms, kernel_alone_graph_ms)",
                ptxas={k: v for k, v in regs.items() if k.startswith("osc_frames_bwd")})
            result["osc_frames_overlap_add"] = dict(
                max_abs_err=oa_err, bit_equal=True, ms=oa_ms, graph_ms=oa_graph,
                plain_ms=oa_plain_ms, bound_ms=ob_ms, bound_by=ob_by,
                library_ms=oa_library_ms, library="torch.index_add on zeros, once for "
                "d amps_pad and once for d loud_pad (atomic sums: not bit-equal)",
                ptxas=regs.get("osc_frames_overlap_add_kernel"))
        del phase, amps, loud, g, da_win, dl_win
        torch.cuda.empty_cache()
    log("[frames] library_ms: null for K1 and K2 -- no single PyTorch call computes a "
        "harmonic sine-bank render or its gradient; the nearest is the plain version timed "
        "above")
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

    conf = Config(batch_size=2, reverb_grad_matmul_dtype="float32")
    conf_linear = conf.replace(mss_alpha=0.0)
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
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts
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
    reset_launch_counts()  # the main path from here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        state = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_variant = launch_counts(), dict(osc_frames.VARIANT_LAUNCHES)
    fwd, bwd, s1 = counts["osc_frames_fwd"], counts["osc_frames_bwd"], counts["ct_conv"]
    fused, overlap = counts["ct_conv_dsignal"], counts["osc_frames_overlap_add"]
    rot = {k: osc_frames.variant_name(k, "rot") for k in ("osc_frames_fwd", "osc_frames_bwd")}
    require(by_variant == {rot["osc_frames_fwd"]: fwd, rot["osc_frames_bwd"]: bwd},
            f"the default train path launched {by_variant}, not K1/K2 on the rotation fill")
    require(fused == s1, f"S1 launched {s1} times, {fused} through the fused d/dsignal entry")
    require(counts["stft_power_fwd"] == counts["stft_power_bwd"] == 0,
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
    require(overlap == bwd, f"K2's overlap-add launched {overlap} times, K2 {bwd}")
    require(s1 == TRAIN_STEPS, f"S1 (ct_conv) launched {s1} times in {TRAIN_STEPS} steps")
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
        f"forward kernel {fwd} launches, backward kernel {bwd} ({by_variant}), its "
        f"overlap-add {overlap}, S1 {s1} (fused d/dsignal {fused})")
    log(f"[train] steady state: median {ms:.3f} ms per train step over windows 2-{len(rows)} "
        f"({1e3 / ms:.2f} steps/s); checkpoint {os.path.basename(latest)} restores equal")
    return {"osc_frames_fwd": fwd, "osc_frames_bwd": bwd, "osc_frames_overlap_add": overlap,
            "ct_conv": s1, "ct_conv_dsignal": fused, "by_variant": by_variant}, ms


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
    """(forward, backward) bounds of the kernels as ``StftPower`` runs them,
    on the bf16 copy of xb, each (ms, "operations" | "bytes"): the
    forward's 4 B T n_fft bins flops (re and im products) at the bf16
    tensor-core peak, or its bytes (bf16 xb and matrices in, float32 |S|^2
    out); the backward twice the flops (the re/im recompute and the
    transposed products), reading bf16 xb and matrices and float32 dmag,
    writing float32 dxb."""
    bins = n_fft // 2 + 1
    flops = 4 * b * n_frames * n_fft * bins
    samples, mag_bytes, w_bytes = b * n_blocks * hop, 4 * b * n_frames * bins, 2 * 2 * n_fft * bins
    out = []
    for f, n_bytes in ((flops, 2 * samples + w_bytes + mag_bytes),
                       (2 * flops, (2 + 4) * samples + w_bytes + mag_bytes)):
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


def try_graph_ms(fn, iters: int, what: str):
    """``graph_ms`` of ``fn``, or None with a log line where ``fn`` will
    not capture in a CUDA graph (its call time stays the timing)."""
    try:
        return graph_ms(fn, iters)
    except Exception as exc:  # noqa: BLE001 -- what capture refuses varies by call
        log(f"[stft] {what} does not capture in a CUDA graph ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}); its call time stands alone")
        import torch

        torch.cuda.synchronize()
        return None


def phase_stft(device):
    """K3 / K4 against their plain versions at the training shape (all six
    MSS sizes) and a ragged one, timed beside their bounds, the plain
    versions and torch.stft: each a call from Python and, where it
    captures, replayed from a CUDA graph."""
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
        xq = xb.to(torch.bfloat16)  # StftPower's one cast; both kernels read it

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
        k3 = lambda: stft.stft_power_fwd(xq, n_fft, hop, n_frames)  # noqa: E731
        k3_cast = lambda: stft.stft_power_fwd(xb, n_fft, hop, n_frames)  # noqa: E731
        k4 = lambda: stft.stft_power_bwd(xq, dmag, n_fft, hop, n_frames)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_mag, leaf, lib_dmag, retain_graph=True)
        row = dict(
            n_fft=n_fft, hop=hop, frames=n_frames, **agree,
            fwd_ms=cuda_ms(k3, iters=20), bwd_ms=cuda_ms(k4, iters=10),
            fwd_graph_ms=graph_ms(k3, iters=20), bwd_graph_ms=graph_ms(k4, iters=10),
            cast_ms=cuda_ms(lambda: xb.to(torch.bfloat16), iters=20),
            fwd_cast_ms=cuda_ms(k3_cast, iters=20), fwd_cast_graph_ms=graph_ms(k3_cast, iters=20),
            plain_fwd_ms=cuda_ms(lambda: stft.stft_power_plain(xb, n_fft, hop, n_frames), iters=10),
            plain_bwd_ms=cuda_ms(
                lambda: stft.stft_power_bwd_plain(xb, dmag, n_fft, hop, n_frames), iters=10),
            library_fwd_ms=cuda_ms(library_fwd, iters=20),
            library_bwd_ms=cuda_ms(lib_bwd, iters=20),
            library_fwd_graph_ms=try_graph_ms(library_fwd, 20, f"torch.stft at {n_fft}"),
            library_bwd_graph_ms=try_graph_ms(
                lib_bwd, 20, f"torch.stft's autograd backward at {n_fft}"),
            fwd_bound_ms=fb_ms, fwd_bound_by=fb_by, bwd_bound_ms=bb_ms, bwd_bound_by=bb_by)
        log(f"[stft] n_fft={n_fft}: K3 {row['fwd_ms']:.5f} ms a call, {row['fwd_graph_ms']:.5f} "
            f"in a graph (bound {fb_ms:.5f}, {fb_by}; plain {row['plain_fwd_ms']:.5f}; "
            f"torch.stft+|X|^2 {row['library_fwd_ms']:.5f}, in a graph "
            f"{row['library_fwd_graph_ms']}), K4 {row['bwd_ms']:.5f} ms a call, "
            f"{row['bwd_graph_ms']:.5f} in a graph (bound {bb_ms:.5f}, {bb_by}; plain "
            f"{row['plain_bwd_ms']:.5f}; torch.stft autograd backward "
            f"{row['library_bwd_ms']:.5f}, in a graph {row['library_bwd_graph_ms']}); "
            f"the bf16 cast of xb {row['cast_ms']:.5f}; K3 with the cast, on float32 xb as "
            f"torch.stft takes it, {row['fwd_cast_ms']:.5f} ms a call, "
            f"{row['fwd_cast_graph_ms']:.5f} in a graph")
        rows.append(row)
        del x, xb, xq, dmag, leaf, lib_out, lib_mag, lib_dmag
        torch.cuda.empty_cache()
    keys = ("fwd_ms", "bwd_ms", "fwd_graph_ms", "bwd_graph_ms", "cast_ms", "fwd_cast_ms",
            "fwd_cast_graph_ms", "plain_fwd_ms",
            "plain_bwd_ms", "library_fwd_ms", "library_bwd_ms", "library_fwd_graph_ms",
            "library_bwd_graph_ms", "fwd_bound_ms", "bwd_bound_ms")
    total = {k: (None if any(r[k] is None for r in rows) else sum(r[k] for r in rows))
             for k in keys}
    log(f"[stft] six sizes summed (B={b}, L={length}): K3 {total['fwd_ms']:.5f} ms a call, "
        f"{total['fwd_graph_ms']:.5f} in a graph (bound {total['fwd_bound_ms']:.5f}, plain "
        f"{total['plain_fwd_ms']:.5f}, torch.stft {total['library_fwd_ms']:.5f}, in a graph "
        f"{total['library_fwd_graph_ms']}); K4 {total['bwd_ms']:.5f} ms a call, "
        f"{total['bwd_graph_ms']:.5f} in a graph (bound {total['bwd_bound_ms']:.5f}, plain "
        f"{total['plain_bwd_ms']:.5f}, torch.stft backward {total['library_bwd_ms']:.5f}, in a "
        f"graph {total['library_bwd_graph_ms']}); the casts {total['cast_ms']:.5f}; K3 with "
        f"the cast {total['fwd_cast_ms']:.5f} ms a call, {total['fwd_cast_graph_ms']:.5f} in a "
        f"graph")

    def bound_by(kind):  # the kind that binds most of the summed bound
        ops = sum(r[f"{kind}_bound_ms"] for r in rows if r[f"{kind}_bound_by"] == "operations")
        return "operations" if ops >= total[f"{kind}_bound_ms"] / 2 else "bytes"

    per_scale = [{k: r[k] for k in ("n_fft", "hop", "frames") + keys} for r in rows]
    return {
        "stft_power_fwd": dict(
            snr_db=min(r["fwd_snr"] for r in rows), max_abs_err=max(r["fwd_err"] for r in rows),
            ms=total["fwd_ms"], graph_ms=total["fwd_graph_ms"], plain_ms=total["plain_fwd_ms"],
            bound_ms=total["fwd_bound_ms"], bound_by=bound_by("fwd"),
            library_ms=total["library_fwd_ms"], library_graph_ms=total["library_fwd_graph_ms"],
            with_cast_ms=total["fwd_cast_ms"], with_cast_graph_ms=total["fwd_cast_graph_ms"],
            library="torch.stft(center=True, pad_mode='reflect', window=hann) then |X|^2, "
                    "six sizes summed", per_scale=per_scale),
        "stft_power_bwd": dict(
            snr_db=min(r["bwd_snr"] for r in rows), max_abs_err=max(r["bwd_err"] for r in rows),
            max_rel_err=max(r["bwd_rel"] for r in rows), min_cosine=min(r["cos"] for r in rows),
            ms=total["bwd_ms"], graph_ms=total["bwd_graph_ms"], plain_ms=total["plain_bwd_ms"],
            bound_ms=total["bwd_bound_ms"], bound_by=bound_by("bwd"),
            library_ms=total["library_bwd_ms"], library_graph_ms=total["library_bwd_graph_ms"],
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

    conf = Config(batch_size=2, pitch_decode="weighted", reverb_grad_matmul_dtype="float32")
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
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts
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
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            state = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts(), by_variant=dict(osc_frames.VARIANT_LAUNCHES))
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
            f"{launches['stft_power_bwd']} (expected {want_bwd}), its recompute "
            f"{launches['stft_power_bwd_recompute']}; K1 {launches['osc_frames_fwd']}, "
            f"K2 {launches['osc_frames_bwd']}, S1 {launches['ct_conv']} (expected "
            f"{2 * FT_CLI_STEPS})")
        require(launches["stft_power_fwd"] == want_fwd,
                f"K3 launched {launches['stft_power_fwd']} times, expected {want_fwd}")
        require(launches["stft_power_bwd"] == want_bwd,
                f"K4 launched {launches['stft_power_bwd']} times, expected {want_bwd}")
        require(launches["stft_power_bwd_recompute"] == launches["stft_power_bwd"],
                f"K4's recompute launched {launches['stft_power_bwd_recompute']} times, its "
                f"shifted product {launches['stft_power_bwd']}")
        # one bf16 reverb backward a decoder step and a finetune step
        require(launches["ct_conv"] == launches["ct_conv_dsignal"] == 2 * FT_CLI_STEPS,
                f"S1 launched {launches['ct_conv']} times ({launches['ct_conv_dsignal']} "
                f"through the fused d/dsignal), expected {2 * FT_CLI_STEPS}")
        rot = {k: osc_frames.variant_name(k, "rot") for k in ("osc_frames_fwd", "osc_frames_bwd")}
        require(launches["by_variant"] == {rot["osc_frames_fwd"]: launches["osc_frames_fwd"],
                                           rot["osc_frames_bwd"]: launches["osc_frames_bwd"]},
                f"the finetune path launched {launches['by_variant']}, not K1/K2 on rot")
        require(launches["osc_frames_overlap_add"] == launches["osc_frames_bwd"],
                f"K2's overlap-add launched {launches['osc_frames_overlap_add']} times, K2 "
                f"{launches['osc_frames_bwd']}")

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


# --------------------------------------------------------------- phase 11


def variant_bound_ms(kernel: str, b: int, t: int, hop: int, h: int):
    """(ms, "operations" | "bytes"): K8 variants their base kernel's bound,
    K7 the forward's, K5 over B*T rows its own, K6 the larger of its fill
    at the fp32 peak and its contractions at the bf16 peak (or its bytes),
    S2 its fill (or its bytes)."""
    (fwd_ms, fwd_by), (bwd_ms, bwd_by), _ = frame_bounds_ms(b, t, hop, h)
    if kernel.startswith("osc_frames_fwd") or kernel == "osc_cheb_fwd":
        return fwd_ms, fwd_by
    if kernel.startswith("osc_frames_bwd"):
        return bwd_ms, bwd_by
    if kernel == "osc_hop_slots":
        return kernel_bound_ms(b * t, hop, h)
    points, samples, rows = b * t * hop * h, b * t * hop, b * (t + 2)
    if kernel == "osc_banked_bwd":
        n_bytes = 4 * (2 * samples + rows * h + rows + 3 * hop + samples + rows * h + rows)
        times = {"operations": max(FILL_FLOP_PER_POINT * points / PEAK_FP32_FLOPS,
                                   K6_MMA_FLOP_PER_POINT * points / PEAK_BF16_FLOPS)}
    else:  # osc_fill_only: phase, amps in; dphase, the windows' copies, zeros out
        n_bytes = 4 * (samples + rows * h + samples + 3 * b * t * h + 3 * b * t)
        times = {"operations": FILL_FLOP_PER_POINT * points / PEAK_FP32_FLOPS}
    times["bytes"] = n_bytes / PEAK_BYTES_PER_S
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def check_variant_row(row, shape: str) -> None:
    """Phase 11's floors for one sweep row (see the module docstring)."""
    what = f"{row['label']} ({row['kernel']}) at {shape}"
    require(row["finite"], f"{what}: not finite")
    require(row["launches"] == row["expected_launches"],
            f"{what}: {row['launches']} launches, the sweep implies {row['expected_launches']}")
    bwd = isinstance(row["db_plain"], dict)
    plain = row["db_plain"] if bwd else {"out": row["db_plain"]}
    f64 = row["db_f64"] if bwd else {"out": row["db_f64"]}
    cos = row["cos_f64"] if bwd else {"out": row["cos_f64"]}
    f32_floor = GRAD_SNR_FLOOR_DB if bwd else KERNEL_SNR_FLOOR_DB
    for k, v in plain.items():
        floor = BF16_PLAIN_FLOOR_DB if row["bf16"] else f32_floor
        require(v > floor, f"{what}: {k} vs plain {v:.2f} dB <= {floor}")
    cadence = row["options"].get("resync", 32) if row["kernel"] == "osc_cheb_fwd" else 32
    if cadence == 32:  # K7's other cadences are recorded, not held
        for k, v in f64.items():
            if row["bf16"]:
                require(v > BF16_F64_FLOOR_DB and cos[k] > BF16_COS,
                        f"{what}: {k} vs float64 {v:.2f} dB, cosine {cos[k]:.8f}")
            else:
                require(v > f32_floor, f"{what}: {k} vs float64 {v:.2f} dB <= {f32_floor}")
    if bwd:
        require(row["bit_equal"], f"{what}: two backward runs differ")
    if row["kernel"] == "osc_banked_bwd":
        for k, v in row["db_k2"].items():
            require(v > BF16_F64_FLOOR_DB and row["cos_k2"][k] > BF16_COS,
                    f"{what}: {k} vs K2 {v:.2f} dB, cosine {row['cos_k2'][k]:.8f}")
    if row["kernel"] == "osc_fill_only":
        require(row["copies_equal"], f"{what}: the amplitude copies differ")


SASS_OPS = ("STS", "HMMA", "MOVM", "F2FP")


def sass_counts(lib, kernel: str):
    """{opcode: count} of SASS_OPS in ``kernel`` (a substring of one
    mangled name) in ``lib``'s SASS."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    sections = [sec for sec in out.split("Function : ")[1:] if kernel in sec.split("\n")[0]]
    require(len(sections) == 1, f"{kernel} not found once in the SASS of {lib}")
    return {op: len(re.findall(rf"\b{op}\b", sections[0])) for op in SASS_OPS}


def phase_variants(device):
    """The sweep's forward, backward, resync and ablation runs at the
    training and ragged shapes; returns the JSON entries of the kernels
    and the K8 variants, with this phase's launches."""
    import collections

    from ddsp_tpu_torch.ops.cuda import build
    from ddsp_tpu_torch.utils import osc_sweep

    # the 12-tile walk (H 129..192), which the training shape runs
    fill = sass_counts(build.build("osc_banked_bwd"), "osc_fill_only_kernelILi12E")
    k6 = sass_counts(build.build("osc_banked_bwd"), "osc_banked_bwd_kernelILi12E")
    log(f"[variants] SASS: osc_fill_only_kernel<12> {fill}; osc_banked_bwd_kernel<12> {k6}")
    require(fill["HMMA"] == 0 and k6["HMMA"] > 0 and fill["STS"] == 0,
            "S2 has tensor-core products or shared-memory stores, or K6 no products")
    require(fill["MOVM"] == k6["MOVM"] > 0 and fill["F2FP"] >= 2 * fill["MOVM"]
            and k6["F2FP"] >= fill["F2FP"],
            "S2 lost fill packs or transposes that K6 has")
    osc_sweep.reset_launches()  # the main path of this phase from here
    implied = collections.Counter()
    entries = {}
    t0 = time.perf_counter()
    for b, t, hop, h, h_start in FRAME_SHAPES:
        shape = f"B={b} T={t} hop={hop} H={h} h_start={h_start}"
        dims = (b, t, hop, h)
        rows = (osc_sweep.sweep_fwd(device, dims, h_start, VARIANT_ITERS)
                + osc_sweep.sweep_bwd(device, dims, h_start, VARIANT_ITERS)
                + osc_sweep.sweep_resync(device, dims, VARIANT_ITERS)
                + osc_sweep.sweep_ablate(device, dims, VARIANT_ITERS))
        for row in rows:
            implied[row["kernel"]] += row["expected_launches"]
            if row.get("reference"):
                continue
            check_variant_row(row, shape)
            bound_ms, bound_by = variant_bound_ms(row["kernel"], b, t, hop, h)
            db = row["db_plain"]
            db = min(db.values()) if isinstance(db, dict) else db
            f64 = row["db_f64"]
            f64 = min(f64.values()) if isinstance(f64, dict) else f64
            log(f"[variants] {shape} {row['label']:34s} {row['kernel']}: kernel "
                f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}); vs plain {db:.2f} dB, vs float64 {f64:.2f} dB"
                + (f", vs K2 {min(row['db_k2'].values()):.2f} dB" if "db_k2" in row else "")
                + (f"; K6 {row['full_ms']:.5f} ms" if "full_ms" in row else ""))
            key = row["kernel"] + ("" if row["kernel"] != "osc_cheb_fwd"
                                   or row["options"].get("resync", 32) == 32
                                   else f"[resync={row['options']['resync']}]")
            if (b, t, hop, h, h_start) == FRAME_SHAPES[0] and key not in entries:
                entries[key] = dict(
                    snr_db=db, snr_f64_db=f64, max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                    sweep_label=row["label"], options=row["options"])
    for name, n in sorted(implied.items()):
        got = osc_sweep.launches(name)
        require(got == n, f"{name} launched {got} times in phase 11, the sweep implies {n}")
    log(f"[variants] launches (all equal to the sweep's count): "
        + ", ".join(f"{k} {osc_sweep.launches(k)}" for k in sorted(implied))
        + f"; {time.perf_counter() - t0:.1f} s")
    for key, entry in entries.items():
        entry["launches"] = osc_sweep.launches(key.split("[resync=")[0])
    return entries


# --------------------------------------------------------------- phase 12


def phase_contract_step(device):
    """One full-width train step under the bf16 backward contraction, card
    vs CPU, gradients leaf by leaf; returns the bf16 K2's launches."""
    import copy

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.ops.cuda import osc_frames
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import trainer

    conf = Config(batch_size=2, reverb_grad_matmul_dtype="float32")
    batch = feature_batch(conf, conf.batch_size, SEED + 3)
    decoder = decoder_init(conf, seed=SEED)
    k1_rot = osc_frames.variant_name("osc_frames_fwd", "rot")
    k2_bf16 = osc_frames.variant_name("osc_frames_bwd", "rot", bf16=True)
    out = {}
    osc_frames.set_osc_bwd_contract_dtype("bfloat16")
    try:
        for dev in (device, torch.device("cpu")):
            params = copy.deepcopy(decoder).to(dev)
            on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            osc_frames.VARIANT_LAUNCHES.clear()
            grads = step_gradients(params, on_dev, conf, PRNGKey(SEED, dev))
            grad_launches = dict(osc_frames.VARIANT_LAUNCHES)
            state = trainer.TrainState(0, params, trainer.make_optimizer(conf).init(
                list(params.parameters())), PRNGKey(SEED, dev))
            state, metrics = trainer.make_train_step(conf)(state, on_dev)
            step_launches = osc_frames.VARIANT_LAUNCHES[k2_bf16] - grad_launches.get(k2_bf16, 0)
            out[dev.type] = (float(metrics["loss"]), float(metrics["grad_norm"]), grads,
                             grad_launches, step_launches)
            log(f"[contract-step] {dev}: loss {out[dev.type][0]:.6f}, grad_norm "
                f"{out[dev.type][1]:.6f}; frame kernel launches for the gradients "
                f"{grad_launches or 'none'}, bf16 K2 in the step {step_launches}")
    finally:
        osc_frames.set_osc_bwd_contract_dtype(None)
    (l_gpu, n_gpu, g_gpu, launched, in_step), (l_cpu, n_cpu, g_cpu, _, _) = out["cuda"], out["cpu"]
    require(launched == {k1_rot: 1, k2_bf16: 1} and in_step == 1,
            f"bf16 contraction step: frame kernels launched {launched}, {in_step} in the step")
    loss_tol = max(LOSS_ATOL, LOSS_RTOL * abs(l_cpu))
    require(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) < loss_tol,
            f"bf16 contraction step loss card {l_gpu} vs CPU {l_cpu} (tolerance {loss_tol:.3e})")
    norm_err = abs(n_gpu - n_cpu) / n_cpu
    require(np.isfinite(n_gpu) and norm_err <= GRAD_RTOL,
            f"bf16 contraction step grad_norm {n_gpu} vs {n_cpu}: {norm_err:.3e} > {GRAD_RTOL}")
    leaf, crit, rel = worst_leaf(g_gpu, g_cpu, FT_GRAD_RTOL)
    log(f"[contract-step] card vs CPU, {len(g_cpu)} leaves: loss {abs(l_gpu - l_cpu):.3e} apart "
        f"(< {loss_tol:.3e}), grad_norm {norm_err:.3e} relative; worst leaf {leaf}: |diff| "
        f"{rel:.3e} of its norm, criterion {crit:.4f} (< 1 passes)")
    require(crit < 1.0, f"bf16 contraction step gradient of {leaf}: criterion {crit:.4f} >= 1")
    return {k2_bf16: launched[k2_bf16] + in_step}


# --------------------------------------------------------------- phase 13


def dsignal_bound_ms(rows: int, n: int, batch: int, length: int):
    """The fused d/dsignal's least time: S1's operations on ``rows`` complex
    rows at the bf16 peak, or its bytes (g in, dsignal out, the spectrum
    in) at the HBM rate."""
    from ddsp_tpu_torch.ops.fft import _split_factors

    n1, n2 = _split_factors(n)
    t_ops = rows * 16 * n * (n1 + n2) / PEAK_BF16_FLOPS
    t_bytes = 4 * (2 * batch * length + 2 * n) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_dsignal(device):
    """The fused d/dsignal entry at the training shape (16 rows of 88,064
    samples, the 44,100-tap IR: two overlap-save chunks of 98,304) against
    its plain version; timed beside the plain version, today's unfused
    route through S1 and cuFFT's float32 correlation."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.ops import fft
    from ddsp_tpu_torch.ops.cuda import ct_conv

    conf = Config()
    b, length, taps = conf.batch_size, conf.example_length, conf.ir_length
    rng = np.random.default_rng(SEED + 13)
    g = torch.tensor(rng.standard_normal((b, length)), dtype=torch.float32, device=device)
    h = torch.tensor(0.1 * rng.standard_normal((1, taps)), dtype=torch.float32, device=device)
    plan = fft.overlap_save_plan(b, length, taps)
    kr, ki = (x.contiguous() for x in fft.shared_kernel_spectrum(h, taps, plan.n,
                                                                   torch.bfloat16))
    got = ct_conv.ct_conv_dsignal(g, h, taps, plan)
    again = ct_conv.ct_conv_dsignal(g, h, taps, plan)
    want = ct_conv.ct_conv_dsignal_plain(g, kr, ki, plan)
    torch.cuda.synchronize()
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    require(np.isfinite(got_np).all(), "fused d/dsignal not finite")
    require(torch.equal(got, again), "fused d/dsignal differs between two runs")
    snr = snr_db(want_np, got_np)
    err = float(np.abs(got_np - want_np).max())
    require(snr >= CT_PLAIN_FLOOR_DB, f"fused d/dsignal vs plain {snr:.2f} dB < {CT_PLAIN_FLOOR_DB}")
    n_full = fft.next_fft_size(length + taps - 1)
    h_conj = torch.fft.rfft(h, n=n_full).conj()
    fns = {
        "kernel": lambda: ct_conv.ct_conv_dsignal(g, h, taps, plan),
        "plain": lambda: ct_conv.ct_conv_dsignal_plain(g, kr, ki, plan),
        "unfused": lambda: fft.rfft_convolve_same(g.flip(-1), h, taps, torch.bfloat16).flip(-1),
        "library": lambda: torch.fft.irfft(torch.fft.rfft(g, n=n_full) * h_conj,
                                           n=n_full)[..., :length],
    }
    runs = {k: [] for k in fns}
    for name in ("plain", "kernel", "unfused", "library", "library", "unfused", "kernel", "plain"):
        runs[name].append(cuda_ms(fns[name], CT_ITERS))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    # its device time without the host's: the call's plain operations (the
    # kernel's permuted spectrum) launch faster from a graph
    graph = {k: graph_ms(fns[k], CT_ITERS) for k in ("kernel", "unfused", "library")}
    bound, bound_by = dsignal_bound_ms(plan.rows, plan.n, b, length)
    log(f"[ct-conv] fused d/dsignal at ({b}, {length}), {taps} taps ({plan.chunks} chunks of "
        f"{plan.n}, {plan.rows} complex rows): vs plain {snr:.2f} dB (max |err| {err:.3e}), "
        f"bit-equal on rerun; kernel {ms['kernel']:.5f} ms, the unfused route through S1 "
        f"{ms['unfused']:.5f} ms, plain {ms['plain']:.5f} ms, cuFFT float32 correlation "
        f"{ms['library']:.5f} ms, bound {bound:.5f} ms ({bound_by}); runs {runs}; in a "
        f"CUDA graph: kernel {graph['kernel']:.5f} ms, unfused {graph['unfused']:.5f} ms, "
        f"cuFFT {graph['library']:.5f} ms")
    return dict(snr_db=snr, max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                unfused_ms=ms["unfused"], library_ms=ms["library"], bound_ms=bound,
                bound_by=bound_by, runs_ms=runs, graph_ms=graph)


def phase_ct_conv(device):
    """S1 against its plain version and float64 at two shapes, timed; the
    fused d/dsignal entry against its plain version, timed; the reverb's
    float32 and bf16 routes fwd+bwd, interleaved; then a full-width train
    step on the default bf16 reverb route, card vs CPU.  Returns S1's and
    the fused entry's JSON numbers at the training shape."""
    import copy

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.ops.cuda import ct_conv
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import trainer
    from ddsp_tpu_torch.utils import ct_conv_ab, profile_reverb_grad

    result = {}
    for rows, n in CT_SHAPES:
        r = ct_conv_ab.race(device, rows, n, iters=CT_ITERS, seed=rows)
        shape = f"{rows} rows x {n} {tuple(r['n1n2'])}"
        require(r["finite"], f"S1 output not finite at {shape}")
        require(r["bit_equal"], f"S1 differs between two runs at {shape}")
        require(r["snr_plain_db"] >= CT_PLAIN_FLOOR_DB,
                f"S1 vs plain {r['snr_plain_db']:.2f} dB < {CT_PLAIN_FLOOR_DB} at {shape}")
        require(r["snr_f64_db"] >= CT_F64_FLOOR_DB,
                f"S1 vs float64 {r['snr_f64_db']:.2f} dB < {CT_F64_FLOOR_DB} at {shape}")
        log(f"[ct-conv] {shape}: vs plain {r['snr_plain_db']:.2f} dB (max |err| "
            f"{r['max_abs_err']:.3e}), vs float64 {r['snr_f64_db']:.2f} dB (plain "
            f"{r['plain_snr_f64_db']:.2f}, cuFFT {r['library_snr_f64_db']:.2f}), bit-equal on "
            f"rerun; kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, cuFFT ifft(fft(z) K) "
            f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); runs "
            f"{r['runs_ms']}")
        if (rows, n) == CT_SHAPES[0]:
            result["ct_conv"] = dict(
                snr_db=r["snr_plain_db"], snr_f64_db=r["snr_f64_db"],
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                runs_ms=r["runs_ms"])
        else:
            result["ct_conv"]["ragged"] = dict(
                rows=rows, n=n, snr_db=r["snr_plain_db"], snr_f64_db=r["snr_f64_db"],
                ms=r["ms"], library_ms=r["library_ms"])
        torch.cuda.empty_cache()
    result["ct_conv_dsignal"] = check_dsignal(device)
    torch.cuda.empty_cache()
    routes = profile_reverb_grad.run(device, Config().batch_size, iters=10, rounds=2)
    log(f"[ct-conv] reverb fwd+bwd at ({routes['batch']}, {routes['length']}), "
        f"{routes['ir_taps']} taps: float32 route {routes['float32_ms']:.5f} ms, bf16 route "
        f"{routes['bfloat16_ms']:.5f} ms, forward alone {routes['fwd_only_ms']:.5f} ms; S1 "
        f"launches a call {routes['s1_launches_per_call_bfloat16']} (bf16), "
        f"{routes['s1_launches_per_call_float32']} (float32); bf16 vs float32 gradients "
        f"{routes['bf16_vs_f32']}; runs {routes['runs_ms']}")
    require(routes["s1_launches_per_call_bfloat16"] == 1, "the bf16 route did not launch S1 once")
    result["ct_conv"]["reverb_routes_ms"] = {k: routes[f"{k}_ms"]
                                             for k in ("float32", "bfloat16", "fwd_only")}

    conf = Config(batch_size=2)
    require(conf.reverb_grad_matmul_dtype == "bfloat16", "the default reverb route is not bf16")
    batch = feature_batch(conf, conf.batch_size, SEED + 3)
    decoder = decoder_init(conf, seed=SEED)
    out = {}
    for dev in (device, torch.device("cpu")):
        params = copy.deepcopy(decoder).to(dev)
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ct_conv.LAUNCHES = ct_conv.DSIGNAL_LAUNCHES = 0
        grads = step_gradients(params, on_dev, conf, PRNGKey(SEED, dev))
        grad_launches = ct_conv.LAUNCHES
        require(ct_conv.DSIGNAL_LAUNCHES == grad_launches,
                "S1 launched outside the fused d/dsignal entry")
        state = trainer.TrainState(0, params, trainer.make_optimizer(conf).init(
            list(params.parameters())), PRNGKey(SEED, dev))
        state, metrics = trainer.make_train_step(conf)(state, on_dev)
        out[dev.type] = (float(metrics["loss"]), float(metrics["grad_norm"]), grads,
                         grad_launches, ct_conv.LAUNCHES - grad_launches)
        log(f"[ct-conv-step] {dev}: loss {out[dev.type][0]:.6f}, grad_norm "
            f"{out[dev.type][1]:.6f}; S1 launches for the gradients {grad_launches}, in the "
            f"step {out[dev.type][4]}")
    (l_gpu, n_gpu, g_gpu, launched, in_step), (l_cpu, n_cpu, g_cpu, _, _) = out["cuda"], out["cpu"]
    require(launched == 1 and in_step == 1,
            f"bf16 reverb step: S1 launched {launched} times for the gradients, {in_step} in the step")
    loss_tol = max(LOSS_ATOL, LOSS_RTOL * abs(l_cpu))
    require(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) < loss_tol,
            f"bf16 reverb step loss card {l_gpu} vs CPU {l_cpu} (tolerance {loss_tol:.3e})")
    norm_err = abs(n_gpu - n_cpu) / n_cpu
    require(np.isfinite(n_gpu) and norm_err <= GRAD_RTOL,
            f"bf16 reverb step grad_norm {n_gpu} vs {n_cpu}: {norm_err:.3e} > {GRAD_RTOL}")
    leaf, crit, rel = worst_leaf(g_gpu, g_cpu, FT_GRAD_RTOL)
    log(f"[ct-conv-step] card vs CPU, {len(g_cpu)} leaves: loss {abs(l_gpu - l_cpu):.3e} apart "
        f"(< {loss_tol:.3e}), grad_norm {norm_err:.3e} relative; worst leaf {leaf}: |diff| "
        f"{rel:.3e} of its norm, criterion {crit:.4f} (< 1 passes)")
    require(crit < 1.0, f"bf16 reverb step gradient of {leaf}: criterion {crit:.4f} >= 1")
    result["ct_conv"]["launches_step"] = launched + in_step
    result["ct_conv_dsignal"]["launches_step"] = launched + in_step
    return result


# --------------------------------------------------------------- phase 14


def ring_recorder(ring):
    """Make ``ring.read`` also keep what it returns: the samples a
    ThreadedSynthesizer hands out, without the zeros an underrun adds."""
    read, real = ring.read, []
    ring.read = lambda n: real.append(read(n)) or real[-1]
    return read, real


def live_plain(controls, context, conf, phase):
    """``oscillator_live``'s plain version on the same tensors: the same
    padding, Nyquist normalisation and phase, then K1's plain rot render."""
    import torch

    from ddsp_tpu_torch.ops.cuda import osc_frames
    from ddsp_tpu_torch.ops.oscillator import _fundamental_phase_cycles, nyquist_normalized_amps

    f0, c, a = (torch.cat([context["prev"][k], controls[k], context["next"][k]], 1)
                for k in ("f0", "c", "a"))
    amps = nyquist_normalized_amps(f0, c, conf.sample_rate)
    phase1 = _fundamental_phase_cycles(f0[..., 0], conf.hop_length, conf.sample_rate, phase)
    return osc_frames.render_from_phase_variant_plain(phase1, amps, a[..., 0], 0, "rot")


def phase_realtime(device):
    """The single-stream real-time path at full width, batch 1: the
    BlockSynthesizer (its warm-up, RT_BLOCKS hops and the flush: the main
    path, counted), the ThreadedSynthesizer at the hop's pace, the WAV
    loopback and ``oscillator_live``."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.models.synths import oscillator_live
    from ddsp_tpu_torch.ops.cuda import osc_frames
    from ddsp_tpu_torch.ops.cuda import oscillator as osc_cuda
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.runtime.jack_io import run_file_loopback
    from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer
    from ddsp_tpu_torch.runtime.threaded import ThreadedSynthesizer
    from ddsp_tpu_torch.utils.profile_realtime import call_stats, timed_synthesizers
    from ddsp_tpu_torch.utils.slot_parity import lone_stream, tone_blocks

    conf = Config()
    hop, sr = conf.hop_length, conf.sample_rate
    deadline_ms = 1e3 * hop / sr
    params, crepe = decoder_init(conf, seed=SEED), crepe_init(conf.crepe_capacity, seed=SEED + 1)
    blocks = tone_blocks(1, RT_BLOCKS, hop, sr, SEED + 14)[:, 0]
    rot = osc_cuda.variant_name("rot")

    osc_cuda.LAUNCHES = 0  # from here to the read below: the main path
    osc_cuda.VARIANT_LAUNCHES.clear()
    synth = BlockSynthesizer(params, crepe, conf, device=device)
    outs, times = [], []
    for b in blocks:
        t0 = time.perf_counter()
        outs.append(synth.process(b))
        times.append(1e3 * (time.perf_counter() - t0))
    outs.append(synth.flush())
    launches, by_fill = osc_cuda.LAUNCHES, dict(osc_cuda.VARIANT_LAUNCHES)
    out = np.stack(outs)
    log(f"[realtime] BlockSynthesizer, batch 1, {RT_BLOCKS} hops + flush at full width: K5 "
        f"launched {launches} times {by_fill} (1 warm-up + {RT_BLOCKS} + 1 flush expected)")
    require(by_fill == {rot: RT_BLOCKS + 2} and launches == RT_BLOCKS + 2,
            f"BlockSynthesizer launched K5 {by_fill}, not {RT_BLOCKS + 2} x {rot}")
    require(np.isfinite(out).all() and np.abs(out[2:]).max() > 1e-3,
            "BlockSynthesizer output not finite or silent")
    # noise seed 0: the real-time entry points' default; each K5 call of
    # this oracle run (the same steps) is kept and held against the plain
    # version on its operands, the real-time hop's N = 1
    calls, launch = [], osc_cuda.osc_hop_slots

    def recorded(*args, **kwargs):
        calls.append((args, kwargs, launch(*args, **kwargs)))
        return calls[-1][2]

    osc_cuda.osc_hop_slots = recorded
    try:
        lone, _ = lone_stream(params, crepe, conf, PRNGKey(0, device), blocks, device,
                              flush=True)
    finally:
        osc_cuda.osc_hop_slots = launch
    require(np.array_equal(out, lone), "BlockSynthesizer differs from the lone-stream steps: max "
            f"|diff| {np.abs(out - lone).max():.3e}")
    require(len(calls) == RT_BLOCKS + 1 and all(c[0][0].shape == (1, hop) for c in calls),
            f"the lone-stream run made {len(calls)} K5 calls, not {RT_BLOCKS + 1} at N = 1")
    k5 = torch.cat([c[2] for c in calls]).cpu().numpy()
    k5_plain = torch.cat([osc_cuda.render_hop_slots_plain(*a, **kw) for a, kw, _ in calls]
                         ).cpu().numpy()
    k5_snr, k5_err = snr_db(k5_plain, k5), float(np.abs(k5 - k5_plain).max())
    log(f"[realtime] K5 at N = 1, H = {conf.n_harmonics}, hop {hop}, {len(calls)} hops of the "
        f"lone-stream run vs its plain version on the same operands: SNR {k5_snr:.2f} dB, "
        f"max |err| {k5_err:.3e}")
    require(k5_snr > KERNEL_SNR_FLOOR_DB, f"K5 at N = 1 vs plain {k5_snr:.2f} dB <= "
            f"{KERNEL_SNR_FLOOR_DB}")
    median, p99 = (float(np.percentile(times, q)) for q in (50, 99))
    log(f"[realtime] ms per process call: median {median:.3f}, p99 {p99:.3f}, max "
        f"{max(times):.3f}; missed_deadlines {synth.missed_deadlines} of {RT_BLOCKS} against "
        f"{deadline_ms:.2f} ms; bit-equal to lone_stream + flush")
    result = {"launches": launches, "k5_snr_db": k5_snr, "median_ms": median, "p99_ms": p99,
              "missed_deadlines": synth.missed_deadlines, "deadline_ms": deadline_ms}

    # the threaded facade, hops pushed at the hop's pace, each call of its
    # worker timed
    with timed_synthesizers() as worker:
        threaded = ThreadedSynthesizer(params, crepe, conf, device=device)
    read, real = ring_recorder(threaded._out)
    try:
        t_start = time.perf_counter()
        for i, b in enumerate(blocks):
            time.sleep(max(0.0, t_start + i * hop / sr - time.perf_counter()))
            threaded.push(b)
            threaded.pull(hop)
        deadline = time.monotonic() + 60.0
        while threaded._synth.blocks < RT_BLOCKS and time.monotonic() < deadline:
            time.sleep(0.01)
        real.append(read(threaded._out.readable()))
    finally:
        threaded.close()
    stream, lat = np.concatenate(real), threaded.latency_hops * hop
    require(threaded._synth.blocks == RT_BLOCKS and not threaded._thread.is_alive(),
            f"ThreadedSynthesizer worker processed {threaded._synth.blocks} of {RT_BLOCKS} hops")
    require(stream.shape == (lat + RT_BLOCKS * hop,) and not stream[:lat].any()
            and np.array_equal(stream[lat:], out[:RT_BLOCKS].reshape(-1)),
            "ThreadedSynthesizer stream differs from the BlockSynthesizer run")
    worker = call_stats(worker.made[0].call_ms, deadline_ms)
    log(f"[realtime] ThreadedSynthesizer at the hop's pace: {RT_BLOCKS} hops, underruns "
        f"{threaded.underruns}, worker missed_deadlines {threaded._synth.missed_deadlines}; its "
        f"stream past the {threaded.latency_hops}-hop pre-fill bit-equal to the BlockSynthesizer;"
        f" the worker's ms a call: median {worker['median_ms']:.3f}, p90 {worker['p90_ms']:.3f}, "
        f"p99 {worker['p99_ms']:.3f}, max {worker['max_ms']:.3f}")
    result.update(underruns=threaded.underruns, worker=worker)

    # the WAV loopback over a 2 s synthetic file
    with tempfile.TemporaryDirectory() as tmp:
        in_path, out_path = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        n = 2 * sr // hop
        write_wav(in_path, tone_blocks(1, n, hop, sr, SEED + 15)[:, 0].reshape(-1), sr)
        with timed_synthesizers() as loop:
            stats = run_file_loopback(params, crepe, conf, in_path, out_path, device=device)
        got = read_wav(out_path)[0]
        check = BlockSynthesizer(params, crepe, conf, device=device)
        rendered = [check.process(b) for b in read_wav(in_path)[0][0][: n * hop].reshape(n, hop)]
        rendered = np.concatenate(rendered[1:] + [check.flush()])
        write_wav(os.path.join(tmp, "want.wav"), rendered / max(1.0, np.abs(rendered).max() / 0.9), sr)
        want = read_wav(os.path.join(tmp, "want.wav"))[0]
    require(stats["blocks"] == n and got.shape == (1, n * hop) and np.array_equal(got, want),
            f"run_file_loopback: {stats}, output {got.shape} differs from the BlockSynthesizer's")
    loop = call_stats(loop.made[0].call_ms, deadline_ms)
    log(f"[realtime] run_file_loopback, 2 s WAV: {stats['blocks']} blocks, missed_deadlines "
        f"{stats['missed_deadlines']}, real-time factor {stats['realtime_factor']:.3f}; output "
        f"equal to the BlockSynthesizer's; ms a call: median {loop['median_ms']:.3f}, p90 "
        f"{loop['p90_ms']:.3f}, p99 {loop['p99_ms']:.3f}, max {loop['max_ms']:.3f}")
    result.update(loopback=dict(stats, **loop))

    # oscillator_live at full width: batch 1, RT_LIVE_FRAMES frames with context
    rng = np.random.default_rng(SEED + 16)

    def controls(t):
        return {"f0": torch.tensor(rng.uniform(100.0, 1000.0, (1, t, 1)), dtype=torch.float32,
                                   device=device),
                "c": torch.tensor(rng.uniform(0.0, 1.0, (1, t, conf.n_harmonics)),
                                  dtype=torch.float32, device=device),
                "a": torch.tensor(rng.uniform(0.0, 1.0, (1, t, 1)), dtype=torch.float32,
                                  device=device)}

    ctl, context = controls(RT_LIVE_FRAMES), {"prev": controls(1), "next": controls(1)}
    phase = torch.tensor([0.3], device=device)
    k1_rot = osc_frames.variant_name("osc_frames_fwd", "rot")
    osc_frames.VARIANT_LAUNCHES.clear()  # oscillator_live's call, read just after
    with torch.no_grad():
        audio, final = oscillator_live(ctl, conf, phase, context)
        torch.cuda.synchronize()
        live_launches = dict(osc_frames.VARIANT_LAUNCHES)
        want = live_plain(ctl, context, conf, phase)
        live_snr = snr_db(want.cpu().numpy(), audio.cpu().numpy())
        live_ms = cuda_ms(lambda: oscillator_live(ctl, conf, phase, context), iters=50)
        plain_ms = cuda_ms(lambda: live_plain(ctl, context, conf, phase), iters=10, warmup=1)
    log(f"[realtime] oscillator_live, batch 1, {RT_LIVE_FRAMES} frames with context: "
        f"{live_launches}; vs its plain version on the card {live_snr:.2f} dB (> "
        f"{KERNEL_SNR_FLOOR_DB}); {live_ms:.5f} ms a call, plain {plain_ms:.5f} ms")
    require(live_launches == {k1_rot: 1}, f"oscillator_live launched {live_launches}, not one "
            f"{k1_rot}")
    require(audio.shape == (1, RT_LIVE_FRAMES * hop) and bool(torch.isfinite(final).all())
            and live_snr > KERNEL_SNR_FLOOR_DB, f"oscillator_live vs plain {live_snr:.2f} dB")
    result["live"] = {"launches": live_launches[k1_rot], "snr_db": live_snr, "ms": live_ms,
                      "plain_ms": plain_ms}

    # where a hop's time goes: the card's busy time and launches over a
    # profiled window of hops, last, so that no timed row above follows a
    # profiler window
    profiled = BlockSynthesizer(params, crepe, conf, device=device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for b in blocks[:RT_PROFILE_HOPS]:
            profiled.process(b)
        window_ms = 1e3 * (time.perf_counter() - t0) / RT_PROFILE_HOPS
    kernels = [k for e in prof.events() for k in e.kernels]
    busy_ms = 1e-3 * sum(k.duration for k in kernels) / RT_PROFILE_HOPS
    log(f"[realtime] profiled window, {RT_PROFILE_HOPS} hops: {window_ms:.3f} ms wall a hop, "
        f"card busy {busy_ms:.3f} ms a hop (idle {100 * (1 - busy_ms / window_ms):.1f} %), "
        f"{len(kernels) / RT_PROFILE_HOPS:.1f} kernel launches a hop"
        + ("" if kernels else "; the profiler saw no device kernels"))
    result.update(profiled_wall_ms=window_ms, busy_ms=busy_ms if kernels else None,
                  kernels_per_hop=len(kernels) / RT_PROFILE_HOPS)
    return result


# --------------------------------------------------------------- phase 15


def phase_precision(device):
    """compute_dtype='bfloat16': one full-width train step card vs CPU at
    phase 9's criterion; crepe_compute_dtype='bfloat16': CREPE on the
    card vs the CPU at full width, argmax bins equal."""
    import copy

    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.autoencoder import feature_pad
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.models.encoder import f0_encoder_apply
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import trainer

    conf = Config(batch_size=2, reverb_grad_matmul_dtype="float32", compute_dtype="bfloat16")
    batch = feature_batch(conf, conf.batch_size, SEED + 3)
    decoder = decoder_init(conf, seed=SEED)
    out = {}
    for dev in (device, torch.device("cpu")):
        params = copy.deepcopy(decoder).to(dev)
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads = step_gradients(params, on_dev, conf, PRNGKey(SEED, dev))
        state = trainer.TrainState(0, params, trainer.make_optimizer(conf).init(
            list(params.parameters())), PRNGKey(SEED, dev))
        state, metrics = trainer.make_train_step(conf)(state, on_dev)
        out[dev.type] = (float(metrics["loss"]), float(metrics["grad_norm"]), grads)
        log(f"[precision] bf16 controller step on {dev}: loss {out[dev.type][0]:.6f}, "
            f"grad_norm {out[dev.type][1]:.6f}")
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = out["cuda"], out["cpu"]
    # phase 9's bf16 criterion: a float32 sum that differs in its last bit
    # card vs CPU can round to the other bf16 neighbour, so the loss is held
    # to FT_LOSS_RTOL, not to phase 6's 16 float32 ulps
    loss_err, norm_err = abs(l_gpu - l_cpu) / abs(l_cpu), abs(n_gpu - n_cpu) / n_cpu
    require(np.isfinite(l_gpu) and loss_err <= FT_LOSS_RTOL,
            f"bf16 controller step loss card {l_gpu} vs CPU {l_cpu}: {loss_err:.3e} > {FT_LOSS_RTOL}")
    require(np.isfinite(n_gpu) and norm_err <= GRAD_RTOL,
            f"bf16 controller step grad_norm {n_gpu} vs {n_cpu}: {norm_err:.3e} > {GRAD_RTOL}")
    leaf, crit, rel = worst_leaf(g_gpu, g_cpu, FT_GRAD_RTOL)
    log(f"[precision] compute_dtype bf16 step, card vs CPU, {len(g_cpu)} leaves: loss "
        f"{loss_err:.3e} relative (<= {FT_LOSS_RTOL}), grad_norm {norm_err:.3e} relative; "
        f"worst leaf {leaf}: |diff| {rel:.3e} of its norm, criterion {crit:.4f} (< 1 passes)")
    require(crit < 1.0, f"bf16 controller step gradient of {leaf}: criterion {crit:.4f} >= 1")
    result = {"step_criterion": crit, "step_loss_rel": loss_err, "step_grad_norm_rel": norm_err}

    conf = Config(crepe_compute_dtype="bfloat16")
    crepe = crepe_init(conf.crepe_capacity, seed=SEED + 1)
    # random weights leave near-ties between pitch bins (ROADMAP.md, properties
    # of the comparison): take the first audio seed whose bins agree
    for audio_seed in FT_AUDIO_SEEDS:
        audio = feature_pad(torch.from_numpy(
            tone_batch(2, conf.example_length, conf.sample_rate, audio_seed)), conf)
        probs = {}
        for dev in (device, torch.device("cpu")):
            with torch.no_grad():
                probs[dev.type] = f0_encoder_apply(copy.deepcopy(crepe).to(dev), audio.to(dev),
                                                   conf)["probabilities"].cpu().double().numpy()
        bins = {k: v.argmax(-1) for k, v in probs.items()}
        differ = int((bins["cuda"] != bins["cpu"]).sum())
        logit = {k: np.log(v / (1.0 - v)) for k, v in probs.items()}
        logit_snr = snr_db(logit["cpu"], logit["cuda"])
        log(f"[precision] crepe_compute_dtype bf16, {probs['cpu'].shape[:2]} frames, audio seed "
            f"{audio_seed}: {differ} argmax bins differ card vs CPU; max |dp| "
            f"{np.abs(probs['cuda'] - probs['cpu']).max():.3e}, logits {logit_snr:.2f} dB")
        if differ == 0:
            break
    require(differ == 0, f"no audio seed of {FT_AUDIO_SEEDS} gives equal bf16 CREPE bins")
    result.update(crepe_logit_snr_db=logit_snr, crepe_audio_seed=audio_seed)
    return result



# --------------------------------------------------------------- phase 16


def write_glide_wav(path: str, seconds: float, rate: int, seed: int) -> None:
    """A seeded gliding tone (110 -> 440 Hz) plus noise, stereo, 16-bit:
    the common recorder format."""
    from ddsp_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    f = 110.0 * 4.0 ** (np.arange(n) / n)
    tone = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / rate)
    audio = tone[None] * np.array([[0.9], [0.6]]) + 0.02 * rng.standard_normal((2, n))
    write_wav(path, audio.astype(np.float32), rate)


class written_audio:
    """Records the float audio that ``reconstruct_file`` hands to
    ``write_wav``, in the order written: what its WAV holds before the
    16-bit rounding."""

    def __enter__(self) -> list:
        from ddsp_tpu_torch import reconstruct

        self.write, written = reconstruct.write_wav, []

        def recorded(path, audio, rate):
            written.append(np.array(audio))
            self.write(path, audio, rate)

        reconstruct.write_wav = recorded
        return written

    def __exit__(self, *exc) -> None:
        from ddsp_tpu_torch import reconstruct

        reconstruct.write_wav = self.write


def device_kernel_ns(prof) -> list:
    """The duration (ns) of every kernel the profiler saw on the card (its
    device events but copies, fills and the ``record_function`` ranges),
    read from its raw events: building the event tree of ~70k launches
    takes longer than the call it profiled."""
    import torch

    return [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
            and not e.name().startswith(("Memcpy", "Memset"))]


def phase_reconstruct(device):
    """Offline reconstruction at full width: the CLI on a 60 s, 48 kHz
    stereo WAV (Lightning .ckpt in, CREPE .pth, --export_torch); in-process
    the one K1 launch of ``reconstruct_file`` (the main path, counted) and
    its float output against the CLI's WAV, K1 on the file's operands vs
    its plain version and timed, one profiled call, and ``reconstruct_file``
    on the card vs on the CPU's plain path over the file's first 4 s."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.models.autoencoder import autoencoder_init, encode
    from ddsp_tpu_torch.models.convert import load_lightning_decoder
    from ddsp_tpu_torch.models.crepe import save_torch_checkpoint
    from ddsp_tpu_torch.models.lightning_export import save_torch_decoder
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.reconstruct import prepare_audio, reconstruct_file

    conf = Config()
    params = autoencoder_init(PRNGKey(FT_PARAM_SEED), conf)  # phase 9's weights
    decoder, crepe = params["decoder"], params["crepe"]
    with torch.no_grad():
        decoder.reverb.wet.fill_(RECON_REVERB_WET)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = {k: os.path.join(tmp, k) for k in (
            "in.wav", "out.wav", "dec.ckpt", "crepe.pth", "export.ckpt", "again.wav",
            "head.wav")}
        write_glide_wav(path["in.wav"], RECON_SECONDS, RECON_RATE, SEED + 16)
        save_torch_decoder(decoder, conf, path["dec.ckpt"])
        save_torch_checkpoint(crepe, path["crepe.pth"])
        padded = prepare_audio(path["in.wav"], conf).shape[1]

        # the user's entry point: the CLI, in a process of its own
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ddsp_tpu_torch.reconstruct", path["in.wav"],
             path["out.wav"], f"--lightning_ckpt={path['dec.ckpt']}",
             f"--crepe_checkpoint={path['crepe.pth']}", f"--export_torch={path['export.ckpt']}"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        stamps = {"cli": cli_s}
        require(proc.returncode == 0, f"reconstruct CLI exit {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        stats = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("{")))
        out, sr = read_wav(path["out.wav"])
        log(f"[reconstruct] CLI on a {RECON_SECONDS} s {RECON_RATE} Hz stereo WAV: {stats}; "
            f"{cli_s:.1f} s for the whole process; output {out.shape} at {sr} Hz")
        require(stats["device"].startswith("cuda") and sr == conf.sample_rate
                and out.shape == (1, padded), f"reconstruct CLI wrote {out.shape} at {sr} Hz "
                f"on {stats['device']}, not (1, {padded}) at {conf.sample_rate}")
        require(np.isfinite(out).all() and np.abs(out).max() > 1e-3,
                "reconstruct CLI output not finite or silent")
        exported = load_lightning_decoder(path["export.ckpt"], conf).state_dict()
        require(all(torch.equal(exported[k], v) for k, v in decoder.state_dict().items()),
                "the exported decoder does not read back bit-equal")
        result["cli"] = dict(stats, process_s=cli_s)

        # the main path in this process: counted from 0, one K1 launch
        calls, launch = [], osc_frames.osc_frames_fwd

        def recorded(*args, **kwargs):
            calls.append((args, kwargs, launch(*args, **kwargs)))
            return calls[-1][2]

        osc_frames.osc_frames_fwd = recorded
        try:
            with written_audio() as written:
                reset_launch_counts()
                first = reconstruct_file(path["in.wav"], path["again.wav"], conf,
                                         crepe_checkpoint=path["crepe.pth"], decoder=decoder,
                                         device=device)
                counts, by_variant = launch_counts(), dict(osc_frames.VARIANT_LAUNCHES)
        finally:
            osc_frames.osc_frames_fwd = launch
        k1_rot = osc_frames.variant_name("osc_frames_fwd", "rot")
        launched = {k: v for k, v in counts.items() if v}
        log(f"[reconstruct] reconstruct_file on the card: hand kernels launched {launched} "
            f"{by_variant}; wall {first['wall_s']:.3f} s (the first call in this process)")
        require(launched == {"osc_frames_fwd": 1} and by_variant == {k1_rot: 1},
                f"reconstruct_file launched {launched} {by_variant}, not one {k1_rot}")
        # the float audio, not its WAV: no sample clipped, and the CLI's WAV
        # within a 16-bit step of it
        audio_out, peak = written[0], float(np.abs(written[0]).max())
        cli_err = float(np.abs(out - audio_out).max())
        log(f"[reconstruct] reconstruct_file's float output: rms {first['rms_out']:.5f} (input "
            f"{first['rms_in']:.5f}), peak {peak:.5f}; the CLI's WAV within {cli_err:.3e} of it "
            f"(<= {WAV_STEP:.3e}, a 16-bit step)")
        require(peak < 1.0, f"reconstruct_file's output peaks at {peak:.3f}: the WAV clips")
        require(cli_err <= WAV_STEP, f"the CLI's WAV is {cli_err:.3e} from reconstruct_file's "
                "float output")
        require(np.array_equal(read_wav(path["again.wav"])[0], out),
                "reconstruct_file's WAV differs from the CLI's")

        stamps["counted call"] = time.perf_counter() - t0 - sum(stamps.values())

        # K1 on the file's own operands, vs its plain version in frame chunks
        (phase, amps_pad, loud_pad, h_start), kw, k1_out = calls[0][0][:4], calls[0][1], calls[0][2]
        b, t, hop = phase.shape
        h = amps_pad.shape[-1]

        def plain():
            return torch.cat([osc_frames.render_from_phase_variant_plain(
                phase[:, a:a + RECON_PLAIN_FRAMES].contiguous(),
                amps_pad[:, a:a + RECON_PLAIN_FRAMES + 2].contiguous(),
                loud_pad[:, a:a + RECON_PLAIN_FRAMES + 2].contiguous(), h_start, **kw)
                for a in range(0, t, RECON_PLAIN_FRAMES)], dim=1)

        with torch.no_grad():
            want = plain().cpu().numpy()
            got = k1_out.cpu().numpy()
            snr, err = snr_db(want, got), float(np.abs(got - want).max())
            ms = cuda_ms(lambda: launch(phase, amps_pad, loud_pad, h_start, **kw), iters=50)
            in_graph = graph_ms(lambda: launch(phase, amps_pad, loud_pad, h_start, **kw),
                                iters=50)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
        (bound_ms, bound_by), floor_ms = (frame_bounds_ms(b, t, hop, h)[0],
                                          K1_ROT_FLOOR_MS * b * t * hop
                                          / K1_ROT_FLOOR_SAMPLES)
        log(f"[reconstruct] K1 at the file's shape (B={b}, T={t}, hop {hop}, H={h}, "
            f"{kw.get('fill')}): vs plain {snr:.2f} dB (> {KERNEL_SNR_FLOOR_DB}), max |err| "
            f"{err:.3e}; {ms:.5f} ms a call, {in_graph:.5f} ms in a CUDA graph, plain "
            f"{plain_ms:.5f} ms in chunks of {RECON_PLAIN_FRAMES} frames; bound {bound_ms:.5f} "
            f"ms ({bound_by}), rot issue-slot floor ~{floor_ms:.4f} ms (the training shape's, "
            "scaled)")
        require(snr > KERNEL_SNR_FLOOR_DB, f"K1 at the file's shape vs plain {snr:.2f} dB")
        result["k1"] = dict(shape=[b, t, hop, h], snr_db=snr, max_abs_err=err, ms=ms,
                            graph_ms=in_graph, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        del calls, k1_out
        stamps["K1 vs plain, timed"] = time.perf_counter() - t0 - sum(stamps.values())

        # warm wall time and the real-time factor, then one profiled call
        warm = reconstruct_file(path["in.wav"], path["again.wav"], conf,
                                crepe_checkpoint=path["crepe.pth"], decoder=decoder,
                                device=device)
        # the card's activity alone: ~70k launches' host events would take
        # the profiler longer to gather than the call takes
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled = reconstruct_file(path["in.wav"], path["again.wav"], conf,
                                        crepe_checkpoint=path["crepe.pth"], decoder=decoder,
                                        device=device)
        kernels = device_kernel_ns(prof)
        busy_ms = 1e-6 * sum(kernels)
        rtf = warm["seconds"] / warm["wall_s"]
        log(f"[reconstruct] reconstruct_file warm: {warm['wall_s']:.3f} s wall for "
            f"{warm['seconds']:.3f} s of audio, {rtf:.1f}x real time; profiled call: "
            f"{profiled['wall_s']:.3f} s wall, card busy {busy_ms:.3f} ms, {len(kernels)} "
            f"kernel launches" + ("" if kernels else "; the profiler saw no device kernels"))
        stamps["warm + profiled calls"] = time.perf_counter() - t0 - sum(stamps.values())
        result.update(first_wall_s=first["wall_s"], wall_s=warm["wall_s"], realtime_factor=rtf,
                      profiled_wall_s=profiled["wall_s"],
                      busy_ms=busy_ms if kernels else None, kernel_launches=len(kernels))

        # the card vs the CPU's plain path on the file's first
        # RECON_CPU_SECONDS: the features through encode, the float audio
        # through the entry point
        wav, rate = read_wav(path["in.wav"])
        write_wav(path["head.wav"], wav[:, :RECON_CPU_SECONDS * rate], rate)
        audio = torch.from_numpy(prepare_audio(path["head.wav"], conf))
        feats, rendered = {}, {}
        for dev in (device, torch.device("cpu")):
            on = params.to(dev)
            with torch.no_grad():
                f = encode(on, audio.to(dev), conf)
            feats[dev.type] = {k: v.cpu().double().numpy() for k, v in f.items()}
            with written_audio() as written:
                reconstruct_file(path["head.wav"], path["again.wav"], conf,
                                 crepe_checkpoint=path["crepe.pth"], decoder=decoder, device=dev)
            rendered[dev.type] = written[0]
        params.to("cpu")
        bins = {k: v["probabilities"].argmax(-1) for k, v in feats.items()}
        differ = int((bins["cuda"] != bins["cpu"]).sum())
        loud_err = float(np.abs(feats["cuda"]["loudness"] - feats["cpu"]["loudness"]).max())
        f0_rel = float(np.abs(feats["cuda"]["f0"] / feats["cpu"]["f0"] - 1).max())
        audio_db = snr_db(rendered["cpu"], rendered["cuda"])
        log(f"[reconstruct] card vs CPU on the first {RECON_CPU_SECONDS} s "
            f"({bins['cpu'].size} frames): {differ} f0 bins differ, loudness max |diff| "
            f"{loud_err:.3e} (<= {RECON_LOUD_ATOL}), f0 max relative diff {f0_rel:.3e}, audio "
            f"{audio_db:.2f} dB (> {RECON_AUDIO_FLOOR_DB})")
        require(differ == 0, f"{differ} f0 bins differ card vs CPU")
        require(loud_err <= RECON_LOUD_ATOL, f"loudness card vs CPU {loud_err:.3e}")
        require(audio_db > RECON_AUDIO_FLOOR_DB, f"audio card vs CPU {audio_db:.2f} dB <= "
                f"{RECON_AUDIO_FLOOR_DB}")
        stamps["card vs CPU"] = time.perf_counter() - t0 - sum(stamps.values())
        log("[reconstruct] seconds by step: " + ", ".join(f"{k} {v:.1f}" for k, v in stamps.items()))
        result.update(launches=counts["osc_frames_fwd"], cpu_bins_differ=differ,
                      cpu_loudness_err=loud_err, cpu_f0_rel=f0_rel, cpu_audio_db=audio_db)
    return result



# --------------------------------------------------------------- phase 17
# The parallel layer (ddsp_tpu_torch.parallel): one spawn of PAR_WORLD gloo
# ranks sharing cuda:0 runs every case (each on ranks 0..n-1 of it), then
# one nccl world of a single rank.  The features are phase 16's 60 s file's
# (T = 5,168 frames, which divides by 4 and 8), the decoder its seeded one.
PAR_WORLD = 8
PAR_TIME_RANKS = 4
# 4 shards of 86 frames = 44,032 samples, under the 44,100-sample IR: each
# shard's reverb halo spans two left shards
PAR_HALO_FRAMES = 344
PAR_TP_BATCH, PAR_TP_FRAMES, PAR_TP_RANKS = 16, 172, (4, 8)
PAR_DP_BATCH, PAR_DP_STEPS, PAR_DP_RANKS = 16, 3, (2, 4)
# hard limits: one spawn, start-up included; a collective's wait for a peer
PAR_SPAWN_S, PAR_GROUP_S = 420, 120
# the sharded renders against the unsharded card render: the JAX suite's
# floors (time 70 dB; TP 70 on 'pallas', the card's rotation fill)
PAR_FLOOR_DB = 70.0


def probe_gloo_cuda(dev) -> dict:
    """{collective: 'ok' or its error} for a CUDA tensor on this gloo
    group; every rank makes the same calls (send and recv are not tried:
    the port does not use them)."""
    import torch
    import torch.distributed as dist

    n, x = dist.get_world_size(), torch.ones(4, device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(n * 4, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(n * 4, device=dev)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return out


def parallel_rank(rank, dev, job):
    """One rank of phase 17: each case this rank is in, with its wall ms
    (synchronised), K1's calls (h_start, fill, the first sample's phase)
    and every hand kernel's launches, counted from 0 at the case's start."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.convert import decoder_from_state_dict
    from ddsp_tpu_torch.ops.cuda import launch_counts, osc_frames, reset_launch_counts
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel import mesh as pmesh, render, tp, train
    from ddsp_tpu_torch.training import trainer

    conf, out, k1 = Config(), {}, []
    if job["probe"]:
        out["gloo_cuda"] = probe_gloo_cuda(dev)
    launch, opt_step = osc_frames.osc_frames_fwd, trainer.AdamPlateau.step

    def recorded(phase, amps_pad, loud_pad, h_start=0, fill="exact", *args, **kwargs):
        k1.append(dict(h_start=int(h_start), fill=fill, shape=list(amps_pad.shape),
                       phase0=float(phase[0, 0, 0])))
        return launch(phase, amps_pad, loud_pad, h_start, fill, *args, **kwargs)

    def case(name, mesh, fn, gather=None):
        """fn() on the mesh's ranks; ``gather`` assembles rank 0's copy."""
        if mesh.coords is None:
            return
        k1.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        local = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        counts = {k: v for k, v in launch_counts().items() if v}
        full = local if gather is None else gather(local)
        out[name] = dict(wall_ms=wall, k1=list(k1), counts=counts,
                         checksum=float(full.double().sum()),
                         audio=full.cpu().numpy() if rank == 0 else None)
        torch.cuda.empty_cache()

    osc_frames.osc_frames_fwd = recorded
    try:
        decoder = decoder_from_state_dict(job["decoder"], conf)
        key, feats = PRNGKey(conf.seed), job["features"]
        for name, frames in (("long", None), ("halo", PAR_HALO_FRAMES)):
            if job["nccl"] and name == "halo":
                continue
            n = 1 if job["nccl"] else PAR_TIME_RANKS
            mesh = pmesh.make_mesh(n_time=n, ranks=range(n))
            batch = {k: v[:, :frames] for k, v in feats.items()}
            case(name, mesh, lambda m=mesh, b=batch: render.render_long_audio(
                decoder, b, conf, m, key, device=dev), lambda x, m=mesh: pmesh.gather_time(x, m))
        if not job["nccl"]:
            for n in PAR_TP_RANKS:
                mesh = tp.make_dp_tp_mesh(n_data=1, n_model=n, ranks=range(n))
                case(f"tp{n}", mesh, lambda m=mesh: tp.render_controls_tp(
                    decoder.reverb, job["tp_controls"], conf, m, key, device=dev))
            mesh = tp.make_time_tp_mesh(2, 2, ranks=range(4))
            case("time_tp", mesh, lambda: tp.render_controls_time_tp(
                decoder.reverb, job["long_controls"], conf, mesh, key, device=dev),
                lambda x: pmesh.gather_time(x, mesh))
        for n in ((1,) if job["nccl"] else PAR_DP_RANKS):
            mesh = pmesh.make_mesh(n_data=n, ranks=range(n))
            if mesh.coords is None:
                continue
            grads = []

            def recording(self, params, g, state, value):
                grads.append([t.detach().double().cpu() for t in g])
                return opt_step(self, params, g, state, value)

            state = train.shard_state(trainer.init_state(PRNGKey(SEED), conf, device=dev), mesh)
            step = train.make_parallel_train_step(conf, mesh, device=dev)
            batch = train.shard_batch(job["dp_batch"], mesh, device=dev)
            trainer.AdamPlateau.step = recording
            try:
                steps = []
                for _ in range(1 if job["nccl"] else PAR_DP_STEPS):
                    before = None if rank else dict(
                        params={k: v.detach().cpu().clone()
                                for k, v in state.params.state_dict().items()},
                        rng=state.rng.cpu().clone())
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                    steps.append(dict(wall_ms=1e3 * (time.perf_counter() - t0),
                                      metrics={k: float(v) for k, v in m.items()},
                                      counts={k: v for k, v in launch_counts().items() if v},
                                      before=before))
            finally:
                trainer.AdamPlateau.step = opt_step
            out[f"dp{n}"] = dict(steps=steps, grads=grads if rank == 0 else None,
                                 checksum=train.state_checksum(state).cpu().numpy())
            del state, step, batch
            torch.cuda.empty_cache()
    finally:
        osc_frames.osc_frames_fwd = launch
    return out


def single_step_grads(conf, batch_np, device, steps: int, starts=None):
    """Single-card train steps on the whole batch: ``steps`` steps from
    ``init_state(PRNGKey(SEED))``, or one step from each of ``starts``
    ({'params': a decoder state dict, 'rng': the key}); [(metrics, the
    gradients Adam took, wall ms)] per step, and the leaves' names."""
    import torch

    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training import trainer

    opt_step, grads = trainer.AdamPlateau.step, []

    def recording(self, params, g, state, value):
        grads.append([t.detach().double().cpu() for t in g])
        return opt_step(self, params, g, state, value)

    state = trainer.init_state(PRNGKey(SEED), conf, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    step, out = trainer.make_train_step(conf), []
    trainer.AdamPlateau.step = recording
    try:
        for i in range(steps if starts is None else len(starts)):
            if starts is not None:
                state.params.load_state_dict(starts[i]["params"])
                state = state._replace(rng=starts[i]["rng"].to(device))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            out.append(({k: float(v) for k, v in m.items()}, grads[-1],
                        1e3 * (time.perf_counter() - t0)))
    finally:
        trainer.AdamPlateau.step = opt_step
    names = [n for n, _ in state.params.named_parameters()]
    return out, names


def dp_distances(got_steps, got_grads, want, names):
    """[(loss relative, grad_norm relative, worst leaf, its |diff| over its
    norm, its criterion)] of each DP step against a single-card step."""
    out = []
    for s, g, (m_want, g_want, _) in zip(got_steps, got_grads, want):
        leaf, crit, rel = worst_leaf(dict(zip(names, g)), dict(zip(names, g_want)), FT_GRAD_RTOL)
        out.append((abs(s["metrics"]["loss"] - m_want["loss"]) / abs(m_want["loss"]),
                    abs(s["metrics"]["grad_norm"] - m_want["grad_norm"]) / m_want["grad_norm"],
                    leaf, rel, crit))
    return out


def check_dp(tag, dp, conf, batch_np, device, free, names):
    """Each DP step against the single-card step from the same state (the
    DP rank 0's parameters and key before it): phase 9's bf16 criterion on
    the gradients, grad_norm within GRAD_RTOL, loss within FT_LOSS_RTOL.
    The free-running single-card steps (``free``) are compared too, for
    information: Adam turns float noise in near-zero gradients into +-lr
    steps, so the two runs part from the second step on."""
    same, _ = single_step_grads(conf, batch_np, device, 0, [s["before"] for s in dp["steps"]])
    rows = []
    for i, ((loss_rel, norm_rel, leaf, rel, crit),
            (f_loss, f_norm, f_leaf, _, f_crit)) in enumerate(zip(
            dp_distances(dp["steps"], dp["grads"], same, names),
            dp_distances(dp["steps"], dp["grads"], free, names))):
        log(f"[parallel] {tag} step {i + 1}, against the single card from the same state: "
            f"loss {loss_rel:.3e} relative, grad_norm {norm_rel:.3e}; worst leaf {leaf}: "
            f"{rel:.3e} of its norm, criterion {crit:.4f} (< 1 passes); against the "
            f"free-running single card (not judged): loss {f_loss:.3e}, grad_norm "
            f"{f_norm:.3e}, worst leaf {f_leaf} criterion {f_crit:.4f}")
        require(loss_rel <= FT_LOSS_RTOL, f"{tag} step {i + 1} loss {loss_rel:.3e} relative")
        require(norm_rel <= GRAD_RTOL, f"{tag} step {i + 1} grad_norm {norm_rel:.3e} relative")
        require(crit < 1.0, f"{tag} step {i + 1} gradient of {leaf}: criterion {crit:.4f}")
        rows.append(dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, leaf=leaf, criterion=crit,
                         free_loss_rel=f_loss, free_grad_norm_rel=f_norm, free_criterion=f_crit))
    return rows


def phase_parallel(device, smi: str):
    """The parallel layer on the card: gloo ranks sharing cuda:0 run the
    time-sharded long render, the harmonic-sharded renders, time x model
    and the data-parallel steps, held against the unsharded card runs; a
    nccl world of one rank runs the render and one DP step; K1 at the TP
    shard shape against its plain version."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.autoencoder import autoencoder_init, encode
    from ddsp_tpu_torch.models.controller import controller_apply, decoder_apply
    from ddsp_tpu_torch.models.synths import noise_apply, oscillator_apply, reverb_apply
    from ddsp_tpu_torch.ops.cuda import osc_frames
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel.launch import run_ranks
    from ddsp_tpu_torch.reconstruct import prepare_audio

    conf = Config()
    params = autoencoder_init(PRNGKey(FT_PARAM_SEED), conf)  # phase 16's decoder
    decoder = params["decoder"]
    with torch.no_grad():
        decoder.reverb.wet.fill_(RECON_REVERB_WET)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "in.wav")
        write_glide_wav(path, RECON_SECONDS, RECON_RATE, SEED + 16)
        audio = torch.from_numpy(prepare_audio(path, conf)).to(device)
    params.to(device)
    with torch.no_grad():
        f = encode(params, audio, conf)
        feats = {k: f[k].float() for k in ("f0", "normalized_cents", "loudness")}
        key = PRNGKey(conf.seed, device)
        long_controls, _ = controller_apply(decoder.controller, feats)
        tp_feats = {k: torch.from_numpy(v).to(device)
                    for k, v in feature_batch(conf, PAR_TP_BATCH, SEED + 17).items()}
        tp_controls, _ = controller_apply(decoder.controller, tp_feats)

        def unsharded(ctl):
            harm, _ = oscillator_apply(ctl, conf)
            return reverb_apply(decoder.reverb, harm + noise_apply(ctl, conf, key), conf)

        refs, ref_ms = {}, {}
        for name, fn in (("long", lambda: decoder_apply(decoder, feats, conf, key)),
                         ("halo", lambda: decoder_apply(
                             decoder, {k: v[:, :PAR_HALO_FRAMES] for k, v in feats.items()},
                             conf, key)),
                         ("tp", lambda: unsharded(tp_controls)),
                         ("time_tp", lambda: unsharded(long_controls))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refs[name] = fn().cpu().numpy()
            ref_ms[name] = 1e3 * (time.perf_counter() - t0)
    t = feats["f0"].shape[1]
    require(t % 8 == 0 and tp_feats["f0"].shape[1] == PAR_TP_FRAMES,
            f"the file's {t} frames do not divide by 8, or the TP batch is not "
            f"{PAR_TP_FRAMES} frames")
    dp_conf = Config(batch_size=PAR_DP_BATCH)
    dp_batch = feature_batch(dp_conf, PAR_DP_BATCH, SEED + 18)
    single, names = single_step_grads(dp_conf, dp_batch, device, PAR_DP_STEPS)
    job = dict(decoder={k: v.cpu() for k, v in decoder.state_dict().items()},
               features={k: v.cpu().numpy() for k, v in feats.items()},
               tp_controls={k: v.cpu().numpy() for k, v in tp_controls.items()},
               long_controls={k: v.cpu().numpy() for k, v in long_controls.items()},
               dp_batch=dp_batch, probe=True, nccl=False)
    params.to("cpu")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_WORLD, (job,), backend="gloo", device="cuda",
                      timeout=PAR_SPAWN_S, group_timeout=PAR_GROUP_S)
    spawn_s = time.perf_counter() - t0
    log(f"[parallel] {PAR_WORLD} gloo ranks on cuda:0: {spawn_s:.1f} s for the spawn, start-up "
        "included")
    log(f"[parallel] gloo with CUDA tensors (torch {torch.__version__}): "
        + ", ".join(f"{k} {v}" for k, v in ranks[0]["gloo_cuda"].items()))
    t0 = time.perf_counter()
    (nccl,) = run_ranks(parallel_rank, 1, (dict(job, probe=False, nccl=True),), backend="nccl",
                        device="cuda", timeout=PAR_SPAWN_S, group_timeout=PAR_GROUP_S)
    nccl_s = time.perf_counter() - t0
    log(f"[parallel] the nccl world of one rank: {nccl_s:.1f} s, start-up included")
    note = f"{smi}; the ranks share one card, so these are not scale-out figures"
    result = dict(spawn_s=spawn_s, nccl_s=nccl_s, gloo_cuda=ranks[0]["gloo_cuda"], cases={})
    k1_rot = osc_frames.variant_name("osc_frames_fwd", "rot")

    def check_render(tag, name, ref, n, world, expect_h):
        """Case ``name`` of ``world``'s ranks 0..n-1 against the unsharded
        card render ``ref``: its SNR, one K1 launch a rank on the rotation
        fill at that rank's h_start, every rank's copy the same."""
        got = world[0][name]["audio"]
        db = snr_db(refs[ref], got)
        walls = [round(r[name]["wall_ms"], 3) for r in world[:n]]
        starts = [[c["h_start"] for c in r[name]["k1"]] for r in world[:n]]
        log(f"[parallel] {tag} on {n} rank(s): vs the unsharded card render {db:.2f} dB "
            f"(> {PAR_FLOOR_DB}); K1 h_start by rank {starts}; wall ms by rank {walls}, "
            f"unsharded {ref_ms[ref]:.3f} ms; {note}")
        require(got.shape == refs[ref].shape and np.isfinite(got).all(),
                f"{tag}: {got.shape} not {refs[ref].shape}, or not finite")
        require(db > PAR_FLOOR_DB, f"{tag} vs the unsharded card render {db:.2f} dB")
        for r, rank in enumerate(world[:n]):
            c = rank[name]
            require(c["counts"].get("osc_frames_fwd") == 1 and len(c["k1"]) == 1
                    and c["k1"][0]["fill"] == "rot" and c["k1"][0]["h_start"] == expect_h(r),
                    f"{tag} rank {r}: K1 calls {c['k1']}, launches {c['counts']}")
            require(c["checksum"] == world[0][name]["checksum"],
                    f"{tag}: rank {r}'s copy differs from rank 0's")
        result["cases"][tag] = dict(snr_db=db, ranks=n, wall_ms=walls, unsharded_ms=ref_ms[ref],
                                    h_start=starts,
                                    phase0=[r[name]["k1"][0]["phase0"] for r in world[:n]])

    check_render("long", "long", "long", PAR_TIME_RANKS, ranks, lambda r: 0)
    carried = result["cases"]["long"]["phase0"]
    log(f"[parallel] the phase entering each time shard's K1 (cycles): {carried}")
    require(all(p != 0.0 for p in carried[1:]), "a time shard's K1 started from phase 0")
    check_render("halo", "halo", "halo", PAR_TIME_RANKS, ranks, lambda r: 0)
    for n in PAR_TP_RANKS:
        h_local = -(-conf.n_harmonics // n)
        check_render(f"tp{n}", f"tp{n}", "tp", n, ranks, lambda r, h=h_local: r * h)
    check_render("time_tp", "time_tp", "time_tp", 4, ranks,
                 lambda r: (r % 2) * (conf.n_harmonics // 2))
    check_render("nccl_long", "long", "long", 1, [nccl], lambda r: 0)

    launches = {"osc_frames_fwd": 0, "osc_frames_bwd": 0, "ct_conv_dsignal": 0}
    for n in PAR_DP_RANKS:
        dp = [r[f"dp{n}"] for r in ranks[:n]]
        for r, d in enumerate(dp):
            require(np.array_equal(d["checksum"], dp[0]["checksum"]),
                    f"dp{n}: rank {r}'s state differs from rank 0's after the steps")
            for i, s in enumerate(d["steps"]):
                c = s["counts"]
                require(c.get("osc_frames_bwd") == 1 and c.get("ct_conv_dsignal") == 1,
                        f"dp{n} rank {r} step {i + 1}: launches {c}")
                for k in launches:
                    launches[k] += c.get(k, 0)
        walls = [[round(s["wall_ms"], 3) for s in d["steps"]] for d in dp]
        log(f"[parallel] dp{n}: {PAR_DP_STEPS} steps at global batch {PAR_DP_BATCH}; replicas' "
            f"state checksums bit-equal; K2 and S1 once a step on every rank; wall ms a step "
            f"by rank {walls}, single card {[round(s[2], 3) for s in single]}; {note}")
        result["cases"][f"dp{n}"] = dict(
            steps=check_dp(f"dp{n}", dp[0], dp_conf, dp_batch, device, single, names),
            wall_ms=walls, single_ms=[s[2] for s in single])
    nd = nccl["dp1"]
    require(nd["steps"][0]["counts"].get("osc_frames_bwd") == 1
            and nd["steps"][0]["counts"].get("ct_conv_dsignal") == 1,
            f"nccl dp step launches {nd['steps'][0]['counts']}")
    result["cases"]["nccl_dp1"] = dict(
        steps=check_dp("nccl dp1", nd, dp_conf, dp_batch, device, single, names),
        wall_ms=[nd["steps"][0]["wall_ms"]])
    renders = ("long", "halo", "tp4", "tp8", "time_tp")
    k1_launches = sum(r[c]["counts"].get("osc_frames_fwd", 0)
                      for r in ranks + [nccl] for c in r if c in renders)
    for k in launches:
        launches[k] += nd["steps"][0]["counts"].get(k, 0)
    result["launches"] = dict(launches, osc_frames_fwd_renders=k1_launches)

    # K1 at the TP shard shape (B=16, T=172, hop 512, H=45, h_start 135):
    # the last quarter of a bank normalised over all its harmonics, as
    # render_controls_tp hands it to K1
    b, hop, h = PAR_TP_BATCH, conf.hop_length, conf.n_harmonics // 4
    h0 = conf.n_harmonics - h
    phase, amps, loud, _ = frame_operands(b, PAR_TP_FRAMES, hop, conf.n_harmonics, 0, device,
                                          seed=h0)
    amps = amps[..., h0:].contiguous()
    with torch.no_grad():
        got = osc_frames.osc_frames_fwd(phase, amps, loud, h0, fill="rot")
        want = osc_frames.render_from_phase_variant_plain(phase, amps, loud, h0, "rot")
        torch.cuda.synchronize()
        db = snr_db(want.cpu().numpy(), got.cpu().numpy())
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: osc_frames.osc_frames_fwd(phase, amps, loud, h0, fill="rot"), 50)
        plain_ms = cuda_ms(lambda: osc_frames.render_from_phase_variant_plain(
            phase, amps, loud, h0, "rot"), 5, warmup=1)
    bound_ms, bound_by = frame_bounds_ms(b, PAR_TP_FRAMES, hop, h)[0]
    log(f"[parallel] K1 at the TP shard shape (B={b}, T={PAR_TP_FRAMES}, hop {hop}, H={h}, "
        f"h_start {h0}, rot): vs plain {db:.2f} dB (> {KERNEL_SNR_FLOOR_DB}), max |err| "
        f"{err:.3e}; {ms:.5f} ms a call, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}); {smi}")
    require(db > KERNEL_SNR_FLOOR_DB, f"K1 at the TP shard shape vs plain {db:.2f} dB")
    result["k1_tp_shard"] = dict(shape=[b, PAR_TP_FRAMES, hop, h, h0], snr_db=db,
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
    log(f"[parallel] hand-kernel launches on the ranks: {result['launches']}")
    return result


# --------------------------------------------------------------- phase 18

ST_SECONDS = 3.0
ST_STEPS = 20
ST_CPU_STEPS = 2  # the CPU's steps at full width, from the card's extractor
ST_ITER_RTOL = 1e-4  # card vs CPU: iterate error over the displacement
ST_RTOL = 1e-4  # card vs CPU: loss and accepted stepsize, relative
ST_DRAW_PREFIX = 1 << 20  # extractor elements drawn on both devices
ST_DRAW_MAX_ULPS = 64
GL_CPU_ITERS = 8
GL_FLOOR_DB = 90.0
DREAM_SECONDS, DREAM_RATE = 4.0, 16000
DREAM_ITERS, DREAM_LR, DREAM_LAYER = 20, 10.0, 2
DREAM_CPU_ITERS = 3
# at 63,488 samples and lr 10 the ascent magnifies float noise: on the CPU
# the port against itself with the input scaled by 1 + 1e-7 parts by 93.7
# dB after 3 iterations (108.0 after 1 and 2), as the port against the
# JAX package does (93.7 dB); an H100 against the CPU measured 91.83 dB
DREAM_FLOOR_DB = 80.0
DREAM_VALUE_RTOL = 1e-5


def glide_audio(sr: int, seconds: float) -> np.ndarray:
    """A harmonic glide, 110 -> 440 Hz over ``seconds``, 8 harmonics at
    1/h, peak 0.5: the style transfer's content."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 110.0 * 4.0 ** (t / seconds)
    phase = np.cumsum(f0) / sr
    x = sum(np.sin(2 * np.pi * h * phase) / h for h in range(1, 9))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def phase_experiments(device, smi: str):
    """Style transfer, Griffin-Lim and DeepDream at full size, card vs CPU."""
    import torch

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.experiments import dream as dream_mod
    from ddsp_tpu_torch.experiments import style_transfer as st
    from ddsp_tpu_torch.models.crepe import crepe_init
    from ddsp_tpu_torch.ops import fir
    from ddsp_tpu_torch.ops.griffin_lim import griffin_lim
    from ddsp_tpu_torch.utils import gl_quality_curve as glq

    cpu = torch.device("cpu")
    conf = st.StyleTransferConfig(n_steps=ST_STEPS)
    sr = conf.sample_rate
    content = torch.from_numpy(glide_audio(sr, ST_SECONDS)).to(device)
    style = torch.from_numpy(glq.fixture_audio(sr, ST_SECONDS)).to(device)
    cs, ss = st.log_spectrogram(content, conf), st.log_spectrogram(style, conf)
    t = min(cs.shape[1], ss.shape[1])
    cs, ss = cs[:, :t].contiguous(), ss[:, :t].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ext = st.extractor_init(fir.PRNGKey(0), cs.shape[0], conf, device)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draws = [fir.normal(fir.PRNGKey(0, d), (ST_DRAW_PREFIX,)).cpu().numpy() for d in (device, cpu)]
    ulps = np.abs(draws[0] - draws[1]) / np.spacing(np.abs(draws[1]))
    log(f"[experiments] {smi}: extractor {tuple(ext['weight'].shape)} drawn in {draw_s:.3f} s; "
        f"its first {ST_DRAW_PREFIX} draws card vs CPU: {(ulps > 0).mean():.4f} differ, at most "
        f"{ulps.max():.0f} ulps")
    require(ulps.max() <= ST_DRAW_MAX_ULPS, f"extractor draw card vs CPU {ulps.max()} ulps")

    # one evaluation first (cuDNN's first call), then the card's 20 steps,
    # each timed, and a 21st under the profiler
    t0 = time.perf_counter()
    st.make_value_and_grad(ext, cs, ss, conf)(cs)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    run = st.style_transfer_steps(cs, ss, conf._replace(n_steps=ST_STEPS + 1), device=device,
                                  extractor=ext)
    steps, ms = [], []
    for _ in range(ST_STEPS):
        t0 = time.perf_counter()
        steps.append(next(run))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = next(run)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[experiments] first loss evaluation {first_ms:.1f} ms; one profiled step "
        f"({profiled.state.evaluations} evaluations): wall {prof_ms:.3f} ms, the card busy "
        f"{sum(by_name.values()):.3f} ms in {len(device_kernel_ns(prof))} kernels; most: "
        + "; ".join(f"{name[:60]} {t:.3f}" for name, t in top))
    evals = [s.state.evaluations for s in steps]
    f, c_in, k = ext["weight"].shape
    tf = t - k + 1
    flops = 4.0 * f * c_in * k * tf + 6.0 * f * f * tf  # conv fwd + d/dspec, Gram fwd + bwd
    eval_ms = sum(ms) / sum(evals)
    for i, s in enumerate(steps):
        log(f"[experiments] L-BFGS step {i}: {ms[i]:.3f} ms, {evals[i]} loss evaluations, "
            f"stepsize {float(s.state.learning_rate):.6g}, {s.state.info.num_linesearch_steps} "
            f"line-search steps, loss {float(s.loss):.6e} (style {float(s.style):.6e})")
    loss0, loss_end = float(steps[0].loss), float(steps[-1].loss)
    style0, style_end = float(steps[0].style), float(steps[-1].style)
    log(f"[experiments] style transfer {tuple(cs.shape)} on the card: median "
        f"{statistics.median(ms):.3f} ms a step ({sum(ms):.1f} ms for {ST_STEPS}), "
        f"{sum(evals)} loss evaluations, {eval_ms:.3f} ms each against a float32 bound of "
        f"{flops / PEAK_FP32_FLOPS * 1e3:.3f} ms ({flops:.3e} FLOP); loss {loss0:.6e} -> "
        f"{loss_end:.6e}, Gram distance {style0:.6e} -> {style_end:.6e}")
    require(np.isfinite(loss_end) and loss_end < loss0, f"loss did not fall: {loss0} -> {loss_end}")
    require(style_end < style0, f"Gram distance did not fall: {style0} -> {style_end}")

    cpu_conf = conf._replace(n_steps=ST_CPU_STEPS)
    t0 = time.perf_counter()
    cpu_steps = list(st.style_transfer_steps(cs.cpu(), ss.cpu(), cpu_conf, device="cpu",
                                             extractor={"weight": ext["weight"].cpu()}))
    cpu_s = time.perf_counter() - t0
    st_err = []
    for i, (a, b) in enumerate(zip(cpu_steps, steps)):
        disp = float(torch.linalg.vector_norm(a.spec - cs.cpu()))
        err = float(torch.linalg.vector_norm(b.spec.cpu() - a.spec)) / disp
        loss_err = abs(float(b.loss) - float(a.loss)) / abs(float(a.loss))
        lr_err = abs(float(b.state.learning_rate) - float(a.state.learning_rate)) / float(
            a.state.learning_rate)
        st_err.append(err)
        log(f"[experiments] step {i} card vs CPU: iterate {err:.3e} of its displacement, loss "
            f"{loss_err:.3e}, stepsize {lr_err:.3e} relative, line-search steps "
            f"{b.state.info.num_linesearch_steps} / {a.state.info.num_linesearch_steps}")
        require(err <= ST_ITER_RTOL, f"style step {i} iterate card vs CPU {err:.3e}")
        require(loss_err <= ST_RTOL and lr_err <= ST_RTOL,
                f"style step {i} loss {loss_err:.3e} / stepsize {lr_err:.3e} card vs CPU")
        require(b.state.info.num_linesearch_steps == a.state.info.num_linesearch_steps,
                f"style step {i} line-search steps differ card vs CPU")
    log(f"[experiments] the CPU's {ST_CPU_STEPS} steps took {cpu_s:.1f} s")

    # Griffin-Lim: the style transfer's inversion, card vs CPU, the curve
    mag = torch.expm1(torch.clamp_min(steps[-1].spec, 0.0)).T.contiguous()
    length = (t - 1) * conf.hop
    griffin_lim(mag, conf.n_fft, conf.hop, n_iter=2, length=length)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    audio = griffin_lim(mag, conf.n_fft, conf.hop, n_iter=conf.gl_iters, length=length)
    end.record()
    torch.cuda.synchronize()
    gl_ms = start.elapsed_time(end)
    sc = glq.spectral_convergence(audio, mag, conf.n_fft, conf.hop)
    short = [griffin_lim(mag.to(d), conf.n_fft, conf.hop, n_iter=GL_CPU_ITERS, length=length)
             for d in (device, cpu)]
    gl_db = snr_db(short[1].numpy(), short[0].cpu().numpy())
    log(f"[experiments] Griffin-Lim of the result, {tuple(mag.shape)}, {conf.gl_iters} iterations: "
        f"{gl_ms:.3f} ms ({gl_ms / conf.gl_iters:.4f} ms an iteration), spectral convergence "
        f"{sc:.5f}; {GL_CPU_ITERS} iterations card vs CPU {gl_db:.2f} dB")
    require(audio.shape == (length,) and bool(torch.isfinite(audio).all()), "Griffin-Lim output")
    require(gl_db > GL_FLOOR_DB, f"Griffin-Lim card vs CPU {gl_db:.2f} dB <= {GL_FLOOR_DB}")
    curve = glq.quality_curve(device)
    for row in curve["rows"]:
        log(f"[experiments] Griffin-Lim curve {curve['shape']}: {row['n_iter']} iterations, "
            f"spectral convergence {row['spectral_convergence']:.5f} ({row['mag_err_db']:.2f} dB), "
            f"{row['ms']:.2f} ms ({row['ms_per_iter']:.4f} an iteration)")
    scs = [row["spectral_convergence"] for row in curve["rows"]]
    require(all(np.isfinite(scs)) and scs[-1] < scs[0], f"Griffin-Lim curve {scs}")

    # DeepDream
    crepe = crepe_init(Config().crepe_capacity, seed=SEED)
    n = int(DREAM_SECONDS * DREAM_RATE)
    wav = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(n) / DREAM_RATE)
           + 0.05 * np.random.default_rng(SEED).standard_normal(n)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        in_wav, out_wav = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        write_wav(in_wav, wav, DREAM_RATE)
        value = dream_mod.dream_file(crepe, in_wav, out_wav, DREAM_LAYER, DREAM_ITERS, DREAM_LR,
                                     device=device)
        dreamed, out_sr = read_wav(out_wav)
        mono = read_wav(in_wav)[0][0]
    mono = mono[: len(mono) - len(mono) % 2048][None]
    require(out_sr == DREAM_RATE and dreamed.shape == (1, mono.shape[1])
            and np.isfinite(dreamed).all() and np.abs(dreamed).max() <= 1.0,
            f"dream_file output {dreamed.shape} at {out_sr} Hz")
    _, value0 = dream_mod.dream(crepe, mono, DREAM_LAYER, 1, DREAM_LR, device=device)
    times = {}
    for iters in (1, DREAM_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dream_mod.dream(crepe, mono, DREAM_LAYER, iters, DREAM_LR, device=device)
        torch.cuda.synchronize()
        times[iters] = (time.perf_counter() - t0) * 1e3
    dream_ms = (times[DREAM_ITERS] - times[1]) / (DREAM_ITERS - 1)
    outs = [dream_mod.dream(crepe, mono, DREAM_LAYER, DREAM_CPU_ITERS, DREAM_LR, device=d)
            for d in (device, "cpu")]
    dream_db = snr_db(outs[1][0], outs[0][0])
    value_err = abs(outs[0][1] - outs[1][1]) / outs[1][1]
    log(f"[experiments] dream {mono.shape} on CREPE {Config().crepe_capacity}: activation norm "
        f"{value0:.4f} -> {value:.4f} over {DREAM_ITERS} iterations, {dream_ms:.3f} ms an "
        f"iteration; {DREAM_CPU_ITERS} iterations card vs CPU {dream_db:.2f} dB, norm "
        f"{value_err:.3e} relative")
    require(value > value0, f"dream activation norm did not rise: {value0} -> {value}")
    require(dream_db > DREAM_FLOOR_DB and value_err <= DREAM_VALUE_RTOL,
            f"dream card vs CPU {dream_db:.2f} dB, norm {value_err:.3e}")
    return {"style_ms_per_step": statistics.median(ms), "style_eval_ms": eval_ms,
            "style_first_eval_ms": first_ms, "style_profiled_busy_ms": sum(by_name.values()),
            "style_evals": evals, "style_card_vs_cpu": st_err, "gl_ms_per_iter": gl_ms / conf.gl_iters,
            "gl_sc": sc, "gl_curve": curve["rows"], "dream_ms_per_iter": dream_ms}


def timed_phase(phase: int, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def finite_json(x):
    """``x`` with every non-finite float as None: strict JSON.  An SNR of
    inf (a kernel bit-equal to its plain version) prints as null."""
    if isinstance(x, float):
        return x if np.isfinite(x) else None
    if isinstance(x, dict):
        return {k: finite_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_json(v) for v in x]
    return x


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

    timed = lambda phase, fn, *args: timed_phase(phase, fn, *args)  # noqa: E731
    timed(1, build_kernels)
    set_stft_impl("auto")
    kernel = timed(2, phase_kernel, device)
    serving, params, crepe, conf = timed(3, phase_serving, device)
    timed(4, phase_socket, device, params, crepe, conf)
    frames = timed(5, phase_frames, device)
    timed(6, phase_train_step, device)
    train_launches, auto_ms = timed(7, phase_training, device)
    try:
        stft_kernels = timed(8, phase_stft, device)
        timed(9, phase_finetune_step, device)
        ft_launches, _, _ = timed(10, phase_finetune_cli, device, auto_ms)
    finally:
        set_stft_impl("auto")
    variants = timed(11, phase_variants, device)
    contract_launches = timed(12, phase_contract_step, device)
    s1 = timed(13, phase_ct_conv, device)
    realtime = timed(14, phase_realtime, device)
    timed(15, phase_precision, device)
    recon = timed(16, phase_reconstruct, device)
    par = timed(17, phase_parallel, device, smi)
    timed(18, phase_experiments, device, smi)

    no_library = ("null: no single PyTorch call computes a harmonic sine-bank render or its "
                  "gradient; the nearest is the plain version")
    kernels = [dict(
        name="osc_hop_slots", route="cuda", source="ddsp_tpu_torch/csrc/osc_hop_slots.cu",
        replaces="ddsp_tpu/ops/pallas/oscillator.py:446", tpu_function="_kernel_banked",
        launches=serving["launches"], launches_by_variant=serving["launches_by_variant"],
        launches_by_slots=serving["launches_by_slots"],
        launches_realtime=realtime["launches"], library_ms=None, library=no_library,
        **kernel)]
    for name, line, tpu in (("osc_frames_fwd", 152, "_kernel_banked2"),
                            ("osc_frames_bwd", 777, "_kernel_banked2_bwd")):
        kernels.append(dict(
            name=name, route="cuda", source="ddsp_tpu_torch/csrc/osc_frames.cu",
            replaces=f"ddsp_tpu/ops/pallas/oscillator.py:{line}", tpu_function=tpu,
            launches=train_launches[name], launches_by_variant={
                k: v for k, v in train_launches["by_variant"].items() if k.startswith(name)},
            library_ms=None, library=no_library, **frames[name]))
    k1 = next(k for k in kernels if k["name"] == "osc_frames_fwd")
    k1["launches_realtime"] = realtime["live"]["launches"]
    k1["launches_reconstruct"] = recon["launches"]
    k1["reconstruct_shape"] = recon["k1"]
    k1["launches_parallel"] = {"renders": par["launches"]["osc_frames_fwd_renders"],
                               "dp_steps": par["launches"]["osc_frames_fwd"]}
    k1["parallel_tp_shard"] = par["k1_tp_shard"]
    k2 = next(k for k in kernels if k["name"] == "osc_frames_bwd")
    k2["launches_parallel"] = par["launches"]["osc_frames_bwd"]
    kernels.append(dict(
        name="osc_frames_overlap_add", route="cuda", source="ddsp_tpu_torch/csrc/osc_frames.cu",
        replaces="ddsp_tpu/ops/pallas/oscillator.py:777", tpu_function="_kernel_banked2_bwd "
        "(the overlap-add of its window gradients, _pallas_backward :1048-1052, XLA code "
        "around the kernel)", launches=train_launches["osc_frames_overlap_add"],
        launches_finetune_cli=ft_launches["osc_frames_overlap_add"],
        **frames["osc_frames_overlap_add"]))
    for name, line, tpu in (("stft_power_fwd", 113, "_fwd_kernel"),
                            ("stft_power_bwd", 139, "_bwd_kernel")):
        kernels.append(dict(
            name=name, route="cuda", source="ddsp_tpu_torch/csrc/stft_power.cu",
            replaces=f"ddsp_tpu/ops/pallas/stft.py:{line}", tpu_function=tpu,
            launches=ft_launches[name], **stft_kernels[name]))
    kernels[-1]["launches_recompute"] = ft_launches["stft_power_bwd_recompute"]
    osc_tpu = "ddsp_tpu/ops/pallas/oscillator.py"
    sources = {  # kernel: (source in csrc/, the TPU kernel it replaces, its function)
        "osc_cheb_fwd": ("osc_cheb.cu", f"{osc_tpu}:317", "_kernel_cheb"),
        "osc_banked_bwd": ("osc_banked_bwd.cu", f"{osc_tpu}:651", "_kernel_cheb_bwd"),
        "osc_fill_only": ("osc_banked_bwd.cu", "scripts/bwd_ablation.py:25", "_kernel_fill_only"),
        "osc_hop_slots": ("osc_hop_slots.cu", f"{osc_tpu}:446", "_kernel_banked"),
        "osc_frames_fwd": ("osc_frames.cu", f"{osc_tpu}:152", "_kernel_banked2 (K8 options)"),
        "osc_frames_bwd": ("osc_frames.cu", f"{osc_tpu}:777", "_kernel_banked2_bwd (K8 options)"),
    }
    kernels.append(dict(
        name="ct_conv", route="cuda", source="ddsp_tpu_torch/csrc/ct_conv.cu",
        replaces="scripts/ab_ct_conv_kernel.py:44", tpu_function="_kernel",
        launches=train_launches["ct_conv"], launches_finetune_cli=ft_launches["ct_conv"],
        library="torch.fft.ifft(torch.fft.fft(z) * K) on the same complex rows (cuFFT)",
        **s1["ct_conv"]))
    kernels.append(dict(
        name="ct_conv_dsignal", route="cuda", source="ddsp_tpu_torch/csrc/ct_conv.cu",
        replaces="scripts/ab_ct_conv_kernel.py:44", tpu_function="_kernel (the reverb's "
        "bf16 d/dsignal, flips, overlap-save blocks and row packing in its loads and stores)",
        launches=train_launches["ct_conv_dsignal"],
        launches_finetune_cli=ft_launches["ct_conv_dsignal"],
        library="torch.fft.irfft(torch.fft.rfft(g) * conj(H)): the float32 cuFFT correlation",
        launches_parallel=par["launches"]["ct_conv_dsignal"], **s1["ct_conv_dsignal"]))
    for name, entry in variants.items():
        if name in ("osc_frames_fwd", "osc_frames_bwd"):
            continue  # the default K1/K2: their entries above
        base = name.split("[")[0]
        src, replaces, tpu = sources[base]
        kernels.append(dict(
            name=name if base != "osc_hop_slots" else "osc_hop_slots[frame rows, h_start]",
            route="cuda", source=f"ddsp_tpu_torch/csrc/{src}", replaces=replaces,
            tpu_function=tpu, library_ms=None, library=no_library, **entry))
    for k in kernels:
        if k["name"] in contract_launches:
            k["launches_contract_step"] = contract_launches[k["name"]]
        k["kernel_ms"] = k["ms"]
    print(json.dumps({"kernels": finite_json(kernels)}), flush=True)
    # one card driven, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
