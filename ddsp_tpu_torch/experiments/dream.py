"""CREPE DeepDream: gradient ascent on audio to excite a CREPE layer.

Counterpart of ``ddsp_tpu/experiments/dream.py`` (reference
trajectory.py:18-82, which hooks an intermediate CREPE layer and ascends
the input audio along the gradient of the activation's norm).  The
activation is ``models/crepe.crepe_activation``'s return value and each
step one autograd pass.

    python -m ddsp_tpu_torch.experiments.dream crepe.pth in.wav out.wav [layer] [iterations] [lr] [--device=cpu]
"""

from __future__ import annotations

import argparse
import copy
from typing import Tuple

import numpy as np
import torch

from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.crepe import WINDOW_SIZE, Crepe, crepe_activation


def dream(
    crepe: Crepe,
    audio,
    layer_index: int = 2,
    iterations: int = 20,
    lr: float = 10.0,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Gradient-ascend ||activation(layer)|| w.r.t. (B, length) audio.

    As the reference loop (trajectory.py:49-67): the audio is mean/std-
    normalized before the loop (unbiased std), each step adds ``lr * grad``
    raw, and the result is un-normalized and clipped to [-1, 1].  The
    objective is the L2 norm of the first batch row's activations.
    ``layer_index`` counts conv stages (0-based); the reference's hook on
    ``list(net.modules())[5]`` is stage 2, the default.  The stack is fully
    convolutional, so any length >= 1024 works.

    Returns (dreamed audio, activation norm at the last step's start).
    """
    dev = resolve_device(device)
    crepe = copy.deepcopy(crepe).to(dev).eval().requires_grad_(False)
    x = torch.as_tensor(np.array(audio, np.float32), device=dev)
    if x.dim() == 1:
        x = x[None]
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, keepdim=True)
    x = (x - mean) / std

    value = torch.tensor(0.0)
    for _ in range(iterations):
        x = x.detach().requires_grad_(True)
        value = torch.linalg.vector_norm(crepe_activation(crepe, x, layer_index)[0])
        (grad,) = torch.autograd.grad(value, x)
        x, value = x.detach() + lr * grad, value.detach()
    out = np.clip((x * std + mean).cpu().numpy(), -1.0, 1.0)
    return out, float(value)


def dream_file(
    crepe: Crepe,
    in_path: str,
    out_path: str,
    layer_index: int = 2,
    iterations: int = 20,
    lr: float = 10.0,
    sample_rate: int = 16000,
    device="cuda",
) -> float:
    """File-to-file dreaming over the whole (truncated) signal at once, as
    the reference main() (trajectory.py:44-76): the mono mix resampled to
    16 kHz, truncated to a multiple of 2048 samples, dreamed, written
    clipped.  Returns the final activation norm."""
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.ops.resample import resample

    dev = resolve_device(device)
    audio, sr = read_wav(in_path)
    mono = audio.mean(0) if audio.shape[0] > 1 else audio[0]
    if sr != sample_rate:
        mono = resample(torch.from_numpy(mono).to(dev), sr, sample_rate).cpu().numpy()
    mono = mono[: len(mono) - (len(mono) % 2048)]
    # after the truncation a length below WINDOW_SIZE is 0: the input had
    # fewer than 2048 samples
    if len(mono) < WINDOW_SIZE:
        raise ValueError(f"{in_path}: need >= 2048 samples at {sample_rate} Hz")
    dreamed, value = dream(crepe, mono[None], layer_index, iterations, lr, dev)
    write_wav(out_path, dreamed[0], sample_rate)
    return value


def main(argv=None) -> None:
    """CLI: python -m ddsp_tpu_torch.experiments.dream crepe.pth in.wav
    out.wav [layer] [iterations] [lr] [--device=cuda|cpu] -- the reference's
    trajectory.py:44-82 loop with its defaults (layer = conv stage 2, 20
    iterations, lr 10)."""
    from ddsp_tpu_torch.models.crepe import load_torch_checkpoint

    parser = argparse.ArgumentParser(prog="dream")
    parser.add_argument("crepe_checkpoint")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("layer", nargs="?", type=int, default=2)
    parser.add_argument("iterations", nargs="?", type=int, default=20)
    parser.add_argument("lr", nargs="?", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)  # fail before loading anything without a GPU
    value = dream_file(load_torch_checkpoint(args.crepe_checkpoint), args.input, args.output,
                       layer_index=args.layer, iterations=args.iterations, lr=args.lr,
                       device=dev)
    print(f"done: final activation norm {value:.3f}")


if __name__ == "__main__":
    main()
