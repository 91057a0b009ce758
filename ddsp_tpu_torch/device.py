"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: without a GPU
and without an explicit ``"cpu"`` they raise instead of carrying on on the
CPU.  On CUDA, float32 matmuls and cuDNN convolutions are set to full
float32 (TF32 off), as the JAX package computes in float32.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` ("cuda", "cuda:N", "cpu" or a ``torch.device``) -> the
    device, after the checks and precision settings above."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
