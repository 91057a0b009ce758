"""What a run refuses: a process that holds JAX or the JAX package, and a
machine without the cards a cell asks for."""

from __future__ import annotations

import sys
from typing import Iterable, List

# top-level module names that must never be loaded: the port's name begins
# with the JAX package's, so names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "ddsp_tpu")


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check_imports(modules: Iterable[str] = None) -> None:
    found = forbidden_modules(modules)
    if found:
        raise SystemExit(f"benchmark: forbidden modules loaded: {', '.join(found[:20])}")


def check_cards(chips: int, cuda=None) -> None:
    """Refuse to run without ``chips`` CUDA devices: there is no CPU fallback."""
    import torch

    cuda = torch.cuda if cuda is None else cuda
    if not cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (torch.cuda.is_available() is false)")
    if cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} CUDA devices, "
                         f"{cuda.device_count()} found")
