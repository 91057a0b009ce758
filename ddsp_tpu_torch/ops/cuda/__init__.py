"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper adds one to a module-level counter where it launches its
kernel and nowhere else.  :func:`launch_counts` reads every counter by
kernel name and :func:`reset_launch_counts` sets them all to 0, so a run
can show which kernels its path launched, and that no other was.
"""

from __future__ import annotations

import importlib

# kernel name -> (wrapper module, its counter)
COUNTERS = {
    "osc_hop_slots": ("oscillator", "LAUNCHES"),
    "osc_frames_fwd": ("osc_frames", "FWD_LAUNCHES"),
    "osc_frames_bwd": ("osc_frames", "BWD_LAUNCHES"),
    "osc_frames_overlap_add": ("osc_frames", "OVERLAP_LAUNCHES"),
    "osc_cheb_fwd": ("osc_cheb", "LAUNCHES"),
    "osc_banked_bwd": ("osc_banked_bwd", "BWD_LAUNCHES"),
    "osc_fill_only": ("osc_banked_bwd", "FILL_LAUNCHES"),
    "stft_power_fwd": ("stft", "FWD_LAUNCHES"),
    "stft_power_bwd": ("stft", "BWD_LAUNCHES"),
    "stft_power_bwd_recompute": ("stft", "BWD_RECOMPUTE_LAUNCHES"),
    "ct_conv": ("ct_conv", "LAUNCHES"),
    "ct_conv_dsignal": ("ct_conv", "DSIGNAL_LAUNCHES"),
}
# the wrappers that also count their launches by variant
VARIANT_COUNTERS = ("oscillator", "osc_frames")


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} for every hand kernel."""
    return {k: getattr(_module(m), attr) for k, (m, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every launch counter to 0, the by-variant counters included."""
    for m, attr in COUNTERS.values():
        setattr(_module(m), attr, 0)
    for m in VARIANT_COUNTERS:
        _module(m).VARIANT_LAUNCHES.clear()
