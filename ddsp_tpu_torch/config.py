"""Immutable configuration of the PyTorch/CUDA port.

A copy of ``ddsp_tpu.config.Config``: the same fields, defaults and JSON
form, so a ``config.json`` written by the JAX package loads here unchanged
(``from_dict`` rejects unknown keys).  Kept as a copy, not an import, so
the port never loads the JAX package.

Some fields only choose a TPU code path in the JAX package.  In this port:

* ``osc_impl`` is read by nothing: the oscillator dispatches by device
  (a CUDA tensor launches the hand-written kernels, a CPU tensor takes
  their plain PyTorch versions);
* ``crepe_layout`` is read by nothing: the port runs the torch-shaped
  (N, C, H) convolution stack, the same math as both JAX layouts;
* ``crepe_compute_dtype`` and ``compute_dtype`` are read by nothing: the
  port's CREPE and controller run in full float32 (TF32 off);
* ``loss_matmul_dtype`` ('bfloat16' by default) selects, under
  ``ops/spectral.set_stft_impl('pallas')``, the bf16 power-STFT kernels for
  the loss spectrograms, as it selects the Pallas kernels in the JAX
  package; under the default 'auto' every loss STFT is a float32
  ``torch.stft``, whatever its value;
* ``reverb_grad_matmul_dtype`` is accepted and changes nothing: the
  reverb's forward and backward are float32 ``torch.fft`` transforms,
  since cuFFT has no bf16 transform.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Hyperparameters of the DDSP autoencoder and its training pipeline."""

    # --- data ---------------------------------------------------------------
    data_dir: str = "data"
    example_duration: float = 2.0  # seconds per training example
    example_overlap: float = 0.5  # seconds of overlap step between examples
    sample_rate: int = 44100

    # --- analysis frontend --------------------------------------------------
    n_fft: int = 2048
    hop_length: int = 512
    crepe_capacity: str = "tiny"  # 'tiny' | 'full'
    crepe_sample_rate: int = 16000
    crepe_window: int = 1024
    # CREPE conv operand dtype in the JAX package.  Not read by the port:
    # its CREPE runs in float32 with TF32 off.
    crepe_compute_dtype: str = "float32"
    # CREPE conv-stack layout of the JAX package ('nlc' | 'nch'), a TPU
    # layout choice.  Not read by the port: it always runs the
    # torch-shaped (N, C, H) stack, which is the same math.
    crepe_layout: str = "nlc"
    # Pitch decode: 'argmax' (reference training path, encoder.py:120-128),
    # 'weighted' (intent-corrected local weighted average), or
    # 'centered_ref' (bug-compatible replica of the reference's
    # pitch_centered for exact checkpoint A/B, models/crepe.py).
    pitch_decode: str = "argmax"

    # --- synthesizer --------------------------------------------------------
    n_harmonics: int = 180
    n_noise_filters: int = 195
    reverb_length: int = 0  # 0 -> sample_rate (1 second IR)

    # --- decoder network ----------------------------------------------------
    decoder_mlp_units: int = 512
    decoder_mlp_layers: int = 3
    decoder_gru_units: int = 512
    decoder_gru_layers: int = 1

    # --- training -----------------------------------------------------------
    batch_size: int = 16
    learning_rate: float = 1e-3
    lr_plateau_patience: int = 5
    lr_plateau_factor: float = 0.1
    # Steps averaged per plateau-monitor reading.  Semantics note: torch's
    # ReduceLROnPlateau (reference train/train.py:21-30) counts patience in
    # *monitor calls* on raw per-step losses; optax's reduce_on_plateau
    # averages windows of this many steps and counts patience in windows.
    # 1 reproduces the reference's per-step monitoring (noisier); the
    # default 50 monitors ~epoch-averaged loss (less spurious decay).
    lr_plateau_accumulation: int = 50
    mss_ffts: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64)
    mss_alpha: float = 1.0
    mss_overlap: float = 0.75
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    log_every: int = 50
    checkpoint_every: int = 1000
    # Retention: keep the newest N finalized checkpoints (0 = keep all).
    checkpoint_keep: int = 3
    # Async saves (a background commit thread) keep the train loop from
    # blocking on checkpoint writes (SURVEY.md section 5).
    checkpoint_async: bool = True

    # --- numerics / hardware ------------------------------------------------
    # dtype of the JAX package's neural-net matmuls.  Not read by the
    # port, which runs the controller in float32.
    compute_dtype: str = "float32"
    # dtype of the MSS-loss STFT matmul inputs.  In the port 'bfloat16'
    # routes the loss spectrograms through the bf16 power-STFT kernels when
    # set_stft_impl('pallas') is set; otherwise they are float32 torch.stft.
    loss_matmul_dtype: str = "bfloat16"
    # dtype of the JAX package's reverb-convolution backward DFT matmuls.
    # Changes nothing in the port: the reverb's forward and backward are
    # float32 torch.fft transforms.
    reverb_grad_matmul_dtype: str = "bfloat16"
    # JAX oscillator path ('auto' | 'xla' | 'pallas').  Not read by the
    # port: the device decides -- a CUDA tensor launches the CUDA kernels
    # (ops/cuda/oscillator.py, ops/cuda/osc_frames.py), a CPU tensor takes
    # their plain versions.
    osc_impl: str = "auto"

    # --- parallelism --------------------------------------------------------
    mesh_data: int = 1  # data-parallel mesh axis size
    mesh_time: int = 1  # time-sharding mesh axis size (long renders)

    # ------------------------------------------------------------------------
    @property
    def example_length(self) -> int:
        """Samples per training example, rounded down to a hop multiple.

        Matches the reference's duration rounding (reference:
        dataset/audio_dataset.py:50-53): 2 s * 44100 = 88200 -> 88064.
        """
        duration = int(self.example_duration * self.sample_rate)
        return duration - duration % self.hop_length

    @property
    def example_step(self) -> int:
        """Stride between successive training examples, in samples."""
        step = int(self.example_overlap * self.sample_rate)
        return step - self.example_length % self.hop_length

    @property
    def frames_per_example(self) -> int:
        """STFT frames per (padded) example; the frame/sample contract.

        With the reference padding of ``n_fft - hop_length`` samples
        (reference: model/autoencoder/autoencoder.py:14-18) an example of
        ``example_length`` samples yields exactly
        ``example_length // hop_length`` frames (172 for defaults).
        """
        padded = self.example_length + self.n_fft - self.hop_length
        return (padded - self.n_fft) // self.hop_length + 1

    @property
    def ir_length(self) -> int:
        return self.reverb_length if self.reverb_length else self.sample_rate

    # --- serialization ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw: Dict[str, Any] = json.loads(text)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        if "mss_ffts" in raw:
            raw = dict(raw, mss_ffts=tuple(raw["mss_ffts"]))
        return cls(**raw)

    def replace(self, **kwargs: Any) -> "Config":
        if "mss_ffts" in kwargs:
            kwargs = dict(kwargs, mss_ffts=tuple(kwargs["mss_ffts"]))
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_flags(cls, argv: Sequence[str], base: "Config" = None) -> "Config":
        """Parse ``--key=value`` CLI overrides on top of ``base``.

        Values are parsed as JSON when possible, else kept as strings, so
        ``--learning_rate=3e-4 --mss_ffts=[512,256] --data_dir=/x`` all work.
        """
        conf = base or cls()
        overrides: Dict[str, Any] = {}
        for arg in argv:
            if not arg.startswith("--"):
                raise ValueError(f"Expected --key=value flag, got {arg!r}")
            key, _, value = arg[2:].partition("=")
            try:
                overrides[key] = json.loads(value)
            except json.JSONDecodeError:
                overrides[key] = value
        merged = dict(dataclasses.asdict(conf), **overrides)
        return cls.from_dict(merged)
