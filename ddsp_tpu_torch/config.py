"""Immutable configuration of the PyTorch/CUDA port.

A copy of ``ddsp_tpu.config.Config``: the same fields, defaults and JSON
form, so a ``config.json`` written by the JAX package loads here unchanged
(``from_dict`` rejects unknown keys).  Kept as a copy, not an import, so
the port never loads the JAX package.

Each field means what it means in the JAX package.  Those that choose a
precision or a code path do this in the port:

* ``osc_impl`` chooses the oscillator's sine fill as the JAX package's
  dispatch chooses its path (``models/synths.osc_fill``): 'auto' is the
  TPU kernels' rotation fill on the card (the kernels K1, K2 and K5) and
  the exact fill of the XLA path on the CPU (their plain versions);
  'pallas' is the rotation fill on both, 'xla' the exact fill on both;
* ``compute_dtype`` ('float32' by default: no rounding) rounds the
  controller's three MLPs to that dtype at the rounding points of the JAX
  package's compiled MLP (``models/nn.MLP``), in ``decoder_apply`` and
  ``decoder_synth_only`` (training, finetuning, offline decoding), where
  the JAX package reads it; the GRU, the dense heads and the serving and
  real-time stream steps stay float32, as in JAX;
* ``crepe_compute_dtype`` ('float32' by default) rounds CREPE's
  convolution and classifier operands to that dtype with float32 sums
  (``models/crepe.crepe_forward``), in the encoder (finetuning and the
  dataset's feature pass) where the JAX package reads it; the streaming
  feature step stays float32, as in JAX;
* ``crepe_layout`` is read by nothing: the port runs the torch-shaped
  (N, C, H) convolution stack, the same math as both JAX layouts;
* ``loss_matmul_dtype`` ('bfloat16' by default) selects, under
  ``ops/spectral.set_stft_impl('pallas')``, the bf16 power-STFT kernels for
  the loss spectrograms, as it selects the Pallas kernels in the JAX
  package; under the default 'auto' every loss STFT is a float32
  ``torch.stft``, whatever its value;
* ``reverb_grad_matmul_dtype`` ('bfloat16' by default) means what it
  means in the JAX package: the reverb's backward runs at that precision
  (``ops/fir.fft_convolve``), its d/dsignal on the permuted-CT transform
  with bf16 operands (the S1 kernel on the card); 'float32' is plain
  autograd of the float32 ``torch.fft`` convolution.  The forward is
  float32 either way.

Everything else runs in float32 with TF32 off (``device.resolve_device``).

The ``z_*`` fields are the port's own: ``z_dims`` above 0 gives the
decoder the DDSP autoencoder's latent z(t) (Engel et al. 2020, magenta/ddsp
``ae.gin``): an MFCC encoder with a GRU whose output, ``z_dims`` wide, is
the controller's third input stack (``models/z_encoder.py``).  While
``z_dims`` is 0, the default, there is no z encoder and the JSON form
leaves the ``z_*`` fields out, so it stays the JAX package's; ``from_dict``
accepts them either way.  The JAX package has no z encoder: the entry
points that would need one in a stream, or the JAX package's trees, refuse
a configuration with z (:func:`refuse_z`).
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
    # CREPE conv and classifier operand dtype (float32 sums), read by the
    # encoder (models/encoder.f0_encoder_apply).
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
    # dtype of the controller MLPs' matmuls and LayerNorms in the offline
    # decode and training (models/controller.decoder_apply).
    compute_dtype: str = "float32"
    # dtype of the MSS-loss STFT matmul inputs.  In the port 'bfloat16'
    # routes the loss spectrograms through the bf16 power-STFT kernels when
    # set_stft_impl('pallas') is set; otherwise they are float32 torch.stft.
    loss_matmul_dtype: str = "bfloat16"
    # dtype of the reverb-convolution backward's DFT matmul operands
    # (ops/fir.fft_convolve); 'float32' is plain float32 autograd.
    reverb_grad_matmul_dtype: str = "bfloat16"
    # Oscillator path ('auto' | 'xla' | 'pallas').  The port reads it as
    # the sine fill (models/synths.osc_fill): the Pallas kernels' rotation
    # fill for 'pallas' and for 'auto' on the card, the XLA path's exact
    # fill for 'xla' and for 'auto' on the CPU.  The device decides
    # whether the CUDA kernels or their plain versions run.
    osc_impl: str = "auto"

    # --- parallelism --------------------------------------------------------
    mesh_data: int = 1  # data-parallel mesh axis size
    mesh_time: int = 1  # time-sharding mesh axis size (long renders)

    # --- latent z(t) encoder (the port's own; see the module docstring) -----
    z_dims: int = 0  # width of z; 0: no z encoder
    z_time_steps: int = 125  # z frames an example (models/z_encoder.py)
    z_rnn_units: int = 512

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
    def to_dict(self) -> Dict[str, Any]:
        """The fields, the ``z_*`` ones left out while ``z_dims`` is 0."""
        d = dataclasses.asdict(self)
        if not self.z_dims:
            d = {k: v for k, v in d.items() if not k.startswith("z_")}
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

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


def refuse_z(conf: Config, what: str, needs: str) -> None:
    """Raise ``ValueError`` if ``conf`` has a z encoder: ``what`` does not
    support one, for want of ``needs``."""
    if conf.z_dims:
        raise ValueError(
            f"{what} does not support a z encoder (z_dims={conf.z_dims}): it needs {needs}, "
            "which the port does not have; use z_dims=0")
