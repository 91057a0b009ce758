"""Offline reconstruction: ``python -m ddsp_tpu_torch.reconstruct in.wav out.wav``.

Analysis by synthesis of one audio file through a trained decoder: CREPE
f0 and A-weighted loudness, then the decoder resynthesises the whole file
in one call on the device.  The counterpart of ``ddsp_tpu/reconstruct.py``.

Flags: any ``Config`` field (``--key=value``), plus

  --checkpoint_dir=DIR      the newest step_* checkpoint there: the port
                            trainer's (state.pt) or the JAX package
                            trainer's Orbax directory (read by
                            models/orbax.py with numpy and the system's
                            libzstd: no tensorstore); its config.json,
                            when present, is the base config
  --lightning_ckpt=F.ckpt   a reference-layout Lightning checkpoint instead
  --crepe_checkpoint=F.pth  CREPE weights (reference crepe/pretrained/*.pth).
                            Without it CREPE takes random weights from
                            crepe_init(seed=1), with a warning: the JAX
                            package draws them from PRNGKey(1), which the
                            port cannot reproduce, so the two packages agree
                            only given the same .pth
  --export_torch=F.ckpt     also write the decoder as a reference-layout
                            Lightning .ckpt (models/lightning_export.py)
  --device=cuda|cpu         cuda (the default) raises without a GPU

Any audio file that ``data/audio_io.read_audio`` reads: WAV, or mp3 / ogg
/ flac with a decoder backend.  Prints the stats as one JSON line.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np
import torch
from torch import nn

from ddsp_tpu_torch.config import Config, refuse_z
from ddsp_tpu_torch.data.audio_io import read_audio, write_wav
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.autoencoder import autoencoder_apply
from ddsp_tpu_torch.models.controller import Decoder
from ddsp_tpu_torch.models.crepe import crepe_init, load_torch_checkpoint
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.ops.resample import resample
from ddsp_tpu_torch.runtime.server import load_decoder

# the JAX package's name for the same loader: a Lightning .ckpt, else the
# newest step_* checkpoint under conf.checkpoint_dir (port or Orbax)
load_decoder_params = load_decoder


def prepare_audio(path: str, conf: Config) -> np.ndarray:
    """Read any supported file -> (1, L) float32 mono at ``conf.sample_rate``
    (the channel mean, resampled by ``ops/resample``), zero-padded to at
    least ``n_fft`` samples, then centre-padded to a hop multiple (the
    dataset's chunking convention)."""
    wav, sr = read_audio(path)
    y = wav.mean(axis=0)
    if sr != conf.sample_rate:
        y = resample(torch.from_numpy(np.ascontiguousarray(y)), sr, conf.sample_rate).numpy()
    if len(y) < conf.n_fft:
        y = np.pad(y, (0, conf.n_fft - len(y)))
    pad = (-len(y)) % conf.hop_length
    y = np.pad(y, (pad // 2, pad - pad // 2))
    return y[None, :].astype(np.float32)


def reconstruct_file(
    in_path: str,
    out_path: str,
    conf: Config,
    crepe_checkpoint: str = "",
    lightning_ckpt: str = "",
    decoder: Decoder = None,
    device="cuda",
) -> dict:
    """Reconstruct one file on ``device`` (CUDA unless the caller passes
    "cpu") and write it as 16-bit WAV; returns {'seconds', 'wall_s',
    'rms_in', 'rms_out', 'device'}.  ``wall_s`` times the one call of
    ``autoencoder_apply`` over the whole file, the copy back included.

    ``decoder``: a loaded :class:`Decoder`; None loads one from
    ``lightning_ckpt`` or ``conf.checkpoint_dir`` (a caller that also
    exports loads it once and passes it in).  The noise key is
    ``PRNGKey(conf.seed)``.  Non-finite output raises ValueError.
    """
    refuse_z(conf, "reconstruct_file", "z in the encoder's features of a whole file")
    dev = resolve_device(device)
    if decoder is None:
        decoder = load_decoder_params(conf, lightning_ckpt)
    if crepe_checkpoint:
        crepe = load_torch_checkpoint(crepe_checkpoint, conf.crepe_capacity)
    else:
        crepe = crepe_init(conf.crepe_capacity, seed=1)
        print("WARNING: no --crepe_checkpoint given; using random CREPE weights")
    # a copy on the device: the caller's modules stay where they are
    params = copy.deepcopy(nn.ModuleDict({"decoder": decoder, "crepe": crepe})).to(dev).eval()

    audio = prepare_audio(in_path, conf)
    x = torch.from_numpy(audio).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = autoencoder_apply(params, x, conf, PRNGKey(conf.seed, dev))[0].cpu().numpy()
    wall = time.perf_counter() - t0
    if not np.isfinite(out).all():
        raise ValueError("non-finite samples in reconstruction")
    write_wav(out_path, out, conf.sample_rate)
    return {
        "seconds": out.shape[-1] / conf.sample_rate,
        "wall_s": wall,
        "rms_in": float(np.sqrt(np.mean(audio**2))),
        "rms_out": float(np.sqrt(np.mean(out**2))),
        "device": str(dev),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if any(a in ("-h", "--help") for a in argv) or len(argv) < 2:
        print(__doc__.strip())
        return
    in_path, out_path, rest = argv[0], argv[1], argv[2:]
    extra = {"crepe_checkpoint": "", "lightning_ckpt": "", "export_torch": "",
             "device": "cuda"}
    flags = []
    for a in rest:
        key, sep, value = a[2:].partition("=")
        if key in extra:
            if not sep:
                raise SystemExit(f"expected --{key}=value, got {a!r}")
            extra[key] = value
        else:
            flags.append(a)
    # the checkpoint's own config.json is the base, so a bare
    # --checkpoint_dir reproduces the training-time settings
    base = Config()
    for a in flags:
        if a.startswith("--checkpoint_dir="):
            cj = os.path.join(a.split("=", 1)[1], "config.json")
            if os.path.exists(cj):
                with open(cj) as f:
                    base = Config.from_json(f.read())
    conf = Config.from_flags(flags, base=base)
    resolve_device(extra["device"])  # fail before loading anything without a GPU

    decoder = load_decoder_params(conf, extra["lightning_ckpt"])
    stats = reconstruct_file(in_path, out_path, conf,
                             crepe_checkpoint=extra["crepe_checkpoint"],
                             decoder=decoder, device=extra["device"])
    print(json.dumps(stats), flush=True)
    if extra["export_torch"]:
        from ddsp_tpu_torch.models.lightning_export import save_torch_decoder

        save_torch_decoder(decoder, conf, extra["export_torch"])
        print(f"decoder exported to {extra['export_torch']}")


if __name__ == "__main__":
    main()
