"""Dataset pipeline: ingest -> chunk -> offline feature extraction -> cache.

Counterpart of ``ddsp_tpu/data/dataset.py`` (reference
dataset/audio_dataset.py:14-113):

* WAV files, plus mp3 / ogg / flac when a decoder backend is installed
  (``data/audio_io.read_audio``); the corpus decodes through the native
  parallel decoder (``native.load_corpus_mono``);
* caches are ``.npz`` keyed by a hash of the ingest config, the file list
  and mtimes, and -- for features -- the CREPE weights' content;
* feature extraction runs the frozen encoder batch by batch on the device;
* ``batch_iterator`` shuffles with a ``torch.Generator``.  Its order is
  not ``jax.random.permutation``'s: a test that compares the two packages
  feeds both the same batch.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.audio_io import UnsupportedAudioFormat, have_compressed_backend
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.autoencoder import feature_pad
from ddsp_tpu_torch.models.crepe import Crepe
from ddsp_tpu_torch.models.encoder import encoder_apply
from ddsp_tpu_torch.ops.resample import resample


def _cache_tag(conf: Config, files, extra: Optional[Dict] = None) -> str:
    """Hash of the ingest-relevant config + file list + mtimes."""
    payload = {
        "sample_rate": conf.sample_rate,
        "example_length": conf.example_length,
        "example_step": conf.example_step,
        "hop_length": conf.hop_length,
        "files": [(f, os.path.getmtime(f)) for f in sorted(files)],
    }
    if extra:
        payload.update(extra)
    return hashlib.sha1(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _params_digest(module: torch.nn.Module) -> str:
    """Content hash of a module's state dict (so caches of features
    computed with different CREPE weights cannot be confused)."""
    h = hashlib.sha1()
    for name, value in sorted(module.state_dict().items()):
        arr = value.detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def list_audio_files(data_dir: str):
    """The sorted ``.wav`` files under ``data_dir`` (recursive), with its
    mp3 / ogg / flac files when a decoder backend is installed (the
    reference's glob, audio_dataset.py:22-24).  Without a backend the
    compressed files are skipped beside wav files, and a directory that
    holds only compressed audio raises."""
    files = []
    for ext in ("wav", "WAV"):
        files += glob.glob(os.path.join(data_dir, "**", f"*.{ext}"), recursive=True)
    compressed = []
    for ext in ("mp3", "ogg", "flac"):
        compressed += glob.glob(os.path.join(data_dir, "**", f"*.{ext}"), recursive=True)
    if compressed:
        if have_compressed_backend():
            files += compressed
        elif not files:
            raise UnsupportedAudioFormat(
                f"Only compressed audio found ({compressed[:3]}...) and no decoder "
                "backend (soundfile/torchaudio/librosa/pygame) is installed; "
                "convert to wav"
            )
    if not files:
        raise ValueError(f"No valid audio files found in {data_dir!r}")
    return sorted(files)


def load_examples(conf: Config, clear: bool = False) -> np.ndarray:
    """(N, example_length) float32 overlapping examples, cached to npz.

    Load each file mixed to mono (the channel mean; the native parallel
    decoder, ``native.load_corpus_mono``), resample to ``conf.sample_rate``,
    pad to a hop multiple (split half and half) and unfold 2 s windows
    stepped by 0.5 s (audio_dataset.py:14-71).
    """
    files = list_audio_files(conf.data_dir)
    cache = os.path.join(conf.data_dir, f"audio_dataset_{_cache_tag(conf, files)}.npz")
    if os.path.exists(cache) and not clear:
        return np.load(cache)["examples"]

    from ddsp_tpu_torch.native import load_corpus_mono

    chunks = []
    for y, sr in load_corpus_mono(files):
        if sr != conf.sample_rate:
            y = resample(torch.from_numpy(np.ascontiguousarray(y)), sr,
                         conf.sample_rate).numpy()
        pad = (-len(y)) % conf.hop_length
        y = np.pad(y, (pad // 2, pad - pad // 2))
        length, step = conf.example_length, conf.example_step
        if len(y) < length:
            y = np.pad(y, (0, length - len(y)))
        n = 1 + (len(y) - length) // step
        idx = np.arange(n)[:, None] * step + np.arange(length)[None, :]
        chunks.append(y[idx].astype(np.float32))
    examples = np.concatenate(chunks, axis=0)
    np.savez_compressed(cache, examples=examples)
    return examples


def extract_features(
    crepe: Crepe,
    conf: Config,
    examples: Optional[np.ndarray] = None,
    clear: bool = False,
    include_probabilities: bool = True,
    batch_size: Optional[int] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Offline f0/loudness extraction over all examples, cached to npz.

    Runs the frozen encoder batch by batch with the contract padding on
    ``device`` (CUDA unless the caller passes "cpu"; ``crepe`` is moved
    there) and collects {f0, harmonicity, loudness, probabilities,
    normalized_cents, audio} as numpy arrays (audio_dataset.py:74-113).
    """
    dev = resolve_device(device)
    files = list_audio_files(conf.data_dir) if examples is None else []
    tag = _cache_tag(
        conf,
        files,
        extra={
            "n_fft": conf.n_fft,
            "crepe_window": conf.crepe_window,
            "crepe_sample_rate": conf.crepe_sample_rate,
            "crepe_capacity": conf.crepe_capacity,
            "crepe_weights": _params_digest(crepe),
        },
    )
    cache = os.path.join(conf.data_dir, f"features_{conf.crepe_capacity}_{tag}.npz")
    if examples is None and os.path.exists(cache) and not clear:
        return dict(np.load(cache))

    if examples is None:
        examples = load_examples(conf, clear)
    crepe = crepe.to(dev).eval()
    bs = batch_size or conf.batch_size
    outs: Dict[str, list] = {}
    for start in range(0, examples.shape[0], bs):
        batch = torch.from_numpy(examples[start : start + bs]).to(dev)
        feats = encoder_apply(crepe, feature_pad(batch, conf), conf)
        for k, v in feats.items():
            outs.setdefault(k, []).append(v.cpu().numpy())
    result = {k: np.concatenate(v, axis=0) for k, v in outs.items()}
    if not include_probabilities:
        result.pop("probabilities", None)
    result["audio"] = examples
    if files:
        np.savez_compressed(cache, **result)
    return result


def batch_iterator(
    data: Dict[str, np.ndarray],
    batch_size: int,
    generator: torch.Generator,
    shuffle: bool = True,
    drop_last: bool = True,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Shuffled minibatches of a dict-of-arrays dataset, as tensors on
    ``device``: each row once per pass, in an order drawn from
    ``generator`` (deterministic per seed; not jax's order)."""
    n = len(next(iter(data.values())))
    order = (
        torch.randperm(n, generator=generator).numpy() if shuffle else np.arange(n)
    )
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        yield {k: torch.from_numpy(np.asarray(v)[idx]).to(device) for k, v in data.items()}
