"""Spectrogram style transfer (Gatys-style) on log1p-magnitude STFTs.

Counterpart of ``ddsp_tpu/experiments/style_transfer.py`` (reference
style_transfer.py:19-165): a fixed random Conv1d(channels -> 4096, kernel
17) feature extractor over the spectrogram's frequency channels, content
loss = feature MSE, style loss = Gram-matrix MSE, the content
*spectrogram* optimised directly, then Griffin-Lim inversion.  The
optimiser is the port's copy of ``optax.lbfgs`` (``experiments/lbfgs.py``),
so the iterates follow the JAX package's; the conv is cuDNN's float32
convolution (TF32 off), the transforms ``torch.fft``.

    python -m ddsp_tpu_torch.experiments.style_transfer content.wav style.wav out.wav [steps] [--device=cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.experiments.lbfgs import LBFGS, LBFGSState
from ddsp_tpu_torch.ops.fir import PRNGKey, normal
from ddsp_tpu_torch.ops.griffin_lim import griffin_lim, stft_pair


class StyleTransferConfig(NamedTuple):
    n_fft: int = 2048
    hop: int = 512
    kernel_size: int = 17
    n_features: int = 4096
    content_weight: float = 1.0  # alpha (reference style_transfer.py:121)
    style_weight: float = 1.0e13  # beta (:122; gram normalization matches)
    n_steps: int = 1000  # reference LBFGS max_iter (:124)
    # LBFGS step scale (the reference's film_ui exposes lr, LBFGS(lr=1),
    # style_transfer.py:124).  0 = optax's zoom linesearch (adaptive step,
    # the validated default); > 0 = fixed step like torch LBFGS(lr=...).
    learning_rate: float = 0.0
    # Griffin-Lim iterations for the inversion; the reference runs 5000
    # (style_transfer.py:149-154).  The port's curve on an NVIDIA H100
    # 80GB HBM3 at 700 W (utils/gl_quality_curve.py, n_fft 2048 / hop 512
    # on its 3 s fixture; PERF.md section 5) plateaus by 512: spectral
    # convergence 0.05922 at 512 against 0.05912 at 5000 (0.07966 at 64),
    # at 0.3269-0.6616 ms an iteration across the runs listed there.
    gl_iters: int = 512
    sample_rate: int = 44100


def _on(x, dev: torch.device) -> torch.Tensor:
    """A tensor or array as a float32 tensor on ``dev`` (arrays copied)."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))
    return x.to(dev, torch.float32)


class StyleStep(NamedTuple):
    """One optimiser step: the spectrogram after it, the optimiser state,
    and the loss terms at the spectrogram it started from."""

    spec: torch.Tensor
    state: LBFGSState
    loss: torch.Tensor
    content: torch.Tensor
    style: torch.Tensor


def log_spectrogram(audio: torch.Tensor, conf: StyleTransferConfig) -> torch.Tensor:
    """log1p |STFT| feature map, (channels=bins, frames), of 1-D audio
    (reference ``np.log1p(np.abs(librosa.stft(...)))``, style_transfer.py:28-36)."""
    re, im = stft_pair(audio, conf.n_fft, conf.hop)
    return torch.log1p(torch.sqrt(re * re + im * im)).T


def extractor_init(key: torch.Tensor, n_channels: int, conf: StyleTransferConfig,
                   device=None) -> Dict[str, torch.Tensor]:
    """Fixed random conv weights (never trained), reference :68-81:
    ``std * jax.random.normal(key, (features, channels, kernel))``."""
    std = float(np.float32(np.sqrt(2.0 / (n_channels * conf.kernel_size))))
    key = key.to(device) if device is not None else key
    return {"weight": std * normal(key, (conf.n_features, n_channels, conf.kernel_size))}


def extract_features(extractor: Dict[str, torch.Tensor], spec: torch.Tensor) -> torch.Tensor:
    """(channels, frames) -> (n_features, frames') ReLU conv features
    (VALID, NCH / OIH)."""
    return torch.relu(F.conv1d(spec[None], extractor["weight"])[0])


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """Normalized feature covariance (reference :49-57)."""
    c, t = features.shape
    return (features @ features.T) / (c * t)


def make_value_and_grad(extractor: Dict[str, torch.Tensor], content_spec: torch.Tensor,
                        style_spec: torch.Tensor, conf: StyleTransferConfig):
    """The objective as the optimiser calls it: ``spec -> (loss, d loss /
    d spec, (content, style))``, loss = content_weight * feature MSE +
    style_weight * Gram MSE against the content's features and the style's
    Gram matrix."""
    with torch.no_grad():
        content_target = extract_features(extractor, content_spec)
        style_target = gram_matrix(extract_features(extractor, style_spec))

    def value_and_grad(spec):
        spec = spec.detach().requires_grad_(True)
        feats = extract_features(extractor, spec)
        c = torch.mean((feats - content_target) ** 2)
        s = torch.mean((gram_matrix(feats) - style_target) ** 2)
        loss = conf.content_weight * c + conf.style_weight * s
        (grad,) = torch.autograd.grad(loss, spec)
        return loss.detach(), grad, (c.detach(), s.detach())

    return value_and_grad


def style_transfer_steps(
    content_spec,
    style_spec,
    conf: StyleTransferConfig,
    key: Optional[torch.Tensor] = None,
    device="cuda",
    extractor: Optional[Dict[str, torch.Tensor]] = None,
) -> Iterator[StyleStep]:
    """The optimisation of :func:`style_transfer_spec`, one
    :class:`StyleStep` per L-BFGS step, for ``conf.n_steps`` steps.

    ``extractor``: the conv weights (``extractor_init``'s, or the JAX
    package's through ``models/convert.extractor_from_jax``); by default
    drawn from ``key`` (``PRNGKey(0)``) on the device."""
    dev = resolve_device(device)
    content_spec, style_spec = _on(content_spec, dev), _on(style_spec, dev)
    if content_spec.shape[1] < conf.kernel_size:
        raise ValueError(
            f"spectrogram has {content_spec.shape[1]} frames < kernel_size "
            f"{conf.kernel_size}; provide longer audio or a smaller kernel"
        )
    if extractor is None:
        key = PRNGKey(0) if key is None else key
        extractor = extractor_init(key, content_spec.shape[0], conf, dev)
    else:
        extractor = {"weight": extractor["weight"].to(dev)}

    value_and_grad = make_value_and_grad(extractor, content_spec, style_spec, conf)
    # Fixed-step torch semantics need the zoom linesearch DISABLED, as in
    # the JAX package: with the search, a learning rate only rescales the
    # direction the search then re-scales.
    opt = LBFGS(learning_rate=conf.learning_rate if conf.learning_rate > 0 else None)

    def steps():
        spec, state = content_spec, opt.init(content_spec)
        for _ in range(conf.n_steps):
            spec, state, loss, (c, s) = opt.step(spec, state, value_and_grad)
            yield StyleStep(spec, state, loss, c, s)

    return steps()


def style_transfer_spec(
    content_spec,
    style_spec,
    conf: StyleTransferConfig,
    key: Optional[torch.Tensor] = None,
    log_every: int = 0,
    device="cuda",
    extractor: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Optimize the content spectrogram toward the style statistics.

    Returns (stylized log-spectrogram, final loss terms): the terms at the
    start of the last step, as the JAX package reports them."""
    spec = content_spec
    loss = c = s = torch.tensor(float("nan"))
    for i, step in enumerate(style_transfer_steps(content_spec, style_spec, conf, key, device,
                                                  extractor)):
        spec, loss, c, s = step.spec, step.loss, step.content, step.style
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss {float(loss):.5f} content {float(c):.5f} style {float(s):.7f}")
    return spec, {"loss": float(loss), "content": float(c), "style": float(s)}


def style_transfer_audio(
    content_audio,
    style_audio,
    conf: StyleTransferConfig = StyleTransferConfig(),
    key: Optional[torch.Tensor] = None,
    log_every: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, Dict[str, float]]:
    """End to end: audio pair -> stylized audio via Griffin-Lim inversion."""
    dev = resolve_device(device)
    cs = log_spectrogram(_on(content_audio, dev), conf)
    ss = log_spectrogram(_on(style_audio, dev), conf)
    # match frame counts like the reference trim (helper.py:40-47)
    t = min(cs.shape[1], ss.shape[1])
    out_spec, metrics = style_transfer_spec(cs[:, :t], ss[:, :t], conf, key, log_every, dev)
    mag = torch.expm1(torch.clamp_min(out_spec, 0.0)).T  # (frames, bins)
    audio = griffin_lim(mag, conf.n_fft, conf.hop, n_iter=conf.gl_iters,
                        length=(t - 1) * conf.hop)
    return audio.cpu().numpy(), metrics


def main(argv=None) -> None:
    """CLI: python -m ddsp_tpu_torch.experiments.style_transfer content.wav
    style.wav out.wav [steps] [--device=cuda|cpu]"""
    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav

    parser = argparse.ArgumentParser(prog="style_transfer")
    parser.add_argument("content")
    parser.add_argument("style")
    parser.add_argument("out")
    parser.add_argument("steps", nargs="?", type=int, default=1000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)  # fail before reading anything without a GPU
    content, sr = read_wav(args.content)
    style, _ = read_wav(args.style)
    conf = StyleTransferConfig(sample_rate=sr, n_steps=args.steps)
    out, metrics = style_transfer_audio(content.mean(0), style.mean(0), conf, log_every=50,
                                        device=dev)
    write_wav(args.out, out / max(1e-6, np.abs(out).max()) * 0.9, sr)
    print("done:", metrics)


if __name__ == "__main__":
    main()
