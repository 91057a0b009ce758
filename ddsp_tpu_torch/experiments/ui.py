"""Streamlit UI for spectrogram style transfer (optional dependency).

Counterpart of ``ddsp_tpu/experiments/ui.py`` (reference film_ui.py:1-37 +
helper.py:14-116): sliders for learning rate / alpha / beta / iterations /
kernel / features / window / hop, two file uploaders with trim sliders, a
start button, and spectrogram displays, over the port's style transfer on
the card.  Streamlit and matplotlib are optional; run it with

    streamlit run ddsp_tpu_torch/experiments/ui.py
"""

from __future__ import annotations

import pathlib

import numpy as np

try:
    import streamlit as st

    HAS_STREAMLIT = True
except Exception:  # pragma: no cover - optional dependency
    st = None
    HAS_STREAMLIT = False


def normalize_audio(x: np.ndarray) -> np.ndarray:
    """Remove DC offset and peak-normalize (reference helper.py:14-20);
    a zero-peak signal is returned unchanged (still DC-free)."""
    x = x - x.mean()
    peak = np.max(np.abs(x))
    return x / peak if peak > 0 else x


def trim_to_times(
    audio: np.ndarray,
    spec: np.ndarray,
    sample_rate: int,
    hop: int,
    start_time: float,
    end_time: float,
):
    """Trim a waveform and its (bins, frames) spectrogram to [start, end] s
    (reference helper.py:47-59): samples ``time * sample_rate``, frames
    ``floor(time * sample_rate / hop)`` (librosa ``time_to_frames``).
    Returns (trimmed_audio, trimmed_spec)."""
    start = int(start_time * sample_rate)
    end = int(end_time * sample_rate)
    start_frame = int(np.floor(start_time * sample_rate / hop))
    end_frame = int(np.floor(end_time * sample_rate / hop))
    return audio[start:end], spec[:, start_frame:end_frame]


def spectrogram_image(spec: np.ndarray) -> np.ndarray:
    """Min-max-normalized, low-frequency-at-bottom image of a (bins, frames)
    spectrogram, as the reference displays it (helper.py:60-63)."""
    img = np.flip(spec, axis=0).astype(np.float32)
    img = img - img.min()
    peak = img.max()
    return img / peak if peak > 0 else img


def spectrogram_figure(spec: np.ndarray, sample_rate: int, hop: int):
    """Log-spectrogram display figure (reference helper.py:50-65)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3))
    extent = [0, spec.shape[1] * hop / sample_rate, 0, sample_rate / 2 / 1000]
    ax.imshow(spec, origin="lower", aspect="auto", extent=extent, cmap="magma")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [kHz]")
    fig.tight_layout()
    return fig


def main(device="cuda") -> None:
    """The app; ``device`` is where the style transfer runs ("cuda"
    unless asked for "cpu")."""
    if not HAS_STREAMLIT:
        raise RuntimeError(
            "streamlit is not installed; run the CLI instead: "
            "python -m ddsp_tpu_torch.experiments.style_transfer content.wav style.wav out.wav"
        )
    import tempfile

    import torch

    from ddsp_tpu_torch.data.audio_io import read_wav, write_wav
    from ddsp_tpu_torch.device import resolve_device
    from ddsp_tpu_torch.experiments.style_transfer import (
        StyleTransferConfig,
        log_spectrogram,
        style_transfer_audio,
    )

    dev = resolve_device(device)

    def log_spec(audio: np.ndarray, conf) -> np.ndarray:
        return log_spectrogram(torch.as_tensor(audio, dtype=torch.float32, device=dev),
                               conf).cpu().numpy()

    st.title("ddsp_tpu_torch spectrogram style transfer")
    with st.sidebar:
        alpha = st.number_input("content weight (alpha)", value=1.0, format="%f")
        beta = st.number_input("style weight (beta)", value=1e13, format="%g")
        # the reference film_ui exposes the LBFGS lr (film_ui.py); 0 keeps
        # the adaptive zoom linesearch, > 0 = fixed torch-style step
        lr = st.number_input(
            "learning rate (0 = auto linesearch)", value=0.0, format="%f"
        )
        n_steps = int(st.number_input("optimizer steps", value=1000, step=50))
        kernel = int(st.number_input("conv kernel size", value=17, step=2))
        n_features = int(st.number_input("conv features", value=4096, step=256))
        n_fft = int(st.selectbox("window size", [512, 1024, 2048, 4096], index=2))
        hop = int(st.number_input("hop length", value=n_fft // 4))
        gl_iters = int(st.number_input("Griffin-Lim iterations", value=64, step=16))

    # Decode + normalize once per uploaded file, not on every slider rerun.
    @st.cache_data(show_spinner=False)
    def load_wav_bytes(data: bytes):
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(data)
            f.flush()
            audio, sr = read_wav(f.name)
        mono = audio.mean(0) if audio.shape[0] > 1 else audio[0]
        return normalize_audio(np.asarray(mono)), sr

    # Uploaders + trim sliders appear before the start button, as in the
    # reference's prepare_inputs (film_ui.py:28-33, helper.py:40-65).
    def prepare_inputs(name):
        upload = st.file_uploader(f"{name} audio (wav)", type=["wav"])
        if upload is None:
            return None, None
        mono, file_sr = load_wav_bytes(upload.getvalue())
        duration = len(mono) / file_sr
        if duration <= 0:
            st.warning(f"{name}: empty audio file")
            return None, None
        t0 = st.slider(f"{name} start [s]", 0.0, duration, 0.0)
        t1 = st.slider(f"{name} end [s]", t0, duration, duration)
        spec = log_spec(mono, StyleTransferConfig(n_fft=n_fft, hop=hop, sample_rate=file_sr))
        mono, spec = trim_to_times(mono, spec, file_sr, hop, t0, t1)
        if len(mono) < n_fft or spec.shape[1] == 0:
            st.warning(f"{name}: selection too short (needs >= {n_fft} samples)")
            return None, None
        # Trimmed previews, as the reference shows them (helper.py:56-63).
        st.audio(np.clip(mono, -1.0, 1.0), sample_rate=file_sr)
        st.image(
            spectrogram_image(spec),
            caption=f"trimmed {name} spectrogram",
            use_container_width=True,
        )
        return mono, file_sr

    content, sr = prepare_inputs("content")
    style, style_sr = prepare_inputs("style")
    if style is not None and sr is not None and style_sr != sr:
        # The reference decodes both files at one rate (helper.py:24,
        # librosa.load(sr=...)); here the style file is resampled to the
        # content file's rate instead of being silently mis-mapped.
        from ddsp_tpu_torch.ops.resample import resample

        style = resample(torch.as_tensor(style, dtype=torch.float32, device=dev)[None],
                         style_sr, sr)[0].cpu().numpy()

    if content is not None and style is not None and st.button("start"):
        conf = StyleTransferConfig(
            n_fft=n_fft, hop=hop, kernel_size=kernel, n_features=n_features,
            content_weight=alpha, style_weight=beta, n_steps=n_steps,
            learning_rate=lr, gl_iters=gl_iters, sample_rate=sr,
        )
        st.pyplot(spectrogram_figure(log_spec(content, conf), sr, hop))
        with st.spinner("optimizing..."):
            out, metrics = style_transfer_audio(content, style, conf, device=dev)
        st.write(metrics)
        st.pyplot(spectrogram_figure(log_spec(out, conf), sr, hop))
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            write_wav(f.name, out / max(1e-6, np.abs(out).max()) * 0.9, sr)
            wav = pathlib.Path(f.name).read_bytes()
        st.audio(wav, format="audio/wav")


if __name__ == "__main__":
    main()
