"""WAV read/write with numpy only (PCM 8/16/24/32, float32/float64).

A copy of the WAV part of ``ddsp_tpu/data/audio_io.py``; compressed
formats are not decoded here and raise with a request to convert to wav.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


class UnsupportedAudioFormat(ValueError):
    pass


def _to_float(x: np.ndarray, scale: float) -> np.ndarray:
    return (x / scale).astype(np.float32)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> ((channels, samples) float32 in [-1, 1], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise UnsupportedAudioFormat(f"{path}: not a WAV file; convert to wav")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise UnsupportedAudioFormat(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: tag in the GUID
        if len(fmt_body) < 26:
            raise UnsupportedAudioFormat(
                f"{path}: WAVE_FORMAT_EXTENSIBLE with truncated fmt extension"
            )
        audio_format = struct.unpack("<H", fmt_body[24:26])[0]
    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = _to_float(np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0, 127.0)
        elif bits == 16:
            x = _to_float(np.frombuffer(raw, "<i2").astype(np.float32), 32768.0)
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
            x = _to_float(i32.astype(np.float32), float(1 << 23))
        elif bits == 32:
            x = _to_float(np.frombuffer(raw, "<i4").astype(np.float32), float(1 << 31))
        else:
            raise UnsupportedAudioFormat(f"{path}: {bits}-bit PCM")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise UnsupportedAudioFormat(
            f"{path}: WAV format tag {audio_format} (only PCM/float supported)"
        )
    if n_channels > 1:
        x = x[: len(x) - len(x) % n_channels].reshape(-1, n_channels).T
    else:
        x = x[None, :]
    return np.ascontiguousarray(x), sample_rate


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """WAV files only: ((channels, samples) float32, rate)."""
    if not path.lower().endswith(".wav"):
        raise UnsupportedAudioFormat(
            f"{path}: compressed audio is not decoded by ddsp_tpu_torch; "
            "convert to wav"
        )
    return read_wav(path)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio (samples,) or (channels, samples) as 16-bit PCM."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_channels, _ = audio.shape
    pcm = np.clip(audio.T * 32767.0, -32768, 32767).astype("<i2").tobytes()
    byte_rate = sample_rate * n_channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate,
                            byte_rate, n_channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
