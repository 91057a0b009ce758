"""Audio file I/O: WAV with numpy only, compressed audio through an
optional backend.

A copy of ``ddsp_tpu/data/audio_io.py``.  WAV (PCM 8/16/24/32,
float32/float64) is parsed here.  mp3 / ogg / flac decode through the first
importable backend -- soundfile, torchaudio, librosa, or pygame/SDL_mixer
at the native rate parsed from the container header -- and raise
:class:`UnsupportedAudioFormat` naming the file and the backends when none
is installed.
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


def have_compressed_backend() -> bool:
    """True if an optional decoder for mp3/ogg/flac is importable."""
    import importlib.util

    def usable(m):
        try:
            return importlib.util.find_spec(m) is not None
        except (ImportError, ValueError):
            # find_spec raises ValueError for an in-sys.modules module
            # whose __spec__ is None (a test stub): not a backend
            return False

    return any(usable(m) for m in ("soundfile", "torchaudio", "librosa", "pygame"))


# MPEG audio sample rates indexed by [version bits][rate bits]; version bits:
# 0 = MPEG-2.5, 2 = MPEG-2, 3 = MPEG-1 (1 is reserved).
_MPEG_RATES = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000), 0: (11025, 12000, 8000)}


def _id3_end(head: bytes) -> int:
    """Where the audio of an mp3 starts past a leading ID3v2 tag (its
    sync-safe size), or 0 without one."""
    if head[:3] != b"ID3" or len(head) < 10:
        return 0
    return 10 + (((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14)
                 | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F))


def probe_mp3(data: bytes) -> Tuple[int, int]:
    """(sample_rate, channels) from the first valid MPEG audio frame header.

    Skips a leading ID3v2 tag, then scans for the 11-bit frame sync.
    Raises :class:`UnsupportedAudioFormat` if no frame is found.
    """
    pos = _id3_end(data)
    end = min(len(data) - 3, pos + (1 << 20))  # sync must appear within ~1 MB
    while pos < end:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            version = (data[pos + 1] >> 3) & 3
            layer = (data[pos + 1] >> 1) & 3
            rate_idx = (data[pos + 2] >> 2) & 3
            mode = (data[pos + 3] >> 6) & 3
            if version != 1 and layer != 0 and rate_idx != 3:
                return _MPEG_RATES[version][rate_idx], 1 if mode == 3 else 2
        pos += 1
    raise UnsupportedAudioFormat("no MPEG audio frame header found")


def probe_ogg_vorbis(data: bytes) -> Tuple[int, int]:
    """(sample_rate, channels) from the Vorbis identification header: the
    marker ``\\x01vorbis``, then version (u32), channels (u8), rate (u32le)."""
    i = data.find(b"\x01vorbis", 0, 1 << 16)
    if data[:4] != b"OggS" or i < 0 or i + 16 > len(data):
        raise UnsupportedAudioFormat("no Ogg Vorbis identification header found")
    channels = data[i + 11]
    rate = struct.unpack("<I", data[i + 12 : i + 16])[0]
    return rate, channels


def probe_flac(data: bytes) -> Tuple[int, int]:
    """(sample_rate, channels) from the FLAC STREAMINFO block."""
    if data[:4] != b"fLaC" or len(data) < 26:
        raise UnsupportedAudioFormat("not a FLAC stream")
    b = data[8:]  # STREAMINFO body (the first metadata block is mandatory)
    rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4)
    channels = ((b[12] >> 1) & 7) + 1
    return rate, channels


def _probe_compressed(data: bytes) -> Tuple[int, int]:
    if data[:4] == b"OggS":
        return probe_ogg_vorbis(data)
    if data[:4] == b"fLaC":
        return probe_flac(data)
    return probe_mp3(data)


def read_via_pygame(path: str) -> Tuple[np.ndarray, int]:
    """Decode mp3/ogg/flac through pygame's SDL_mixer at the file's native
    rate: the (rate, channels) are parsed from the container header and the
    mixer (on SDL's dummy audio driver) is opened to match, so nothing is
    resampled; the decoder's int16 output is scaled to float32."""
    import os

    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    try:
        import pygame
    except ImportError as e:
        raise UnsupportedAudioFormat(f"{path}: pygame backend unavailable: {e}")

    with open(path, "rb") as f:
        head = f.read(1 << 20)
        # an ID3v2 tag can outgrow the probe head (embedded album art):
        # read on past the tag, clamped to the file, plus a scan margin
        tag_end = min(_id3_end(head), os.path.getsize(path))
        if tag_end and tag_end + (1 << 16) > len(head):
            f.seek(0)
            head = f.read(tag_end + (1 << 16))
    rate, channels = _probe_compressed(head)

    init = pygame.mixer.get_init()
    if init != (rate, -16, channels):
        if init is not None:
            pygame.mixer.quit()
        pygame.mixer.init(frequency=rate, size=-16, channels=channels, buffer=512)
    try:
        arr = pygame.sndarray.array(pygame.mixer.Sound(path))
    except pygame.error as e:
        raise UnsupportedAudioFormat(f"{path}: SDL_mixer could not decode: {e}")
    x = np.asarray(arr, np.float32) / 32768.0
    x = x[None, :] if x.ndim == 1 else x.T
    return np.ascontiguousarray(x), rate


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read any supported audio file -> ((channels, samples) float32, rate).

    WAV is decoded here; other formats go through the first backend that
    imports (soundfile, torchaudio, librosa, pygame), and raise
    :class:`UnsupportedAudioFormat` when none is installed.
    """
    if path.lower().endswith(".wav"):
        return read_wav(path)
    try:
        import soundfile

        data, sr = soundfile.read(path, dtype="float32", always_2d=True)
        return np.ascontiguousarray(data.T), int(sr)
    except ImportError:
        pass
    try:
        import torchaudio

        wav, sr = torchaudio.load(path)
        return wav.numpy().astype(np.float32), int(sr)
    except ImportError:
        pass
    try:
        import librosa

        y, sr = librosa.load(path, sr=None, mono=False)
        y = y[None, :] if y.ndim == 1 else y
        return y.astype(np.float32), int(sr)
    except ImportError:
        pass
    try:
        import pygame  # noqa: F401 -- the SDL_mixer decoder

        return read_via_pygame(path)
    except ImportError:
        pass
    raise UnsupportedAudioFormat(
        f"{path}: compressed audio needs soundfile/torchaudio/librosa/pygame "
        "(none installed); convert to wav"
    )


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
