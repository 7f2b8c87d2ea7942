"""WAV read/write without external deps.

Replaces the reference's `hound` (writer, ref src/audio_io/recorder.rs:61-105)
and `symphonia` (decoder, ref src/generators/player.rs:171-232) for the WAV
case.  Reading returns interleaved float32; `downmix_mono` mirrors the input
callback's ≤2-channel averaging downmix (ref src/audio_io/mod.rs:784-794).
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a WAV file → (interleaved float32 samples, sample_rate, channels)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        data = i32.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    return data, sr, channels


def read_wav_float(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a WAV, supporting IEEE-float chunks hound/symphonia would decode."""
    try:
        return read_wav(path)
    except wave.Error:
        # Minimal RIFF parse for format-3 (IEEE float) files stdlib rejects.
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        pos, fmt, data = 12, None, None
        while pos + 8 <= len(blob):
            cid, sz = blob[pos:pos + 4], struct.unpack("<I", blob[pos + 4:pos + 8])[0]
            body = blob[pos + 8:pos + 8 + sz]
            if cid == b"fmt ":
                if len(body) < 16:
                    raise ValueError(f"malformed WAV fmt chunk: {path}")
                fmt = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                data = body
            pos += 8 + sz + (sz & 1)
        if fmt is None or data is None:
            raise ValueError(f"malformed WAV (missing fmt/data): {path}")
        audio_fmt, channels, sr, _, _, bits = fmt
        if audio_fmt == 3 and bits == 32:
            samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif audio_fmt == 1 and bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        else:
            raise ValueError(f"Unsupported WAV format {audio_fmt}/{bits}")
        return samples, sr, channels


def downmix_mono(samples: np.ndarray, channels: int) -> np.ndarray:
    """Average ≤2 channels to mono (ref src/audio_io/mod.rs:764,784-794)."""
    if channels == 1:
        return samples.astype(np.float32)
    frames = samples.reshape(-1, channels)
    use = min(channels, 2)
    return frames[:, :use].sum(axis=1, dtype=np.float32) / np.float32(use)


def quantize_i16(samples: np.ndarray) -> np.ndarray:
    """Float→i16 with the recorder's clamp+scale (ref recorder.rs:83)."""
    s = np.clip(samples, -1.0, 1.0).astype(np.float32)
    return (s * np.float32(np.iinfo(np.int16).max)).astype(np.int16)


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              channels: int = 1) -> None:
    """Write 16-bit mono/stereo WAV like the reference recorder."""
    i16 = quantize_i16(np.asarray(samples, dtype=np.float32))
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(i16.tobytes())
