"""Virtual audio device — the hardware-free cpal replacement.

The reference's biggest test weakness is that its integration tests need real
audio devices (SURVEY §4).  This device simulates the full duplex audio path
deterministically in sample-indexed time: an input source (silence, WAV,
generator, or pushed buffers) plays the microphone; the mixer renders output
sources; an optional loopback routes output back into the input with a
configurable latency — which is exactly what the onset detector's round-trip
latency self-calibration needs to be exercised without hardware
(ref src/audio_io/mod.rs:1055-1087, src/analysis/onset.rs:127-136).

Time advances in `buffer_size`-sample callbacks, mirroring the reference's
output/input callbacks (ref mod.rs:721-938).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np


class InputSource:
    """Pull-based mono input provider."""

    def next_block(self, n: int) -> np.ndarray:
        raise NotImplementedError


class SilenceSource(InputSource):
    def next_block(self, n: int) -> np.ndarray:
        return np.zeros(n, dtype=np.float32)


class ArraySource(InputSource):
    """Plays a fixed mono array, then silence."""

    def __init__(self, samples: np.ndarray):
        self.samples = np.asarray(samples, dtype=np.float32)
        self.pos = 0

    def next_block(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.float32)
        take = min(n, max(len(self.samples) - self.pos, 0))
        if take:
            out[:take] = self.samples[self.pos:self.pos + take]
            self.pos += take
        return out


def convert_to_f32(samples: np.ndarray) -> np.ndarray:
    """Sample-format conversion, cpal semantics (ref mod.rs:657-713 builds
    streams generic over f32/i16/u16): i16 maps /32768 (i16::MIN → -1.0),
    u16 is offset-binary (32768 → 0.0)."""
    samples = np.asarray(samples)
    if samples.dtype == np.float32:
        return samples
    if samples.dtype == np.int16:
        return samples.astype(np.float32) / np.float32(32768.0)
    if samples.dtype == np.uint16:
        return ((samples.astype(np.float32) - np.float32(32768.0))
                / np.float32(32768.0))
    raise ValueError(f"unsupported sample format {samples.dtype} "
                     "(expected float32, int16, or uint16)")


def downmix_interleaved(samples: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved multichannel → mono f32, the input callback's per-frame
    channel average (ref mod.rs:784-794 sums the frame's channels and
    divides by the channel count)."""
    mono = convert_to_f32(samples)
    if channels <= 1:
        return mono
    usable = (len(mono) // channels) * channels
    return mono[:usable].reshape(-1, channels).mean(axis=1,
                                                    dtype=np.float32)


class InterleavedSource(InputSource):
    """Raw-format input: interleaved i16/u16/f32 frames at any channel
    count, converted and downmixed to mono in the callback — the same math
    the reference's generic input streams run per buffer
    (ref mod.rs:657-806).  Plays the array, then silence."""

    def __init__(self, samples: np.ndarray, channels: int = 1):
        samples = np.asarray(samples)
        convert_to_f32(samples[:0])   # validate dtype eagerly
        self.samples = samples
        self.channels = max(int(channels), 1)
        self.pos = 0   # frame position

    def next_block(self, n: int) -> np.ndarray:
        total = len(self.samples) // self.channels
        take = min(n, max(total - self.pos, 0))
        out = np.zeros(n, dtype=np.float32)
        if take:
            lo = self.pos * self.channels
            block = self.samples[lo:lo + take * self.channels]
            out[:take] = downmix_interleaved(block, self.channels)
            self.pos += take
        return out


class PushSource(InputSource):
    """Caller-pushed audio (like a live microphone feed)."""

    def __init__(self):
        self._queue = deque()
        self._offset = 0

    def push(self, samples: np.ndarray, channels: int = 1) -> None:
        """Push interleaved audio in any supported format (f32/i16/u16,
        any channel count); converted + downmixed like the input callback
        (ref mod.rs:784-794)."""
        samples = np.asarray(samples)
        if samples.dtype == np.float64:   # convenience: plain Python floats
            samples = samples.astype(np.float32)
        self._queue.append(downmix_interleaved(samples, channels))

    def next_block(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.float32)
        filled = 0
        while filled < n and self._queue:
            head = self._queue[0]
            avail = len(head) - self._offset
            take = min(avail, n - filled)
            out[filled:filled + take] = head[self._offset:self._offset + take]
            filled += take
            self._offset += take
            if self._offset >= len(head):
                self._queue.popleft()
                self._offset = 0
        return out


class VirtualAudioDevice:
    """Duplex virtual device: per-buffer callbacks in sample-indexed time."""

    def __init__(self, sample_rate: float = 48000.0, buffer_size: int = 1024,
                 channels: int = 1,
                 input_source: Optional[InputSource] = None,
                 loopback_latency_samples: int = 0,
                 loopback_gain: float = 0.0):
        self.sample_rate = float(sample_rate)
        self.buffer_size = int(buffer_size)
        self.channels = int(channels)
        self.input_source = input_source or SilenceSource()
        self.loopback_latency = int(loopback_latency_samples)
        self.loopback_gain = float(loopback_gain)
        self._loopback_queue = np.zeros(self.loopback_latency, dtype=np.float32)
        self.input_running = False
        self.output_running = False
        self.input_callback: Optional[Callable[[np.ndarray], None]] = None
        self.output_callback: Optional[Callable[[np.ndarray], None]] = None
        self.samples_elapsed = 0

    def step(self) -> None:
        """One duplex callback cycle of `buffer_size` frames."""
        n = self.buffer_size
        out_mono = np.zeros(n, dtype=np.float32)
        if self.output_running and self.output_callback is not None:
            buf = np.zeros(n * self.channels, dtype=np.float32)
            self.output_callback(buf)
            out_mono = buf.reshape(n, self.channels).mean(axis=1)

        if self.input_running and self.input_callback is not None:
            mic = self.input_source.next_block(n)
            if self.loopback_gain != 0.0:
                self._loopback_queue = np.concatenate(
                    [self._loopback_queue, out_mono * self.loopback_gain])
                mic = mic + self._loopback_queue[:n]
                self._loopback_queue = self._loopback_queue[n:]
            self.input_callback(mic.astype(np.float32))

        self.samples_elapsed += n

    def advance(self, seconds: float) -> None:
        for _ in range(int(round(seconds * self.sample_rate)) // self.buffer_size):
            self.step()
