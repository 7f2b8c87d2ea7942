"""AudioSource protocol + Mixer for the virtual output device.

Mirrors the reference's output path (trait AudioSource, ref src/traits.rs:1-7;
Mixer, ref src/audio_io/output.rs:1-69): sources render additively into the
output buffer, finished sources are dropped, the sum is clamped to ±1.
Rendering here is per-buffer vectorized NumPy (the reference renders
per-sample in the audio callback); the buffer is the scheduling quantum, as
it is for the reference's transport (beats advance once per callback).
"""

from __future__ import annotations

import threading
from typing import List, Protocol

import numpy as np


class AudioSource(Protocol):
    def process(self, buffer: np.ndarray, channels: int) -> None:
        """Render into `buffer` ([frames*channels] float32), additively."""
        ...

    def is_finished(self) -> bool:
        ...


class Mixer:
    """Sums AudioSources, drops finished ones, clamps ±1 (ref output.rs:26-46)."""

    def __init__(self, channels: int):
        self.channels = channels
        self.sources: List[AudioSource] = []
        self._lock = threading.Lock()

    def add_source(self, source: AudioSource) -> None:
        with self._lock:
            self.sources.append(source)

    def has_sources(self) -> bool:
        with self._lock:
            return len(self.sources) > 0

    def process(self, out_buffer: np.ndarray, channels: int) -> None:
        with self._lock:
            self.sources = [s for s in self.sources if not s.is_finished()]
            out_buffer[:] = 0.0
            scratch = np.zeros_like(out_buffer)
            for source in self.sources:
                scratch[:] = 0.0
                source.process(scratch, channels)
                out_buffer += scratch
            np.clip(out_buffer, -1.0, 1.0, out=out_buffer)


class OutputController:
    """Lightweight mixer handle (ref output.rs:49-69)."""

    def __init__(self, mixer: Mixer):
        self._mixer = mixer

    def add_source(self, source: AudioSource) -> None:
        self._mixer.add_source(source)

    def has_sources(self) -> bool:
        return self._mixer.has_sources()


class LcgNoise:
    """Streaming bit-exact reference LCG (ref metronome.rs:56-58),
    vectorized per block via jump-doubling (models/generators.lcg_states)."""

    def __init__(self, seed: int = 12345):
        self.state = seed

    def next_block(self, n: int) -> np.ndarray:
        from .generators import lcg_states
        states = lcg_states(n, self.state)
        if n > 0:
            self.state = int(states[-1])
        return (states.astype(np.float32) / np.float32(2147483648.0)
                - np.float32(1.0)).astype(np.float32)
