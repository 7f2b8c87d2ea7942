"""Metronome — transport-locked tick source with polyrhythm subdivisions.

Port of the reference metronome (ref src/generators/metronome.rs:1-379):
sample-accurate tick placement via the transport's beat-crossing offset,
BeatStrength pattern (Strong 2500 Hz/1.0, Medium 2000/0.7, Weak 1500/0.5,
Subdivision 2000/n/0.4; 100 ms exponential decay; Strong/Medium add a 15 ms
LCG white-noise click), per-beat polyrhythm subdivision counters phase-locked
to beat crossings, and tick-frame notification for onset echo suppression.

The per-sample Rust loop becomes per-buffer closed forms: the transport's
beat position advances once per callback, so crossings/subdivision spawn
positions within a buffer are arithmetic; active ticks render vectorized
(sin + decaying exponential envelope, LCG noise materialized per block).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..transport import MusicalTransport
from .generators import MIN_ENVELOPE, TWO_PI
from .sources import LcgNoise

BEAT_STRENGTHS = ("Strong", "Medium", "Weak", "None")


def _strength_params(strength) -> Optional[tuple]:
    """(freq, vol, decay_ms) per strength (ref metronome.rs:206-211)."""
    if strength == "Strong":
        return (2500.0, 1.0, 100.0)
    if strength == "Medium":
        return (2000.0, 0.7, 100.0)
    if strength == "Weak":
        return (1500.0, 0.5, 100.0)
    if isinstance(strength, tuple) and strength[0] == "Subdivision":
        n = max(float(strength[1]), 1.0)
        return (2000.0 / n, 0.4, 80.0)
    return None  # "None"


@dataclass
class _Tick:
    freq: float
    volume: float
    envelope: float
    decay_rate: float
    is_noise: bool
    phase: float          # sample counter (reference phase advances by 1)
    pending_delay: int
    noise: Optional[LcgNoise] = None

    def render(self, n: int, sample_rate: float) -> np.ndarray:
        """Render n samples, advancing envelope/phase state (vectorized)."""
        out = np.zeros(n, dtype=np.float32)
        start = min(self.pending_delay, n)
        self.pending_delay -= start
        m = n - start
        if m <= 0 or self.envelope <= MIN_ENVELOPE:
            return out
        t = np.arange(m, dtype=np.float64)
        env = self.envelope * np.power(self.decay_rate, t)
        if self.is_noise:
            sig = self.noise.next_block(m)
        else:
            phase_inc = self.freq * TWO_PI / sample_rate
            sig = np.sin((self.phase + t) * phase_inc).astype(np.float32)
            self.phase += m
        out[start:] = sig * np.float32(self.volume) * env.astype(np.float32)
        self.envelope = float(env[-1] * self.decay_rate)
        return out


class Metronome:
    """AudioSource metronome (commands mirror ref MetronomeCommand)."""

    def __init__(self, sample_rate: float, transport: MusicalTransport,
                 bpm: Optional[float] = None, pattern: Optional[list] = None,
                 polys: Optional[List[List[int]]] = None, volume: float = 1.0,
                 restart: bool = False):
        self.sample_rate = float(sample_rate)
        self.transport = transport
        self.volume = volume
        self.muted = False
        self.pattern = pattern or ["Strong", "Weak", "Weak", "Weak"]
        patt_len = len(self.pattern)
        polys = list(polys) if polys else []
        polys = (polys + [[] for _ in range(patt_len)])[:patt_len]
        self.beat_polyrhythms = polys
        bpm = bpm if bpm is not None else transport.get_bpm()
        self.samples_per_beat = int(self.sample_rate * 60.0 / max(bpm, 1.0))
        beats = transport.get_accumulated_beats()
        self.current_beat_index = int(max(beats, 0.0)) % patt_len if patt_len else 0
        self.active_subdivisions: List[List[int]] = []  # [div, counter]
        self.active_ticks: List[_Tick] = []
        self.finished = False
        self._commands: List[tuple] = []
        self.update_bpm(bpm)
        if restart:
            self.reset_beat()

    # ── control (ref metronome.rs:243-265) ──────────────────────────────

    def send(self, cmd: str, *args) -> bool:
        self._commands.append((cmd, *args))
        return True

    def _handle_commands(self):
        for cmd in self._commands:
            name = cmd[0]
            if name == "SetBpm":
                self.update_bpm(cmd[1])
            elif name == "SetVolume":
                self.volume = float(np.clip(cmd[1], 0.0, 2.0))
            elif name == "SetPattern":
                self.pattern = list(cmd[1])
                self.beat_polyrhythms = (self.beat_polyrhythms
                                         + [[] for _ in range(len(self.pattern))]
                                         )[:len(self.pattern)]
                if self.current_beat_index >= len(self.pattern):
                    self.current_beat_index = 0
            elif name == "SetPolyrhythm":
                divs, index = cmd[1], cmd[2]
                if 0 <= index < len(self.beat_polyrhythms):
                    self.beat_polyrhythms[index] = list(divs)
            elif name == "SetMuted":
                self.muted = bool(cmd[1])
            elif name == "Stop":
                self.finished = True
        self._commands.clear()

    def update_bpm(self, new_bpm: float):
        bpm = max(new_bpm, 1.0)
        self.samples_per_beat = int(self.sample_rate * 60.0 / bpm)
        self.transport.set_bpm(bpm)

    def reset_beat(self):
        """ref metronome.rs:166-186."""
        self.transport.seek_to_beat(0.0001)
        self.active_subdivisions.clear()
        self.active_ticks.clear()
        if self.pattern:
            strength = self.pattern[0]
            if strength != "None":
                self.transport.notify_tick_at_frame(
                    self.transport.get_output_frames())
                self._spawn_tick(strength, 0)
                self.current_beat_index = 0
                self._load_subdivisions()
            self.current_beat_index = 1 % len(self.pattern)

    def _load_subdivisions(self):
        self.active_subdivisions = [
            [div, 0] for div in
            (self.beat_polyrhythms[self.current_beat_index]
             if self.current_beat_index < len(self.beat_polyrhythms) else [])
            if div > 1]

    def _spawn_tick(self, strength, delay_samples: int):
        """ref metronome.rs:200-241."""
        if self.muted:
            return
        params = _strength_params(strength)
        if params is None:
            return
        freq, vol, decay_ms = params
        decay_samples = self.sample_rate * decay_ms / 1000.0
        decay_rate = MIN_ENVELOPE ** (1.0 / decay_samples)
        self.active_ticks.append(_Tick(freq, vol, 1.0, decay_rate, False,
                                       0.0, delay_samples))
        if strength in ("Strong", "Medium"):
            click_decay = MIN_ENVELOPE ** (1.0 / (self.sample_rate * 0.015))
            self.active_ticks.append(_Tick(0.0, vol * 0.5, 1.0, click_decay,
                                           True, 0.0, delay_samples,
                                           noise=LcgNoise(12345)))

    def is_finished(self) -> bool:
        return self.finished

    # ── rendering (ref metronome.rs:292-378) ────────────────────────────

    def process(self, buffer: np.ndarray, channels: int) -> None:
        self._handle_commands()
        if self.finished:
            return
        total_frames = len(buffer) // channels
        buffer_start_frame = self.transport.get_output_frames() - total_frames

        crossing = self.transport.did_cross_beat(total_frames)
        reset_offset = None
        if crossing is not None and self.pattern:
            patt_len = len(self.pattern)
            beat_idx = crossing.beat_number % patt_len
            strength = self.pattern[beat_idx]
            if strength != "None":
                click_frame = buffer_start_frame + crossing.sample_offset_in_buffer
                self.transport.notify_tick_at_frame(click_frame)
                self._spawn_tick(strength, crossing.sample_offset_in_buffer)
                self.current_beat_index = beat_idx
                reset_offset = crossing.sample_offset_in_buffer
            else:
                self.active_subdivisions.clear()

        # Subdivision counter advance (closed form over the buffer).
        if crossing is None:
            for sub in self.active_subdivisions:
                div, counter = sub
                sps = max(self.samples_per_beat // div, 1)
                # Spawn at samples p where counter+p+1 reaches sps (with wrap).
                # A BPM raise can shrink sps below an already-accumulated
                # counter; the reference's per-sample `counter >= sps` check
                # then fires immediately, so clamp to "now" rather than
                # spawning a negative delay (ref metronome.rs:334-349).
                first = max(sps - counter - 1, 0)
                p = first
                while p < total_frames:
                    self.transport.notify_tick_at_frame(buffer_start_frame + p)
                    self._spawn_tick(("Subdivision", div), p)
                    p += sps
                sub[1] = (counter + total_frames) % sps
        else:
            # Crossing buffer: counters reset at the crossing, no spawns
            # (ref metronome.rs:332-363).
            if reset_offset is not None:
                self._load_subdivisions()
                for sub in self.active_subdivisions:
                    div = sub[0]
                    sps = max(self.samples_per_beat // div, 1)
                    sub[1] = (total_frames - reset_offset) % sps
            else:
                for sub in self.active_subdivisions:
                    div, counter = sub
                    sps = max(self.samples_per_beat // div, 1)
                    sub[1] = (counter + total_frames) % sps

        # Render active ticks.
        mono = np.zeros(total_frames, dtype=np.float32)
        self.active_ticks = [t for t in self.active_ticks
                             if t.envelope > MIN_ENVELOPE or t.pending_delay > 0]
        for tick in self.active_ticks:
            mono += tick.render(total_frames, self.sample_rate)
        mono *= np.float32(self.volume)
        frames = buffer.reshape(total_frames, channels)
        frames += mono[:, None]
