"""Polyphonic synthesizer + MIDI sequencer AudioSource.

Port of the reference synth (ref src/generators/synth.rs:1-488): Voice =
oscillator (piano: sine + bright 2f+ramp mix 0.8; violin/voice: sine +
triangle mix 0.4) x linear ADSR (per-instrument params; envelope compressed
to fit short notes), transport-locked sequencer with count-in and per-measure
metronome BPM/pattern sync, NoteOn idempotency for drones, and 1/sqrt(n)
polyphony normalization.

Per-buffer vectorization note: the reference reads the transport's beat
position every sample, but that value only changes once per output callback
(tick_output runs at the top of the callback) — so sequencer triggers and
measure-boundary syncs are buffer-rate events, rendered here in closed form.
Envelopes are piecewise-linear segments computed analytically per buffer.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..transport import MusicalTransport
from ..utils.midi import MAX_MIDI_VELOCITY, Measure, load_midi_file
from .generators import TWO_PI

INSTRUMENT_PARAMS = {
    # (attack_sec, decay_sec, sustain_level, release_sec, timbre_mix)
    # ref synth.rs:48-72
    "Piano":  (0.005, 0.15, 0.6, 0.7, 0.8),
    "Violin": (0.3, 0.1, 0.9, 0.5, 0.4),
    "Voice":  (0.3, 0.1, 0.9, 0.5, 0.4),
}

ATTACK, DECAY, SUSTAIN, RELEASE, FINISHED = range(5)


def instrument_from(name: str) -> str:
    """Lenient instrument parsing (ref generators/mod.rs:30-41)."""
    n = name.lower()
    if n == "piano":
        return "Piano"
    if n == "violin":
        return "Violin"
    if n == "voice":
        return "Voice"
    raise ValueError(f"Instrument '{n}' is unavailable")


class Voice:
    """One synth voice (ref synth.rs:34-201)."""

    def __init__(self, freq: float, velocity: float,
                 duration_beats: Optional[float], instrument: str,
                 bpm: Optional[float]):
        a, d, s, r, mix = INSTRUMENT_PARAMS[instrument]
        if duration_beats is not None and bpm is not None:
            dur_secs = duration_beats * 60.0 / bpm
            natural = a + d + r
            if natural <= dur_secs:
                self.remaining_beats = (dur_secs - natural) * bpm / 60.0
            else:
                scale = dur_secs / natural
                a, d, r = a * scale, d * scale, r * scale
                self.remaining_beats = 0.0
        else:
            self.remaining_beats = duration_beats  # None = manual sustain
        self.attack_sec, self.decay_sec = a, d
        self.sustain_level, self.release_sec = s, r
        self.timbre_mix = mix
        self.freq = freq
        self.velocity = velocity
        self.instrument = instrument
        self.phase = 0.0
        self.envelope = 0.0
        self.state = ATTACK

    def _osc(self, phases: np.ndarray) -> np.ndarray:
        """Oscillator over a phase array in [0, 2pi) (ref synth.rs:129-147)."""
        fund = np.sin(phases)
        mix = self.timbre_mix
        if self.instrument == "Piano":
            bright = (np.sin(phases * 2.0) + phases / np.pi - 1.0) * 0.5
            return (fund * (1.0 - mix) + bright * mix).astype(np.float32)
        t = phases / TWO_PI
        tri = 4.0 * np.abs(t - 0.5) - 1.0
        return (fund * (1.0 - mix) + tri * mix).astype(np.float32)

    def render(self, n: int, sample_rate: float, beats_per_sample: float):
        """Render n samples; returns (signal [n], active_mask [n] bool)."""
        if self.state == FINISHED:
            return (np.zeros(n, dtype=np.float32),
                    np.zeros(n, dtype=bool))
        inv_sr = 1.0 / sample_rate
        phase_inc = self.freq * TWO_PI * inv_sr
        # Phase advances first each sample (ref synth.rs:126-127).
        phases = np.mod(self.phase + phase_inc * np.arange(1, n + 1), TWO_PI)
        self.phase = float(phases[-1])
        sig = self._osc(phases)

        # Piecewise-linear envelope (ref synth.rs:150-198).
        env = np.empty(n, dtype=np.float64)
        pos = 0
        e = self.envelope
        st = self.state
        rem = self.remaining_beats
        attack_rate = inv_sr / max(self.attack_sec, 0.001)
        decay_rate = (1.0 - self.sustain_level) * inv_sr / max(self.decay_sec, 0.001)
        release_rate = self.sustain_level * inv_sr / max(self.release_sec, 0.001)
        while pos < n:
            left = n - pos
            if st == ATTACK:
                k = max(int(math.ceil((1.0 - e) / attack_rate)), 1)
                seg = min(k, left)
                traj = e + attack_rate * np.arange(1, seg + 1)
                if traj[-1] >= 1.0:
                    hit = int(np.argmax(traj >= 1.0))
                    traj[hit:] = 1.0
                    if pos + hit + 1 <= n:
                        env[pos:pos + seg] = traj
                        e = 1.0
                        st = DECAY
                        pos += hit + 1
                        continue
                env[pos:pos + seg] = traj
                e = float(traj[-1])
                pos += seg
            elif st == DECAY:
                k = max(int(math.ceil((e - self.sustain_level) / max(decay_rate, 1e-12))), 1)
                seg = min(k, left)
                traj = e - decay_rate * np.arange(1, seg + 1)
                if traj[-1] <= self.sustain_level:
                    hit = int(np.argmax(traj <= self.sustain_level))
                    traj[hit:] = self.sustain_level
                    env[pos:pos + seg] = traj
                    e = self.sustain_level
                    st = SUSTAIN
                    pos += hit + 1
                    continue
                env[pos:pos + seg] = traj
                e = float(traj[-1])
                pos += seg
            elif st == SUSTAIN:
                if rem is None:
                    env[pos:] = e
                    pos = n
                else:
                    k = max(int(math.ceil(rem / max(beats_per_sample, 1e-12))), 1)
                    seg = min(k, left)
                    env[pos:pos + seg] = e
                    rem -= beats_per_sample * seg
                    pos += seg
                    if rem <= 0.0:
                        st = RELEASE
            else:  # RELEASE
                k = max(int(math.ceil(e / max(release_rate, 1e-12))), 1)
                seg = min(k, left)
                traj = e - release_rate * np.arange(1, seg + 1)
                if traj[-1] <= 0.0:
                    hit = int(np.argmax(traj <= 0.0))
                    traj[hit:] = 0.0
                    env[pos:pos + seg] = traj
                    e = 0.0
                    pos += hit + 1
                    st = FINISHED
                    env[pos:] = 0.0
                    pos = n
                    continue
                env[pos:pos + seg] = traj
                e = float(traj[-1])
                pos += seg
        self.envelope = e
        self.state = st
        self.remaining_beats = rem
        # Active per sample = state not yet Finished = envelope still > 0
        # (the finishing sample itself is not counted, matching the
        # post-process count in ref synth.rs:458-463).
        active = env > 0.0
        return (sig * env.astype(np.float32) * np.float32(self.velocity),
                active)


class Synthesizer:
    """AudioSource synthesizer + sequencer (ref synth.rs:203-488)."""

    def __init__(self, sample_rate: float, transport: MusicalTransport):
        self.sample_rate = float(sample_rate)
        self.transport = transport
        self.volume = 0.5
        self.voices: List[Voice] = []
        self.muted = False
        self.measures: List[Measure] = []
        self.is_playing_seq = False
        self.current_measure_index = 0
        self.playback_cursor = 0.0
        self.start_measure_global_offset = 0.0
        self.count_in_duration = 0.0
        self.metronome = None          # linked Metronome (optional)
        self.finished = False
        self._commands: List[tuple] = []

    def send(self, cmd: str, *args) -> bool:
        self._commands.append((cmd, *args))
        return True

    def _sync_metronome(self, measure_idx: int):
        if self.metronome is not None and measure_idx < len(self.measures):
            m = self.measures[measure_idx]
            self.metronome.send("SetBpm", m.bpm)
            self.metronome.send("SetPattern", m.get_pattern())
            self.transport.set_bpm(m.bpm)

    def _handle_commands(self):
        for cmd in self._commands:
            name = cmd[0]
            if name == "LinkMetronome":
                self.metronome = cmd[1]
            elif name == "LoadFile":
                path, instrument = cmd[1], cmd[2]
                try:
                    self.measures = load_midi_file(path, instrument)
                    self.is_playing_seq = False
                    self.voices.clear()
                except (OSError, ValueError):
                    pass
            elif name == "LoadMeasures":
                self.measures = list(cmd[1])
                self.is_playing_seq = False
                self.voices.clear()
            elif name == "Clear":
                self.measures = []
                self.voices.clear()
                self.is_playing_seq = False
            elif name == "SetVolume":
                self.volume = float(np.clip(cmd[1], 0.0, 2.0))
            elif name == "NoteOn":
                freq, velocity, instrument = cmd[1], cmd[2], cmd[3]
                already = any(abs(v.freq - freq) < 0.1
                              and v.state not in (RELEASE, FINISHED)
                              for v in self.voices)
                if not already:
                    for v in self.voices:
                        if abs(v.freq - freq) < 0.1 and v.state != FINISHED:
                            v.state = RELEASE
                    self.voices.append(Voice(freq, velocity / MAX_MIDI_VELOCITY,
                                             None, instrument, None))
            elif name == "NoteOff":
                for v in self.voices:
                    if abs(v.freq - cmd[1]) < 0.1:
                        v.state = RELEASE
            elif name == "Play":
                idx = cmd[1]
                if 0 <= idx < len(self.measures):
                    start = self.measures[idx]
                    self.start_measure_global_offset = start.global_start_beat
                    self.count_in_duration = start.duration_beats()
                    self.transport.seek_to_beat(-self.count_in_duration)
                    self.transport.play()
                    self.playback_cursor = -self.count_in_duration
                    self._sync_metronome(idx)
                    self.current_measure_index = idx
                    self.is_playing_seq = True
            elif name == "Pause":
                self.is_playing_seq = False
            elif name == "Resume":
                self.is_playing_seq = True
            elif name == "Stop":
                self.is_playing_seq = False
                self.voices.clear()
                self.playback_cursor = 0.0
                self.transport.seek_to_beat(0.0)
            elif name == "SetMuted":
                self.muted = bool(cmd[1])
            elif name == "End":
                self.finished = True
        self._commands.clear()

    def is_finished(self) -> bool:
        return self.finished

    def process(self, buffer: np.ndarray, channels: int) -> None:
        self._handle_commands()
        if self.finished:
            return
        total_frames = len(buffer) // channels
        bpm = self.transport.get_bpm()
        beats_per_sample = (bpm / 60.0) / self.sample_rate

        if self.is_playing_seq:
            prev_cursor = self.playback_cursor
            curr_cursor = self.transport.get_accumulated_beats()
            self.playback_cursor = curr_cursor

            if curr_cursor < 0.0:
                if self.metronome is not None:
                    self.metronome.send("SetMuted", False)
            else:
                # Measure boundary advance (catch up if cursor jumped).
                while self.current_measure_index < len(self.measures):
                    m = self.measures[self.current_measure_index]
                    measure_end = m.global_start_beat + m.duration_beats()
                    abs_time = curr_cursor + self.start_measure_global_offset
                    if abs_time >= measure_end:
                        self.current_measure_index += 1
                        self._sync_metronome(self.current_measure_index)
                    else:
                        break

            if curr_cursor >= 0.0 and self.current_measure_index < len(self.measures):
                m = self.measures[self.current_measure_index]
                beat_in_measure = (curr_cursor + self.start_measure_global_offset
                                   - m.global_start_beat)
                prev_in_measure = (prev_cursor + self.start_measure_global_offset
                                   - m.global_start_beat)
                for note in m.notes:
                    if prev_in_measure < note.start_beat_in_measure <= beat_in_measure:
                        velocity = 0.0 if self.muted else note.velocity
                        self.voices.append(Voice(note.freq, velocity,
                                                 note.duration_beats,
                                                 note.instrument, bpm))
        else:
            if self.metronome is not None:
                self.metronome.send("SetMuted", True)

        # Vectorized voice render + per-sample 1/sqrt(n) normalization.
        total = np.zeros(total_frames, dtype=np.float32)
        active_count = np.zeros(total_frames, dtype=np.float32)
        for v in self.voices:
            sig, active = v.render(total_frames, self.sample_rate,
                                   beats_per_sample)
            total += sig
            active_count += active.astype(np.float32)
        norm = np.where(active_count > 1.0,
                        1.0 / np.sqrt(np.maximum(active_count, 1.0)), 1.0)
        mono = (total * norm * np.float32(self.volume)).astype(np.float32)
        frames = buffer.reshape(total_frames, channels)
        frames += mono[:, None]
        self.voices = [v for v in self.voices if v.state != FINISHED]
