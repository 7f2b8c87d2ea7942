"""MusicalTransport — sample-accurate musical clock.

Behavioral parity with the reference `src/audio_io/timing.rs:1-787`.  The
reference is an all-atomic lock-free struct read from a realtime audio thread;
here time is deterministic and sample-indexed (driven by the virtual audio
device in `api/`), so plain Python attributes (guarded by the GIL, plus a
lock for the threaded realtime simulation mode) are sufficient.  All beat
math is f64, bpm/sample_rate are f32 — matching the Rust storage types.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np

# ref timing.rs:12 — assumed UI bridge latency in seconds.
DEFAULT_UI_LATENCY_S = 0.04

_TICK_HISTORY_LEN = 8  # ref timing.rs:134


@dataclass
class TransportSnapshot:
    """Frozen transport state for the polling bridge (ref timing.rs:26-67)."""
    beat_position: float
    bpm: float
    is_playing: bool
    output_frames: int
    input_frames: int
    drift_samples: int
    display_beat_position: float
    ui_latency_compensation_s: float
    current_beat: int
    beat_phase: float
    input_latency_samples: int
    capture_time_s: float

    def to_dict(self) -> dict:
        return {
            "beat_position": self.beat_position,
            "bpm": self.bpm,
            "is_playing": self.is_playing,
            "output_frames": self.output_frames,
            "input_frames": self.input_frames,
            "drift_samples": self.drift_samples,
            "display_beat_position": self.display_beat_position,
            "ui_latency_compensation_s": self.ui_latency_compensation_s,
            "current_beat": self.current_beat,
            "beat_phase": self.beat_phase,
            "input_latency_samples": self.input_latency_samples,
            "capture_time_s": self.capture_time_s,
        }


@dataclass
class OnsetEvent:
    """A detected onset timestamped in beats (ref timing.rs:78-87)."""
    beat_position: float
    raw_sample_offset: int
    output_samples: int
    velocity: float


@dataclass
class BeatCrossing:
    """Beat boundary crossed within an output buffer (ref timing.rs:641-648)."""
    beat_number: int
    sample_offset_in_buffer: int


class MusicalTransport:
    """Single source of musical truth: frames, beats, latency compensation."""

    def __init__(self, initial_bpm: float, sample_rate: float):
        self._lock = threading.RLock()
        self.output_frames = 0
        self.input_frames = 0
        self.last_tick_output_frame = -(2 ** 62)
        self._tick_history_beats = [float("-inf")] * _TICK_HISTORY_LEN
        self._tick_history_count = 0
        self._bpm = float(np.float32(initial_bpm))
        self._accumulated_beats = 0.0
        self._is_playing = False
        self._output_latency_samples = 0
        self._input_latency_samples = 0
        self._calibration_offset_samples = 0
        self._calibration_done = False
        self._ui_latency_s = DEFAULT_UI_LATENCY_S
        self._sample_rate = float(np.float32(sample_rate))
        self._capture_time_s = 0.0

    # ── audio-thread tick methods (ref timing.rs:217-296) ───────────────

    def tick_output(self, frames: int, callback_time_s: float) -> None:
        with self._lock:
            self._capture_time_s = callback_time_s
            self.output_frames += frames
            if not self._is_playing:
                return
            seconds = frames / self._sample_rate
            self._accumulated_beats += seconds * (self._bpm / 60.0)

    def tick_input(self, frames: int) -> None:
        with self._lock:
            self.input_frames += frames

    def notify_tick(self) -> None:
        with self._lock:
            self.last_tick_output_frame = self.output_frames

    def notify_tick_at_frame(self, click_output_frame: int) -> None:
        with self._lock:
            self.last_tick_output_frame = click_output_frame
            beats_per_sample = self._bpm / (60.0 * self._sample_rate)
            beat = click_output_frame * beats_per_sample
            idx = self._tick_history_count % _TICK_HISTORY_LEN
            self._tick_history_count += 1
            self._tick_history_beats[idx] = beat

    def nearest_tick_distance_beats(self, beat: float) -> float:
        with self._lock:
            dists = [abs(beat - t) for t in self._tick_history_beats
                     if math.isfinite(t)]
        return min(dists) if dists else float("inf")

    def tick_history_snapshot(self) -> np.ndarray:
        """The finite entries of the tick-history ring, under one lock —
        for vectorized per-burst tick suppression (the onset consumer
        computes a whole burst's distances in one numpy pass instead of
        2 locked calls per frame; api/engine.py _tick_suppression)."""
        with self._lock:
            return np.array([t for t in self._tick_history_beats
                             if math.isfinite(t)], dtype=np.float64)

    # ── onset alignment (ref timing.rs:311-350) ─────────────────────────

    def stamp_onset(self, sample_offset: int, velocity: float) -> OnsetEvent:
        with self._lock:
            beats_per_sample = self._bpm / (60.0 * self._sample_rate)
            input_lat = self._input_latency_samples
            output_lat = self._output_latency_samples
            calibration = self._calibration_offset_samples
            current_beats = self._accumulated_beats
            latency_beats = (input_lat + output_lat) * beats_per_sample
            offset_beats = sample_offset * beats_per_sample
            calibration_beats = calibration * beats_per_sample
            compensated = (current_beats - latency_beats + offset_beats
                           - calibration_beats)
            return OnsetEvent(
                beat_position=compensated,
                raw_sample_offset=sample_offset,
                output_samples=(self.output_frames - input_lat - output_lat
                                + sample_offset - calibration),
                velocity=velocity,
            )

    def anchor(self) -> dict:
        """Freeze every stamping-relevant clock field at THIS instant.

        The fused streaming path defers host-side event stamping by
        `pipeline_depth` slots (api/engine.py); stamping against the anchor
        captured at consume time makes deferred posts bit-identical to
        synchronous ones — including `raw_sample_offset` and under BPM
        changes or transport pauses between consume and post (the reference
        stamps from free-running threads, ref timing.rs:311-337; the anchor
        is the deterministic twin of 'the clock as the thread saw it')."""
        with self._lock:
            return {"bpm": self._bpm,
                    "beats": self._accumulated_beats,
                    "output_frames": self.output_frames,
                    "input_frames": self.input_frames,
                    "input_lat": self._input_latency_samples,
                    "output_lat": self._output_latency_samples,
                    "calibration": self._calibration_offset_samples}

    def stamp_onset_anchored(self, anchor: dict, sample_offset: int,
                             velocity: float) -> OnsetEvent:
        """`stamp_onset` math against a frozen `anchor()` snapshot."""
        beats_per_sample = anchor["bpm"] / (60.0 * self._sample_rate)
        latency_beats = ((anchor["input_lat"] + anchor["output_lat"])
                         * beats_per_sample)
        offset_beats = sample_offset * beats_per_sample
        calibration_beats = anchor["calibration"] * beats_per_sample
        return OnsetEvent(
            beat_position=(anchor["beats"] - latency_beats + offset_beats
                           - calibration_beats),
            raw_sample_offset=sample_offset,
            output_samples=(anchor["output_frames"] - anchor["input_lat"]
                            - anchor["output_lat"] + sample_offset
                            - anchor["calibration"]),
            velocity=velocity,
        )

    def calibrated_beat(self, beat_position: float) -> float:
        with self._lock:
            beats_per_sample = self._bpm / (60.0 * self._sample_rate)
            latency_beats = ((self._input_latency_samples
                              + self._output_latency_samples) * beats_per_sample)
            calibration_beats = self._calibration_offset_samples * beats_per_sample
            return beat_position - latency_beats - calibration_beats

    # ── snapshot (ref timing.rs:361-402) ────────────────────────────────

    def snapshot(self) -> TransportSnapshot:
        with self._lock:
            beat_pos = self._accumulated_beats
            output_latency_s = self._output_latency_samples / self._sample_rate
            total_visual_delay_s = output_latency_s + self._ui_latency_s
            total_visual_delay_beats = total_visual_delay_s * (self._bpm / 60.0)
            return TransportSnapshot(
                beat_position=beat_pos,
                bpm=self._bpm,
                is_playing=self._is_playing,
                output_frames=self.output_frames,
                input_frames=self.input_frames,
                drift_samples=self.input_frames - self.output_frames,
                display_beat_position=beat_pos + total_visual_delay_beats,
                ui_latency_compensation_s=total_visual_delay_s,
                current_beat=int(max(math.floor(beat_pos), 0.0)),
                beat_phase=beat_pos - math.floor(beat_pos),
                input_latency_samples=self._input_latency_samples,
                capture_time_s=self._capture_time_s,
            )

    # ── metronome helper (ref timing.rs:413-439) ────────────────────────

    def did_cross_beat(self, frames: int):
        with self._lock:
            if not self._is_playing:
                return None
            beats_delta = (frames / self._sample_rate) * (self._bpm / 60.0)
            current = self._accumulated_beats
            previous = current - beats_delta
            prev_beat = math.floor(previous)
            curr_beat = math.floor(current)
            if curr_beat > prev_beat:
                frac_before_crossing = (prev_beat + 1) - previous
                sample_offset = int(frac_before_crossing / beats_delta * frames)
                return BeatCrossing(beat_number=prev_beat + 1,
                                    sample_offset_in_buffer=sample_offset)
            return None

    # ── scheduling helpers (ref timing.rs:447-468) ──────────────────────

    def beat_to_output_frame(self, target_beat: float) -> int:
        with self._lock:
            delta_beats = target_beat - self._accumulated_beats
            delta_seconds = delta_beats * 60.0 / self._bpm
            return self.output_frames + int(delta_seconds * self._sample_rate)

    def samples_until_beat(self, target_beat: float) -> int:
        with self._lock:
            delta_beats = target_beat - self._accumulated_beats
            return int(delta_beats * 60.0 / self._bpm * self._sample_rate)

    # ── playback controls (ref timing.rs:474-503) ───────────────────────

    def play(self) -> None:
        self._is_playing = True

    def stop(self) -> None:
        self._is_playing = False

    def set_playing(self, playing: bool) -> None:
        self._is_playing = playing

    def seek_to_beat(self, beat: float) -> None:
        with self._lock:
            self._accumulated_beats = beat

    def set_bpm(self, bpm: float) -> None:
        self._bpm = float(np.float32(bpm))

    def get_bpm(self) -> float:
        return self._bpm

    # ── latency configuration (ref timing.rs:511-550) ───────────────────

    def set_output_latency(self, samples: int) -> None:
        self._output_latency_samples = samples

    def set_input_latency(self, samples: int) -> None:
        self._input_latency_samples = samples

    def set_calibration_offset(self, samples: int) -> None:
        with self._lock:
            self._calibration_offset_samples = samples
            self._calibration_done = True

    def get_calibration_offset(self) -> int:
        return self._calibration_offset_samples

    def is_calibrated(self) -> bool:
        return self._calibration_done

    def reset_calibration(self) -> None:
        with self._lock:
            self._calibration_offset_samples = 0
            self._calibration_done = False

    def set_ui_latency(self, seconds: float) -> None:
        self._ui_latency_s = seconds

    # ── getters (ref timing.rs:556-592) ─────────────────────────────────

    def get_accumulated_beats(self) -> float:
        return self._accumulated_beats

    def get_sample_rate(self) -> float:
        return self._sample_rate

    def get_output_frames(self) -> int:
        return self.output_frames

    def get_input_frames(self) -> int:
        return self.input_frames

    def get_drift_samples(self) -> int:
        return self.input_frames - self.output_frames

    def get_last_tick_output_frame(self) -> int:
        return self.last_tick_output_frame

    def get_output_latency_samples(self) -> int:
        return self._output_latency_samples

    def get_input_latency_samples(self) -> int:
        return self._input_latency_samples

    def is_playing(self) -> bool:
        return self._is_playing

    # ── reset (ref timing.rs:599-610) ───────────────────────────────────

    def reset(self) -> None:
        with self._lock:
            self._accumulated_beats = 0.0
            self.output_frames = 0
            self.input_frames = 0
            self._tick_history_beats = [float("-inf")] * _TICK_HISTORY_LEN
            self._tick_history_count = 0
