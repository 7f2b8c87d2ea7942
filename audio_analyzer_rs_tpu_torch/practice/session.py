"""PracticeSession — session façade + polling loop.

Port of ref src/practice/mod.rs:125-560: MIDI load, measure-range validation,
transport seek to `first_beat − countoff − 0.001`, the 10 ms polling tick
(count-off wait → drain onsets → dedup tuner frames by beat → calibrate →
ModeController.tick → drain feedback / aged measures → done when the buffer
finishes or the frontier passes the end), poll_transport / poll_errors /
get_metrics JSON surfaces.

The reference runs the loop on a thread against live audio; here the loop is
a `tick()` driven by the engine clock (deterministic offline) or by a thread
in realtime simulation mode — the engine decides the cadence.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from ..theory import note_name_to_midi
from ..transport import MusicalTransport
from ..utils.midi import Measure, load_midi_file
from . import SendInfo
from .buffer import MeasureBuffer
from .clock import ClockConfig, ClockManager
from .conditioner import InputConditioner
from .metrics import MeasureData, compute_metrics
from .mode import ModeController, TickInputs
from .types import TunerFrame


class PracticeSession:
    def __init__(self, transport: MusicalTransport, tuner, onset,
                 dynamics_output, midi_path: str, instrument: str,
                 countoff_beats: int, mode: str, ability_level: str,
                 bpm: float, measures: Optional[List[Measure]] = None):
        """tuner: object with .output (TunerOutput);
        onset: object with .drain_onset_events();
        dynamics_output: callable returning the current dynamic level int."""
        if measures is None:
            measures = load_midi_file(midi_path, instrument, bpm)
        if not measures:
            raise ValueError("MIDI file contains no measures")
        self.measures = measures
        self.transport = transport
        self.tuner = tuner
        self.onset = onset
        self.dynamics_output = dynamics_output
        self.countoff_beats = countoff_beats
        self.mode = mode
        self.ability_level = ability_level

        self.practice_start = 0
        self.practice_end = 0
        self.current_measure_idx = 0
        self.completed_measures: List[MeasureData] = []
        self.first_measure_beat = 0.0
        self.in_countoff = False
        self.feedback: List[SendInfo] = []
        self.running = False
        self._mc: Optional[ModeController] = None
        self._last_tuner_beat: Optional[float] = None
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None

    # ── lifecycle (ref practice/mod.rs:209-308) ─────────────────────────

    def start(self, start_measure: int, end_measure: int) -> None:
        if start_measure > end_measure:
            raise ValueError(
                f"start_measure ({start_measure}) > end_measure ({end_measure})")
        if end_measure >= len(self.measures):
            raise ValueError(
                f"end_measure ({end_measure}) out of range "
                f"(MIDI has {len(self.measures)} measures)")
        first = self.measures[start_measure]
        first_beat = first.global_start_beat
        bpm = first.bpm
        seek_beat = (first_beat - self.countoff_beats
                     if self.countoff_beats > 0 else first_beat) - 0.001

        with self._lock:
            self.practice_start = start_measure
            self.practice_end = end_measure
            self.current_measure_idx = start_measure
            self.completed_measures = []
            self.first_measure_beat = first_beat
            self.in_countoff = self.countoff_beats > 0
            self.feedback = []
            self._last_tuner_beat = None

            self.transport.set_bpm(bpm)
            self.transport.seek_to_beat(seek_beat)
            self.transport.play()

            buffer = MeasureBuffer(self.measures, start_measure, end_measure)
            conditioner = InputConditioner(self.transport)
            clock = ClockManager(self.transport, ClockConfig(),
                                 self.transport.get_bpm())
            self._mc = ModeController(self.mode, self.ability_level,
                                      self.transport, conditioner, buffer,
                                      clock, start_measure)
            self.running = True

    def stop(self) -> None:
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.transport.stop()

    def run_threaded(self, tick_s: float = 0.010) -> None:
        """Spawn the reference-style 10 ms polling thread (realtime mode)."""
        def loop():
            while self.running:
                self.tick()
                time.sleep(tick_s)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    # ── one polling tick (ref practice/mod.rs:478-559) ──────────────────

    def tick(self) -> bool:
        """Advance the session; returns False once the session finished."""
        with self._lock:
            if not self.running or self._mc is None:
                return False
            beat = self.transport.get_accumulated_beats()

            if self.in_countoff:
                if beat >= self.first_measure_beat:
                    self.in_countoff = False
                else:
                    return True

            new_onsets = self.onset.drain_onset_events()
            out = self.tuner.output
            raw_tuner_beat = out.beat_position
            calibrated = self.transport.calibrated_beat(raw_tuner_beat)
            tuner_frame = None
            if self._last_tuner_beat != calibrated:
                self._last_tuner_beat = calibrated
                pairs = [(m, float(c)) for n, c in zip(out.notes, out.accuracies)
                         if (m := note_name_to_midi(n)) is not None]
                tuner_frame = TunerFrame(notes=pairs, tuner_beat=calibrated)

            dynamic_level = self.dynamics_output()

            outputs = self._mc.tick(TickInputs(
                transport_beat=beat, tuner_frame=tuner_frame,
                new_onsets=new_onsets, dynamic_level=dynamic_level))

            if self._mc.feedback:
                self.feedback.extend(self._mc.feedback)
                self._mc.feedback = []
            if outputs.aged_measures:
                self.current_measure_idx = self._mc.buffer.current_idx
                self.completed_measures.extend(outputs.aged_measures)

            if (self._mc.buffer.is_done()
                    or self._mc.frontier[0] > self.practice_end):
                self.running = False
                return False
            return True

    def is_running(self) -> bool:
        return self.running

    # ── frontend output (ref practice/mod.rs:340-411) ───────────────────

    def poll_transport(self) -> str:
        snap = self.transport.snapshot().to_dict()
        with self._lock:
            snap["current_measure_idx"] = self.current_measure_idx
            snap["practice_start"] = self.practice_start
            snap["practice_end"] = self.practice_end
            snap["in_countoff"] = self.in_countoff
        return json.dumps(snap)

    def poll_errors(self) -> str:
        with self._lock:
            batch = self.feedback
            self.feedback = []
        return json.dumps([s.to_dict() for s in batch])

    def get_metrics(self) -> str:
        with self._lock:
            completed = self.completed_measures
            if not completed:
                return "{}"
            start_idx = completed[0].measure_index
            end_idx = completed[-1].measure_index
            ref_measure = self.measures[start_idx]
            metrics = compute_metrics(start_idx, end_idx,
                                      float(ref_measure.bpm), completed)
        return json.dumps(metrics)

    def set_tuner_mode(self, mode: str) -> None:
        self.tuner.send("SetMode",
                        "SinglePitch" if mode == "SinglePitch" else "MultiPitch")

    def set_bpm(self, bpm: float) -> None:
        self.transport.set_bpm(bpm)
