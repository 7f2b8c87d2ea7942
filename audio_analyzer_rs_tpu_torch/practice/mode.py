"""ModeController — orchestrates conditioner → matcher → clock per tick.

Port of ref src/practice/mode.rs:1-510: per-mode action filtering
(Performance drops all, Rubato drops Stop), per-measure accumulators, live
SendInfo emission (WrongNote / Timing / MissingNote / UnexpectedNote /
Tempo(doubled) / HeldTooLong / HeldTooShort / Intonation), and aged-measure
draining with leftover-Pending → Missed marking.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..theory import Note
from . import SendInfo, ability_tolerance_scale
from .buffer import MeasureBuffer, PENDING
from .clock import ClockManager
from .conditioner import InputConditioner
from .matcher import resolve, step_forward
from .metrics import DynamicsEvent, ExpectedNote, MeasureData, NoteEvent
from .types import (DoubledNote, ExtraNote, Matched, Play, SeekToBeat,
                    SetBpm, Stop, TrackedNoteEnd, TrackedNoteStart, TunerFrame)

HOLD_TOLERANCE_PCT = 0.25
INTONATION_THRESHOLD = 15.0


@dataclass
class MatchedSnapshot:
    measure_idx: int
    note_idx_in_measure_data: int
    expected_duration: float
    expected_midi: int


@dataclass
class TickInputs:
    transport_beat: float
    tuner_frame: Optional[TunerFrame]
    new_onsets: list
    dynamic_level: int    # -1 silence .. 7 fff


@dataclass
class TickOutputs:
    aged_measures: List[MeasureData] = field(default_factory=list)
    events: list = field(default_factory=list)
    outcomes: list = field(default_factory=list)


def _note_name(midi: int) -> str:
    return Note.from_midi(midi).get_name()


def _mode_tol_scale(mode: str) -> float:
    """Rubato widens timing/intonation tolerance (ref mode.rs:455-461)."""
    return 1.5 if mode == "Rubato" else 1.0


def _expected_for(buf: MeasureBuffer, key) -> ExpectedNote:
    """ref mode.rs:496-510."""
    m = buf.measures[key[0]]
    n = m.notes[key[1]]
    from ..theory import freq_to_midi
    return ExpectedNote(
        beat_position=m.global_start_beat + n.start_beat_in_measure,
        duration_beats=float(n.duration_beats),
        midi_note=freq_to_midi(n.freq),
        dynamic=None)


class ModeController:
    def __init__(self, mode: str, ability: str, transport,
                 conditioner: InputConditioner, buffer: MeasureBuffer,
                 clock: ClockManager, practice_start: int):
        self.mode = mode
        self.ability = ability
        self.transport = transport
        self.conditioner = conditioner
        self.buffer = buffer
        self.clock = clock
        self.frontier: Tuple[int, int] = (practice_start, 0)
        self.in_progress_played_notes: Dict[int, List[NoteEvent]] = {}
        self.in_progress_onsets: Dict[int, list] = {}
        self.in_progress_dynamics: Dict[int, List[DynamicsEvent]] = {}
        self.in_progress_durations: Dict[int, List[Optional[float]]] = {}
        self.in_progress_doubled_seqs: Dict[int, List[int]] = {}
        self.match_log: Dict[int, MatchedSnapshot] = {}
        self.last_dynamic_level: Optional[int] = None
        self.feedback: List[SendInfo] = []

    # ── one polling tick (ref mode.rs:93-193) ───────────────────────────

    def tick(self, inputs: TickInputs) -> TickOutputs:
        outputs = TickOutputs()

        events = self.conditioner.ingest(inputs.tuner_frame, inputs.new_onsets)

        for o in inputs.new_onsets:
            mi = self.buffer.measure_for_beat(o.beat_position)
            self.in_progress_onsets.setdefault(mi, []).append(o)

        if (inputs.dynamic_level != -1
                and self.last_dynamic_level != inputs.dynamic_level):
            self.in_progress_dynamics.setdefault(
                self.buffer.current_idx, []).append(
                DynamicsEvent(beat_position=inputs.transport_beat,
                              level=inputs.dynamic_level))
            self.last_dynamic_level = inputs.dynamic_level

        for kind, ev in events:
            if kind == "Started":
                outcome = resolve(ev, self.buffer, self.frontier)
                self._handle_outcome(ev, outcome, inputs.transport_beat)
                outputs.outcomes.append((outcome, ev))
            else:
                self._handle_ended(ev)
        outputs.events = events

        for a in self.clock.on_tick(self.buffer, self.frontier,
                                    inputs.transport_beat, self.mode):
            self._apply_action(a)

        aged = self.buffer.advance(inputs.transport_beat)
        for m in aged:
            mi = m.measure_index
            to_miss = [(mi, i) for i in range(len(m.expected_notes))
                       if (s := self.buffer.slot((mi, i))) is not None
                       and s.status.kind == PENDING]
            for k in to_miss:
                self.feedback.append(self._missing_note_send_info(k))
                self.buffer.mark_missed(k)
                if self.frontier == k:
                    self.frontier = step_forward(self.buffer, k)
            m.onsets = self.in_progress_onsets.pop(mi, [])
            m.notes = self.in_progress_played_notes.pop(mi, [])
            m.dynamics = self.in_progress_dynamics.pop(mi, [])
            m.note_durations = self.in_progress_durations.pop(mi, [])
            m.doubled_note_seqs = self.in_progress_doubled_seqs.pop(mi, [])
            outputs.aged_measures.append(m)
        return outputs

    # ── outcome handling (ref mode.rs:195-286) ──────────────────────────

    def _handle_outcome(self, t: TrackedNoteStart, outcome,
                        transport_beat: float):
        mi = self.buffer.measure_for_beat(t.start_beat)
        self.in_progress_played_notes.setdefault(mi, []).append(
            NoteEvent(beat_position=t.start_beat, midi_note=t.midi_note,
                      avg_cents=t.initial_cents))
        self.in_progress_durations.setdefault(mi, []).append(None)
        note_idx = len(self.in_progress_played_notes[mi]) - 1

        if isinstance(outcome, Matched):
            for k in outcome.skipped_keys:
                self.buffer.mark_missed(k)
                self.feedback.append(self._missing_note_send_info(k))
            if outcome.upgrade:
                self.buffer.upgrade_match(outcome.key, t)
            else:
                self.buffer.record_match(outcome.key, t, outcome.pitch_correct)
            self.frontier = step_forward(self.buffer, outcome.key)
            exp = _expected_for(self.buffer, outcome.key)
            self.match_log[t.seq] = MatchedSnapshot(
                measure_idx=outcome.key[0],
                note_idx_in_measure_data=note_idx,
                expected_duration=exp.duration_beats,
                expected_midi=exp.midi_note)
            if not outcome.pitch_correct:
                self.feedback.append(self._send_info(outcome.key, "WrongNote",
                                                     exp, t))
            elif outcome.upgrade:
                self.feedback.append(self._upgrade_send_info(outcome.key, exp, t))
            else:
                self.feedback.append(self._send_info(outcome.key, "None",
                                                     exp, t))
            timing_threshold = (exp.duration_beats
                                * self.clock.cfg.seek_threshold_pct
                                * _mode_tol_scale(self.mode)
                                * ability_tolerance_scale(self.ability))
            if abs(outcome.timing_err) > timing_threshold:
                self.feedback.append(self._timing_send_info(
                    outcome.key, exp, t, outcome.timing_err))
            actions = self.clock.on_match(outcome, exp, transport_beat,
                                          self.mode)
        elif isinstance(outcome, DoubledNote):
            self.in_progress_doubled_seqs.setdefault(mi, []).append(t.seq)
            exp = _expected_for(self.buffer, outcome.key)
            self.feedback.append(self._send_info(outcome.key, "Tempo", exp, t))
            slot = self.buffer.slot(outcome.key)
            actions = (self.clock.on_doubled(slot, self.mode)
                       if slot is not None else [])
        else:  # ExtraNote
            self.feedback.append(self._extra_note_send_info(outcome.during, t))
            actions = self.clock.on_extra()

        for a in actions:
            self._apply_action(a)

    def _handle_ended(self, t: TrackedNoteEnd):
        """ref mode.rs:288-345."""
        snap = self.match_log.pop(t.seq, None)
        if snap is None:
            return
        mi = snap.measure_idx
        notes = self.in_progress_played_notes.get(mi)
        if notes is None or snap.note_idx_in_measure_data >= len(notes):
            return
        n = notes[snap.note_idx_in_measure_data]
        actual_duration = t.end_beat - n.beat_position
        n.avg_cents = t.avg_cents
        durs = self.in_progress_durations.get(mi)
        if durs is not None and snap.note_idx_in_measure_data < len(durs):
            durs[snap.note_idx_in_measure_data] = actual_duration
        if actual_duration > snap.expected_duration * (1.0 + HOLD_TOLERANCE_PCT):
            self.feedback.append(SendInfo(
                measure=mi, note_index=snap.note_idx_in_measure_data,
                error_type="HeldTooLong", intensity=0.6,
                expected=f"held~{snap.expected_duration:.2f}",
                received=f"held for {actual_duration:.2f}"))
        elif actual_duration < snap.expected_duration * (1.0 - HOLD_TOLERANCE_PCT):
            self.feedback.append(SendInfo(
                measure=mi, note_index=snap.note_idx_in_measure_data,
                error_type="HeldTooShort", intensity=0.6,
                expected=f"held~{snap.expected_duration:.2f}",
                received=f"held for {actual_duration:.2f}"))
        intonation_threshold = (INTONATION_THRESHOLD * _mode_tol_scale(self.mode)
                                * ability_tolerance_scale(self.ability))
        if abs(t.avg_cents) > intonation_threshold:
            self.feedback.append(SendInfo(
                measure=mi, note_index=snap.note_idx_in_measure_data,
                error_type="Intonation",
                intensity=min(abs(t.avg_cents) / 50.0, 1.0),
                expected=_note_name(snap.expected_midi),
                received=f"{_note_name(t.midi_note)} {t.avg_cents:+.0f}c"))

    def _apply_action(self, action):
        """Per-mode action filter (ref mode.rs:347-356)."""
        if self.mode == "Performance":
            return
        if isinstance(action, SeekToBeat):
            self.transport.seek_to_beat(action.beat)
        elif isinstance(action, Stop):
            if self.mode == "FollowAlong":
                self.transport.stop()
        elif isinstance(action, Play):
            self.transport.play()
        elif isinstance(action, SetBpm):
            self.transport.set_bpm(action.bpm)

    # ── SendInfo builders (ref mode.rs:368-494) ─────────────────────────

    def _send_info(self, key, err, exp, t) -> SendInfo:
        return SendInfo(
            measure=key[0], note_index=key[1], error_type=err, intensity=0.0,
            expected=f"{_note_name(exp.midi_note)} beat {exp.beat_position:.2f}",
            received=f"{_note_name(t.midi_note)} at beat {t.start_beat:.2f}")

    def _upgrade_send_info(self, key, exp, t) -> SendInfo:
        return SendInfo(
            measure=key[0], note_index=key[1], error_type="None", intensity=0.0,
            expected=(f"{_note_name(exp.midi_note)} at beat "
                      f"{exp.beat_position:.2f} (corrected)"),
            received=f"{_note_name(t.midi_note)} at beat {t.start_beat:.2f}")

    def _timing_send_info(self, key, exp, t, err) -> SendInfo:
        return SendInfo(
            measure=key[0], note_index=key[1], error_type="Timing",
            intensity=min(abs(err) / 0.5, 1.0),
            expected=f"{_note_name(exp.midi_note)} at beat {exp.beat_position:.3f}",
            received=f"{_note_name(t.midi_note)} at beat {t.start_beat:.3f}")

    def _missing_note_send_info(self, key) -> SendInfo:
        exp = _expected_for(self.buffer, key)
        return SendInfo(
            measure=key[0], note_index=key[1], error_type="MissingNote",
            intensity=1.0,
            expected=f"{_note_name(exp.midi_note)} at beat {exp.beat_position:.2f}",
            received="silence")

    def _extra_note_send_info(self, during, t) -> SendInfo:
        if during is not None:
            exp = _expected_for(self.buffer, during)
            measure, note_index = during
            expected_str = f"{_note_name(exp.midi_note)} (extra during held)"
        else:
            measure, note_index, expected_str = 0, 0, "silence"
        return SendInfo(
            measure=measure, note_index=note_index,
            error_type="UnexpectedNote", intensity=0.5,
            expected=expected_str,
            received=f"{_note_name(t.midi_note)} at beat {t.start_beat:.2f}")
