"""End-of-session metrics aggregation.

Port of ref src/practice/metrics.rs:1-697: accuracy % (0.25-beat match
window, exact or ±1-sequence-neighbor pitch), avg |cents|, notes missed,
timing consistency (population σ), onset accuracy, microtiming skew,
per-measure tempo map via matched-span ratio, tempo stability 1−CV, dynamics
accuracy (±1 step) & consistency, dynamics range, per-category error-measure
lists, doubled/hold error counts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from ..ops.dynamics import LEVEL_NAMES

# Thresholds (ref metrics.rs:9-17).
ONSET_TIMING_ERR_THRESHOLD = 0.15
ACCURACY_ERR_THRESHOLD = 0.80
INTONATION_ERR_THRESHOLD = 25.0
DYNAMICS_ERR_THRESHOLD = 0.50
NOTE_MATCH_WINDOW = 0.25
HOLD_TOLERANCE_PCT = 0.25


@dataclass
class NoteEvent:
    beat_position: float
    midi_note: int
    avg_cents: float


@dataclass
class DynamicsEvent:
    beat_position: float
    level: int   # -1 silence … 7 fff


@dataclass
class ExpectedNote:
    beat_position: float
    duration_beats: float
    midi_note: int
    dynamic: Optional[int]   # 0..7 or None


@dataclass
class MeasureData:
    measure_index: int
    onsets: List = field(default_factory=list)          # OnsetEvent
    notes: List[NoteEvent] = field(default_factory=list)
    dynamics: List[DynamicsEvent] = field(default_factory=list)
    expected_notes: List[ExpectedNote] = field(default_factory=list)
    note_durations: List[Optional[float]] = field(default_factory=list)
    doubled_note_seqs: List[int] = field(default_factory=list)


def _std_dev(values: List[float]) -> float:
    """Population std dev (ref metrics.rs:689-696)."""
    if len(values) < 2:
        return 0.0
    mean = sum(values) / len(values)
    return math.sqrt(sum((v - mean) ** 2 for v in values) / len(values))


def _note_is_matched(notes, expected_notes, ei, window) -> bool:
    """Exact or ±1-sequence-neighbor pitch within the window
    (ref metrics.rs:623-644)."""
    exp_beat = expected_notes[ei].beat_position
    exact = expected_notes[ei].midi_note
    prev = expected_notes[ei - 1].midi_note if ei > 0 else None
    nxt = (expected_notes[ei + 1].midi_note
           if ei + 1 < len(expected_notes) else None)
    return any(abs(n.beat_position - exp_beat) < window
               and n.midi_note in (exact, prev, nxt)
               for n in notes)


def _closest_onset(onsets, target_beat):
    """ref metrics.rs:647-657."""
    if not onsets:
        return None
    best = min(onsets, key=lambda o: abs(o.beat_position - target_beat))
    return best if abs(best.beat_position - target_beat) < NOTE_MATCH_WINDOW else None


def _actual_dynamic_at(dynamics, beat):
    """Most recent dynamic at or before `beat` (ref metrics.rs:660-670)."""
    prior = [d for d in dynamics if d.beat_position <= beat]
    return max(prior, key=lambda d: d.beat_position).level if prior else None


def _expected_hold_duration(m: MeasureData, i: int) -> Optional[float]:
    note = m.notes[i] if i < len(m.notes) else None
    if note is None:
        return None
    for e in m.expected_notes:
        if (abs(e.beat_position - note.beat_position) < NOTE_MATCH_WINDOW
                and e.midi_note == note.midi_note):
            return e.duration_beats
    return None


def compute_metrics(start_measure: int, end_measure: int, tempo_bpm: float,
                    measures: List[MeasureData]) -> dict:
    """ref metrics.rs:121-203.  Returns the 25-field metrics dict."""
    num_measures = max(end_measure - start_measure, 0) + 1

    # Note accuracy.
    total = sum(len(m.expected_notes) for m in measures)
    matched = sum(
        1 for m in measures for ei in range(len(m.expected_notes))
        if _note_is_matched(m.notes, m.expected_notes, ei, NOTE_MATCH_WINDOW))
    accuracy_percent = matched / total * 100.0 if total else 100.0
    num_notes_missed = total - matched

    all_cents = [abs(n.avg_cents) for m in measures for n in m.notes]
    avg_cent_dev = sum(all_cents) / len(all_cents) if all_cents else 0.0

    # Timing.
    signed_errors = []
    for m in measures:
        for e in m.expected_notes:
            o = _closest_onset(m.onsets, e.beat_position)
            if o is not None:
                signed_errors.append(o.beat_position - e.beat_position)
    timing_consistency = _std_dev(signed_errors)
    note_onset_accuracy = (sum(abs(e) for e in signed_errors) / len(signed_errors)
                           if signed_errors else 0.0)
    microtiming_skew = (sum(signed_errors) / len(signed_errors)
                        if signed_errors else 0.0)

    # Tempo map (ref metrics.rs:386-431).
    measure_tempo_map = []
    for m in measures:
        pairs = []
        for e in m.expected_notes:
            o = _closest_onset(m.onsets, e.beat_position)
            if o is not None:
                pairs.append((e.beat_position, o.beat_position))
        pairs.sort()
        if len(pairs) < 2:
            measure_tempo_map.append(tempo_bpm)
            continue
        expected_span = pairs[-1][0] - pairs[0][0]
        actual_span = pairs[-1][1] - pairs[0][1]
        if actual_span < 1e-6 or expected_span < 1e-6:
            measure_tempo_map.append(tempo_bpm)
        else:
            measure_tempo_map.append(tempo_bpm * expected_span / actual_span)

    if len(measure_tempo_map) < 2:
        tempo_stability = 1.0
    else:
        cv = _std_dev(measure_tempo_map) / max(tempo_bpm, 1.0)
        tempo_stability = max(1.0 - min(cv, 1.0), 0.0)

    # Dynamics.
    dyn_errors = []
    dyn_total = dyn_correct = 0
    for m in measures:
        for e in m.expected_notes:
            if e.dynamic is None:
                continue
            act = _actual_dynamic_at(m.dynamics, e.beat_position)
            if act is None:
                continue
            dyn_errors.append(float(act - e.dynamic))
            dyn_total += 1
            if abs(act - e.dynamic) <= 1:
                dyn_correct += 1
    dynamics_consistency = _std_dev(dyn_errors)
    dynamics_accuracy = dyn_correct / dyn_total * 100.0 if dyn_total else 100.0

    dyn_levels = [d.level for m in measures for d in m.dynamics if d.level >= 0]
    dynamics_range_used = ((LEVEL_NAMES[min(dyn_levels) + 1],
                            LEVEL_NAMES[max(dyn_levels) + 1])
                           if dyn_levels else ("n/a", "n/a"))

    # Error-measure lists.
    rhythm_err = []
    for m in measures:
        errs = [abs(o.beat_position - e.beat_position)
                for e in m.expected_notes
                if (o := _closest_onset(m.onsets, e.beat_position)) is not None]
        if errs and sum(errs) / len(errs) > ONSET_TIMING_ERR_THRESHOLD:
            rhythm_err.append(m.measure_index)
    note_err = []
    for m in measures:
        t = len(m.expected_notes)
        if t == 0:
            continue
        mm = sum(1 for ei in range(t)
                 if _note_is_matched(m.notes, m.expected_notes, ei,
                                     NOTE_MATCH_WINDOW))
        if mm / t < ACCURACY_ERR_THRESHOLD:
            note_err.append(m.measure_index)
    intonation_err = []
    for m in measures:
        if m.notes:
            avg = sum(abs(n.avg_cents) for n in m.notes) / len(m.notes)
            if avg > INTONATION_ERR_THRESHOLD:
                intonation_err.append(m.measure_index)
    dynamics_err = []
    for m in measures:
        with_dyn = [e for e in m.expected_notes if e.dynamic is not None]
        if not with_dyn:
            continue
        correct = sum(
            1 for e in with_dyn
            if (a := _actual_dynamic_at(m.dynamics, e.beat_position)) is not None
            and abs(a - e.dynamic) <= 1)
        if correct / len(with_dyn) < DYNAMICS_ERR_THRESHOLD:
            dynamics_err.append(m.measure_index)

    error_measures = sorted(set(rhythm_err) | set(note_err)
                            | set(intonation_err) | set(dynamics_err))
    avg_errors_per_measure = (len(error_measures) / num_measures
                              if num_measures else 0.0)

    # Doubled-note / hold errors (ref metrics.rs:205-271).
    tempo_err_count = sum(len(m.doubled_note_seqs) for m in measures)
    tempo_err_measures = [m.measure_index for m in measures
                          if m.doubled_note_seqs]
    hold_long = hold_short = 0
    hold_err_measures = []
    for m in measures:
        measure_has = False
        for i, dur in enumerate(m.note_durations):
            if dur is None:
                continue
            exp_dur = _expected_hold_duration(m, i)
            if exp_dur is None:
                continue
            if dur > exp_dur * (1.0 + HOLD_TOLERANCE_PCT):
                hold_long += 1
                measure_has = True
            elif dur < exp_dur * (1.0 - HOLD_TOLERANCE_PCT):
                hold_short += 1
                measure_has = True
        if measure_has:
            hold_err_measures.append(m.measure_index)

    return {
        "start_measure": start_measure,
        "end_measure": end_measure,
        "num_measures": num_measures,
        "tempo_bpm": tempo_bpm,
        "accuracy_percent": accuracy_percent,
        "avg_cent_dev": avg_cent_dev,
        "num_notes_missed": num_notes_missed,
        "timing_consistency": timing_consistency,
        "dynamics_consistency": dynamics_consistency,
        "dynamics_accuracy": dynamics_accuracy,
        "error_measures": error_measures,
        "rhythm_err_measures": rhythm_err,
        "note_err_measures": note_err,
        "intonation_err_measures": intonation_err,
        "dynamics_err_measures": dynamics_err,
        "avg_errors_per_measure": avg_errors_per_measure,
        "note_onset_accuracy": note_onset_accuracy,
        "microtiming_skew": microtiming_skew,
        "tempo_stability": tempo_stability,
        "measure_tempo_map": measure_tempo_map,
        "dynamics_range_used": dynamics_range_used,
        "tempo_err_count": tempo_err_count,
        "hold_err_count": (hold_long, hold_short),
        "tempo_err_measures": tempo_err_measures,
        "hold_err_measures": hold_err_measures,
    }
