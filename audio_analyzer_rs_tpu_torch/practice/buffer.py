"""MeasureBuffer: 3-measure ring (past/current/future) of per-note slots.

Port of ref src/practice/buffer.rs:1-320: slot states Pending/Matched/Missed,
candidate generation (in-duration-window + 2 lookahead + 1 lookbehind
relative to the frontier), advance() aging measures into MeasureData
skeletons, velocity→dynamic 8-step mapping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..theory import freq_to_midi
from ..utils.midi import Measure
from .metrics import ExpectedNote, MeasureData

LOOKAHEAD_NOTES = 2
LOOKBEHIND_NOTES = 1

PENDING = "Pending"
MISSED = "Missed"


@dataclass
class SlotStatus:
    kind: str                       # Pending | Matched | Missed
    pitch_correct: bool = False

    def __eq__(self, other):
        if isinstance(other, str):
            return self.kind == other
        return (self.kind, self.pitch_correct) == (other.kind, other.pitch_correct)


@dataclass
class NoteSlot:
    status: SlotStatus
    matched_start_beat: Optional[float] = None
    matched_seq: Optional[int] = None


IN_WINDOW = "InWindow"


@dataclass
class Candidate:
    key: Tuple[int, int]
    expected: ExpectedNote
    status: SlotStatus
    kind: str                       # InWindow | Lookahead | Lookbehind
    delta: int = 0                  # lookahead/behind distance


def velocity_to_dynamic(velocity: float) -> Optional[int]:
    """0..1 velocity → dynamic level index 0..7 (ref buffer.rs:307-320)."""
    if velocity <= 0.0:
        return None
    for i, bound in enumerate((0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)):
        if velocity < bound:
            return i
    return 7


def build_expected_notes(measure: Measure) -> List[ExpectedNote]:
    """ref buffer.rs:290-301."""
    return [ExpectedNote(
        beat_position=measure.global_start_beat + n.start_beat_in_measure,
        duration_beats=float(n.duration_beats),
        midi_note=freq_to_midi(n.freq),
        dynamic=velocity_to_dynamic(n.velocity),
    ) for n in measure.notes]


class MeasureBuffer:
    def __init__(self, measures: List[Measure], practice_start: int,
                 practice_end: int):
        self.measures = measures
        self.practice_start = practice_start
        self.practice_end = practice_end
        self.past_idx: Optional[int] = None
        self.current_idx = practice_start
        self.future_idx = (practice_start + 1
                           if practice_start < practice_end else None)
        self.slots: Dict[Tuple[int, int], NoteSlot] = {}
        self.done = False
        self._populate_slots(practice_start)
        if self.future_idx is not None:
            self._populate_slots(self.future_idx)

    def slot(self, key) -> Optional[NoteSlot]:
        return self.slots.get(tuple(key))

    def is_done(self) -> bool:
        return self.done

    def measure_for_beat(self, beat: float) -> int:
        """ref buffer.rs:92-106."""
        for m_idx in (self.past_idx, self.current_idx, self.future_idx):
            if m_idx is None:
                continue
            m = self.measures[m_idx]
            start = m.global_start_beat
            if start <= beat < start + m.duration_beats():
                return m_idx
        return self.current_idx

    def record_match(self, key, tracked, pitch_correct: bool):
        s = self.slots.get(tuple(key))
        if s is not None:
            s.status = SlotStatus("Matched", pitch_correct)
            s.matched_start_beat = tracked.start_beat
            s.matched_seq = tracked.seq

    def upgrade_match(self, key, tracked):
        s = self.slots.get(tuple(key))
        if s is not None:
            s.status = SlotStatus("Matched", True)
            s.matched_start_beat = tracked.start_beat
            s.matched_seq = tracked.seq

    def mark_missed(self, key):
        s = self.slots.get(tuple(key))
        if s is not None:
            s.status = SlotStatus(MISSED)

    def next_pending_after(self, frontier) -> Optional[Tuple[int, int]]:
        """ref buffer.rs:132-149."""
        for m_idx in [self.current_idx] + ([self.future_idx]
                                           if self.future_idx is not None else []):
            n_count = len(self.measures[m_idx].notes)
            start = frontier[1] + 1 if m_idx == frontier[0] else 0
            for n_idx in range(start, n_count):
                s = self.slots.get((m_idx, n_idx))
                if s is not None and s.status.kind == PENDING:
                    return (m_idx, n_idx)
        return None

    def candidates(self, beat: float, frontier) -> List[Candidate]:
        """ref buffer.rs:156-212."""
        measure_indices = [m for m in (self.past_idx, self.current_idx,
                                       self.future_idx) if m is not None]
        all_notes: List[Tuple[int, int, ExpectedNote]] = []
        for m_idx in measure_indices:
            for n_idx, exp in enumerate(build_expected_notes(self.measures[m_idx])):
                all_notes.append((m_idx, n_idx, exp))
        all_notes.sort(key=lambda t: t[2].beat_position)

        frontier_pos = next((i for i, (m, n, _) in enumerate(all_notes)
                             if (m, n) == tuple(frontier)), None)
        out: List[Candidate] = []
        for i, (m_idx, n_idx, exp) in enumerate(all_notes):
            key = (m_idx, n_idx)
            slot = self.slots.get(key)
            if slot is None:
                continue
            in_window = (exp.beat_position <= beat
                         < exp.beat_position + exp.duration_beats)
            if in_window:
                kind, delta = IN_WINDOW, 0
            elif frontier_pos is not None:
                delta = i - frontier_pos
                if 0 < delta <= LOOKAHEAD_NOTES:
                    kind = "Lookahead"
                elif delta < 0 and -delta <= LOOKBEHIND_NOTES:
                    kind, delta = "Lookbehind", -delta
                else:
                    continue
            else:
                continue
            out.append(Candidate(key=key, expected=exp,
                                 status=SlotStatus(slot.status.kind,
                                                   slot.status.pitch_correct),
                                 kind=kind, delta=delta))
        return out

    def _populate_slots(self, m_idx: int):
        if m_idx >= len(self.measures):
            return
        for n_idx in range(len(self.measures[m_idx].notes)):
            self.slots[(m_idx, n_idx)] = NoteSlot(SlotStatus(PENDING))

    def advance(self, transport_beat: float) -> List[MeasureData]:
        """ref buffer.rs:233-287."""
        if self.done:
            return []
        cur = self.measures[self.current_idx]
        current_end = cur.global_start_beat + cur.duration_beats()
        if transport_beat < current_end:
            return []

        aged_idx = self.current_idx
        expected_notes = build_expected_notes(self.measures[aged_idx])

        if self.past_idx is not None:
            p = self.past_idx
            self.slots = {k: v for k, v in self.slots.items() if k[0] != p}

        self.past_idx = self.current_idx
        if self.future_idx is not None:
            self.current_idx = self.future_idx
        self.future_idx = (self.current_idx + 1
                           if self.current_idx < self.practice_end else None)
        if self.future_idx is not None:
            self._populate_slots(self.future_idx)

        if aged_idx == self.practice_end:
            self.done = True

        return [MeasureData(measure_index=aged_idx,
                            expected_notes=expected_notes)]
