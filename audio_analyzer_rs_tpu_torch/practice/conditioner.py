"""Input conditioner: 3-tier note-start detection with per-pitch FSMs.

Port of ref src/practice/conditioner.rs:1-329: per-pitch state machines
(StartPending 5 frames → Active → EndPending 5 frames), onset claiming within
±0.05 beats, transient-cluster fallback (≥4 transients in a 10-frame window),
glide pivot-ends, and ±60-cent pitch normalization.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from .types import (ONSET, STABLE_FIVE_FRAME, TRANSIENT_CLUSTER,
                    TrackedNoteEnd, TrackedNoteStart, TunerFrame)

STABLE_FRAMES = 5
END_FRAMES = 5
ONSET_CLAIM_WINDOW = 0.05
CLUSTER_MIN_TRANSIENTS = 4
CLUSTER_FRAME_WINDOW = 10
RECENT_ONSET_RETENTION_BEATS = 0.5
PITCH_CENTS_LIMIT = 60.0


def normalize_pitch(midi: int, cents: float):
    """Fold cents back within ±PITCH_CENTS_LIMIT (ref conditioner.rs:20-33)."""
    while cents > PITCH_CENTS_LIMIT and midi < 127:
        midi += 1
        cents -= 100.0
    while cents < -PITCH_CENTS_LIMIT and midi > 0:
        midi -= 1
        cents += 100.0
    return midi, cents


class _StartPending:
    __slots__ = ("frames", "first_frame_beat", "first_frame_seq", "cents_buffer")

    def __init__(self, frames, first_frame_beat, first_frame_seq, cents_buffer):
        self.frames = frames
        self.first_frame_beat = first_frame_beat
        self.first_frame_seq = first_frame_seq
        self.cents_buffer = cents_buffer


class _Active:
    __slots__ = ("seq", "start_beat", "start_source", "cents_sum",
                 "frame_count", "fallback_cents")

    def __init__(self, seq, start_beat, start_source, cents_sum, frame_count,
                 fallback_cents):
        self.seq = seq
        self.start_beat = start_beat
        self.start_source = start_source
        self.cents_sum = cents_sum
        self.frame_count = frame_count
        self.fallback_cents = fallback_cents


class _EndPending:
    __slots__ = ("absent_frames", "first_absence_beat", "carry")

    def __init__(self, absent_frames, first_absence_beat, carry):
        self.absent_frames = absent_frames
        self.first_absence_beat = first_absence_beat
        self.carry = carry


def _end_event(midi: int, carry: _Active, end_beat: float) -> TrackedNoteEnd:
    raw_avg = (carry.cents_sum / carry.frame_count if carry.frame_count > 0
               else carry.fallback_cents)
    norm_midi, norm_cents = normalize_pitch(midi, raw_avg)
    return TrackedNoteEnd(seq=carry.seq, midi_note=norm_midi,
                          end_beat=end_beat, avg_cents=norm_cents,
                          frame_count=carry.frame_count)


class InputConditioner:
    def __init__(self, transport=None):
        self._transport = transport
        self.pitches: Dict[int, object] = {}
        self.recent_onsets = deque()
        self.transient_log = deque()     # (seq, beat, midi)
        self.frame_seq = 0
        self.next_event_seq = 0
        self.last_tuner_beat: Optional[float] = None

    def ingest(self, tuner_frame: Optional[TunerFrame], new_onsets) -> List:
        for o in new_onsets:
            self.recent_onsets.append(o)

        if tuner_frame is None:
            return []
        if self.last_tuner_beat == tuner_frame.tuner_beat:
            return []
        self.last_tuner_beat = tuner_frame.tuner_beat
        self.frame_seq += 1

        cutoff = tuner_frame.tuner_beat - RECENT_ONSET_RETENTION_BEATS
        while self.recent_onsets and self.recent_onsets[0].beat_position < cutoff:
            self.recent_onsets.popleft()
        seq_cutoff = max(self.frame_seq - (CLUSTER_FRAME_WINDOW + STABLE_FRAMES), 0)
        while self.transient_log and self.transient_log[0][0] < seq_cutoff:
            self.transient_log.popleft()

        events: List = []
        present = {m for m, _ in tuner_frame.notes}
        cents_by_midi = dict(tuner_frame.notes)

        # 1. Pitches present in the frame (sorted for determinism; the
        # reference iterates a HashSet in arbitrary order).
        for m in sorted(present):
            cents = cents_by_midi.get(m, 0.0)
            entry = self.pitches.pop(m, None)
            if entry is None:
                new_state = _StartPending(1, tuner_frame.tuner_beat,
                                          self.frame_seq, [cents])
            elif isinstance(entry, _StartPending):
                entry.cents_buffer.append(cents)
                entry.frames += 1
                if entry.frames >= STABLE_FRAMES:
                    # Pivot-end any EndPending pitches at this confirmation's
                    # first frame beat (ref conditioner.rs:153-181).
                    pivot_beat = entry.first_frame_beat
                    for old_m in [k for k, s in self.pitches.items()
                                  if isinstance(s, _EndPending)]:
                        ep = self.pitches.pop(old_m)
                        events.append(("Ended", _end_event(old_m, ep.carry,
                                                           pivot_beat)))
                    start_beat, start_source = self._run_tier_cascade(
                        m, entry.first_frame_beat, entry.first_frame_seq)
                    seq = self.next_event_seq
                    self.next_event_seq += 1
                    avg = sum(entry.cents_buffer) / len(entry.cents_buffer)
                    fallback = entry.cents_buffer[-1] if entry.cents_buffer else 0.0
                    events.append(("Started", TrackedNoteStart(
                        seq=seq, midi_note=m, start_beat=start_beat,
                        start_source=start_source, initial_cents=avg)))
                    # Confirmation-window cents are unstable; accumulate only
                    # Active frames (ref conditioner.rs:197-208).
                    new_state = _Active(seq, start_beat, start_source,
                                        0.0, 0, fallback)
                else:
                    new_state = entry
            elif isinstance(entry, _Active):
                entry.cents_sum += cents
                entry.frame_count += 1
                new_state = entry
            else:  # _EndPending → resume
                new_state = entry.carry
            self.pitches[m] = new_state

        # 2. Pitches missing from the frame.
        for m in sorted(k for k in self.pitches if k not in present):
            entry = self.pitches.pop(m)
            if isinstance(entry, _StartPending):
                self.transient_log.append((entry.first_frame_seq,
                                           entry.first_frame_beat, m))
            elif isinstance(entry, _Active):
                self.pitches[m] = _EndPending(1, tuner_frame.tuner_beat, entry)
            else:  # _EndPending
                entry.absent_frames += 1
                if entry.absent_frames >= END_FRAMES:
                    events.append(("Ended", _end_event(
                        m, entry.carry, entry.first_absence_beat)))
                else:
                    self.pitches[m] = entry

        return events

    def _run_tier_cascade(self, midi, first_frame_beat, first_frame_seq):
        """ref conditioner.rs:294-328."""
        # 1. Onset claim.
        for i, o in enumerate(self.recent_onsets):
            if abs(o.beat_position - first_frame_beat) < ONSET_CLAIM_WINDOW:
                claimed = o
                del self.recent_onsets[i]
                return claimed.beat_position, ONSET
        # 2. Transient cluster.
        cutoff_seq = max(first_frame_seq - CLUSTER_FRAME_WINDOW, 0)
        cluster = [t for t in self.transient_log if t[0] >= cutoff_seq]
        if len(cluster) >= CLUSTER_MIN_TRANSIENTS:
            first_beat = cluster[0][1]
            remaining = deque(t for t in self.transient_log if t[0] < cutoff_seq)
            self.transient_log = remaining
            return first_beat, TRANSIENT_CLUSTER
        # 3. Stable five frame.
        return first_frame_beat, STABLE_FIVE_FRAME
