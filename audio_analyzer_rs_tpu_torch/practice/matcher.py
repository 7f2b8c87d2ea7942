"""Matcher: resolve a TrackedNoteStart into a MatchOutcome.

Port of ref src/practice/matcher.rs:1-177 — 5 rules:
  1. closest in-window Pending matches regardless of pitch;
  2. in-window Matched(false) + exact pitch → upgrade;
  3. Matched(true) + exact pitch within 0.5-beat freshness → DoubledNote;
  4. scored lookahead/behind (pitch 100/30/10/0 by semitone distance +
     timing 50-in-window-else 50-100·err + kind penalty 0/-10/-25/-15/-50),
     min score 80, exact pitch required;
  5. else ExtraNote{during}.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .buffer import IN_WINDOW, MeasureBuffer, PENDING
from .types import DoubledNote, ExtraNote, Matched, TrackedNoteStart

MIN_MATCH_SCORE = 80
DOUBLED_NOTE_FRESHNESS = 0.5


def _pitch_score(played: int, expected: int) -> int:
    d = abs(played - expected)
    return {0: 100, 1: 30, 2: 10}.get(d, 0)


def _timing_score(beat: float, exp) -> int:
    if exp.beat_position <= beat < exp.beat_position + exp.duration_beats:
        return 50
    err = abs(beat - exp.beat_position)
    return max(int(50.0 - 100.0 * err), 0)


def _kind_penalty(cand) -> int:
    if cand.kind == IN_WINDOW:
        return 0
    if cand.kind == "Lookahead":
        return -10 if cand.delta == 1 else (-25 if cand.delta == 2 else -50)
    if cand.kind == "Lookbehind":
        return -15 if cand.delta == 1 else -50
    return -50


def resolve(tracked: TrackedNoteStart, buf: MeasureBuffer,
            frontier: Tuple[int, int]):
    cands = buf.candidates(tracked.start_beat, frontier)

    # Rule 1.
    in_window_pending = [c for c in cands
                         if c.kind == IN_WINDOW and c.status.kind == PENDING]
    if in_window_pending:
        best = min(in_window_pending,
                   key=lambda c: abs(tracked.start_beat - c.expected.beat_position))
        return Matched(
            key=best.key,
            timing_err=tracked.start_beat - best.expected.beat_position,
            pitch_correct=tracked.midi_note == best.expected.midi_note,
            upgrade=False,
            skipped_keys=_walk_skipped(buf, frontier, best.key))

    # Rule 2.
    for c in cands:
        if (c.kind == IN_WINDOW and c.status.kind == "Matched"
                and not c.status.pitch_correct
                and tracked.midi_note == c.expected.midi_note):
            return Matched(key=c.key,
                           timing_err=tracked.start_beat - c.expected.beat_position,
                           pitch_correct=True, upgrade=True, skipped_keys=[])

    # Rule 3.
    for c in cands:
        if (c.kind == IN_WINDOW and c.status.kind == "Matched"
                and c.status.pitch_correct
                and tracked.midi_note == c.expected.midi_note):
            slot = buf.slot(c.key)
            msb = slot.matched_start_beat if slot else None
            if msb is not None and tracked.start_beat - msb <= DOUBLED_NOTE_FRESHNESS:
                return DoubledNote(key=c.key)

    # Rule 4.
    best: Optional[Tuple] = None
    for c in cands:
        if c.status.kind != PENDING:
            continue
        score = (_pitch_score(tracked.midi_note, c.expected.midi_note)
                 + _timing_score(tracked.start_beat, c.expected)
                 + _kind_penalty(c))
        if (score >= MIN_MATCH_SCORE
                and tracked.midi_note == c.expected.midi_note
                and (best is None or score > best[1])):
            best = (c, score)
    if best is not None:
        c = best[0]
        return Matched(key=c.key,
                       timing_err=tracked.start_beat - c.expected.beat_position,
                       pitch_correct=True, upgrade=False,
                       skipped_keys=_walk_skipped(buf, frontier, c.key))

    # Rule 5.
    during = next((c.key for c in cands if c.kind == IN_WINDOW), None)
    return ExtraNote(during=during)


def _walk_skipped(buf: MeasureBuffer, frontier, target) -> List[Tuple[int, int]]:
    """ref matcher.rs:145-165."""
    skipped = []
    walker = tuple(frontier)
    target = tuple(target)
    for _ in range(64):
        if walker == target:
            break
        s = buf.slot(walker)
        if s is None:
            break
        if s.status.kind == PENDING:
            skipped.append(walker)
        walker = step_forward(buf, walker)
    return skipped


def step_forward(buf: MeasureBuffer, key) -> Tuple[int, int]:
    """ref matcher.rs:167-177."""
    nxt = (key[0], key[1] + 1)
    return nxt if buf.slot(nxt) is not None else (key[0] + 1, 0)
