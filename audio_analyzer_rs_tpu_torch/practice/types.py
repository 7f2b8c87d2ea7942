"""Shared practice-engine types (ref src/practice/types.rs:1-93)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

PRACTICE_MODES = ("FollowAlong", "Performance", "Rubato")


def practice_mode_from_str(s: str) -> Optional[str]:
    """Lenient mode parsing (ref types.rs:13-21)."""
    m = s.lower()
    if m in ("followalong", "follow_along", "follow-along"):
        return "FollowAlong"
    if m == "performance":
        return "Performance"
    if m == "rubato":
        return "Rubato"
    return None


@dataclass
class TunerFrame:
    """One tuner analysis hop (ref types.rs:24-28)."""
    notes: List[Tuple[int, float]]   # (midi_note, cents)
    tuner_beat: float                # already calibrated


# Start sources (ref types.rs:30-35).
ONSET = "Onset"
STABLE_FIVE_FRAME = "StableFiveFrame"
TRANSIENT_CLUSTER = "TransientCluster"


@dataclass
class TrackedNoteStart:
    seq: int
    midi_note: int
    start_beat: float
    start_source: str
    initial_cents: float


@dataclass
class TrackedNoteEnd:
    seq: int
    midi_note: int
    end_beat: float
    avg_cents: float
    frame_count: int


@dataclass
class Matched:
    key: Tuple[int, int]
    timing_err: float
    pitch_correct: bool
    upgrade: bool
    skipped_keys: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class DoubledNote:
    key: Tuple[int, int]


@dataclass
class ExtraNote:
    during: Optional[Tuple[int, int]]


# Clock actions (ref types.rs:74-80).
@dataclass
class SeekToBeat:
    beat: float


class Stop:
    pass


class Play:
    pass


@dataclass
class SetBpm:
    bpm: float
