"""Practice engine: session scoring against a MIDI reference.

Public practice-level types (ref src/practice/mod.rs:22-88): AbilityLevel
tolerance scaling, SendInfo live-feedback events, MusicError categories.
"""

from __future__ import annotations

from dataclasses import dataclass

ABILITY_LEVELS = ("Beginner", "Intermediate", "Advanced", "Pro")

# MusicError variants (ref practice/mod.rs:65-88).
MUSIC_ERRORS = ("Timing", "WrongNote", "UnexpectedNote", "MissingNote",
                "Intonation", "Dynamics", "Tempo", "HeldTooLong",
                "HeldTooShort", "None")


def ability_tolerance_scale(level: str) -> float:
    """ref practice/mod.rs:38-46."""
    return {"Beginner": 2.0, "Intermediate": 1.5,
            "Advanced": 1.0, "Pro": 0.7}[level]


@dataclass
class SendInfo:
    """Rich per-note feedback event (ref practice/mod.rs:52-63)."""
    measure: int
    note_index: int
    error_type: str
    intensity: float
    expected: str
    received: str

    def to_dict(self) -> dict:
        return {"measure": self.measure, "note_index": self.note_index,
                "error_type": self.error_type, "intensity": self.intensity,
                "expected": self.expected, "received": self.received}
