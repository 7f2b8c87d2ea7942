"""Music theory: notes, MIDI notes, intervals, keys.

Behavioral parity with the reference `src/analysis/theory.rs:1-692`
(MidiNote :6-56, Note :92-251, Interval :278-391, Key :392-397,630-692).
All frequency math is done in float32 like the Rust f32 implementation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

_NAMES = ("C", "D", "E", "F", "G", "A", "B")

# Semitone offset of each natural name relative to A (ref theory.rs:170-178).
_NAME_SEMIS = {"C": -9, "D": -7, "E": -5, "F": -4, "G": -2, "A": 0, "B": 2}

_ACCIDENTAL_SEMIS = {
    "sharp": 1,
    "flat": -1,
    "natural": 0,
    "double_sharp": 2,
    "double_flat": -2,
}

_ACCIDENTAL_STR = {
    "sharp": "#",
    "flat": "b",
    "natural": "",
    "double_sharp": "x",
    "double_flat": "bb",
}

# Chromatic scale used by Note.from_freq (ref theory.rs:207-220).
_CHROMATIC = (
    ("C", None), ("C", "sharp"), ("D", None), ("D", "sharp"), ("E", None),
    ("F", None), ("F", "sharp"), ("G", None), ("G", "sharp"), ("A", None),
    ("A", "sharp"), ("B", None),
)


def _f32(x) -> float:
    return float(np.float32(x))


def _fold_cents_f32(log_cents: float) -> float:
    """cents = log % 100; fold to (-50, 50] the way Rust f32 `%` does."""
    cents = _f32(math.fmod(np.float32(log_cents), np.float32(100.0)))
    if cents >= 50.0:
        cents = _f32(-(np.float32(100.0) - np.float32(cents)))
    return cents


class MidiNote:
    """MIDI number + cents deviation (ref theory.rs:6-56)."""

    def __init__(self, midi: int, cents: float):
        self.midi = midi
        self.cents = cents

    @classmethod
    def from_freq(cls, freq: float, base_freq: Optional[float] = None) -> "MidiNote":
        base = np.float32(base_freq if base_freq is not None else 440.0)
        base = np.float32(base * np.float32(2.0) ** np.float32(-4.75))
        log = _f32(np.float32(math.log2(np.float32(freq) / base)) * np.float32(1200.0))
        cents = _fold_cents_f32(log)
        # Rust `as u8` saturates to [0, 255].
        midi = int(np.clip(round(_f32(np.float32(log) / np.float32(100.0))), 0, 243)) + 12
        return cls(min(midi, 255), cents)

    @classmethod
    def from_note(cls, note: "Note") -> "MidiNote":
        return cls.from_freq(note.to_freq(None), None)

    @classmethod
    def from_note_name(cls, name: str) -> "MidiNote":
        return cls.from_note(Note(name))

    def to_freq(self, base_freq: Optional[float] = None) -> float:
        base = np.float32(base_freq if base_freq is not None else 440.0)
        exp = (np.float32(self.midi) - np.float32(69.0)
               + np.float32(self.cents) / np.float32(100.0)) / np.float32(12.0)
        return _f32(base * np.float32(2.0) ** exp)

    def __str__(self) -> str:
        sign = "+" if self.cents >= 0.0 else ""
        return f"{self.midi} {sign}{self.cents:.4f}"


class Note:
    """Scientific-pitch note with cents deviation (ref theory.rs:92-251)."""

    def __init__(self, note: Optional[str] = None, *, name: str = "C",
                 accidental: Optional[str] = None, octave: int = 4,
                 cents: float = 0.0):
        if note is not None:
            name, accidental, octave = self._parse(note)
            cents = 0.0
        self.name = name
        self.accidental = accidental
        self.octave = octave
        self.cents = cents

    # ── parsing (ref theory.rs:104-167) ─────────────────────────────────

    @classmethod
    def try_new(cls, note: str):
        """Returns (Note, None) or (None, error_message)."""
        try:
            return cls(note), None
        except ValueError as e:
            return None, str(e)

    @staticmethod
    def _parse(note: str):
        b = note
        if len(b) < 2:
            raise ValueError(
                f'Note name "{note}" is too short — expected format like "C#4" or "A4"')
        if b[0] not in _NAME_SEMIS:
            raise ValueError(
                f"Invalid note letter '{b[0]}' in \"{note}\" — expected one of C D E F G A B")
        name = b[0]
        if b[1] == "#":
            accidental, octave_start = "sharp", 2
        elif b[1] == "b":
            accidental, octave_start = "flat", 2
        elif len(b) > 2 and b[1] == "x":
            accidental, octave_start = "double_sharp", 2
        elif len(b) > 2 and b[1] == "B":
            accidental, octave_start = "double_flat", 2
        elif b[1] == "n":
            accidental, octave_start = "natural", 2
        else:
            accidental, octave_start = None, 1
        octave_str = note[octave_start:]
        try:
            octave = int(octave_str)
            if octave < 0:
                raise ValueError
        except ValueError:
            raise ValueError(
                f'Invalid octave "{octave_str}" in "{note}" — expected a number like 4')
        return name, accidental, octave

    # ── conversions (ref theory.rs:169-233) ─────────────────────────────

    def to_freq(self, base_freq: Optional[float] = None) -> float:
        num_semis = _NAME_SEMIS[self.name]
        if self.accidental is not None:
            num_semis += _ACCIDENTAL_SEMIS[self.accidental]
        num_semis += (self.octave - 4) * 12
        base = np.float32(base_freq if base_freq is not None else 440.0)
        exp = (np.float32(num_semis) + np.float32(self.cents) / np.float32(100.0)) / np.float32(12.0)
        return _f32(base * np.float32(2.0) ** exp)

    @classmethod
    def from_freq(cls, freq: float, base_freq: Optional[float] = None) -> "Note":
        base = np.float32(base_freq if base_freq is not None else 440.0)
        base = np.float32(base * np.float32(2.0) ** np.float32(-4.75))
        log = _f32(np.float32(math.log2(np.float32(freq) / base)) * np.float32(1200.0))
        octave = int(np.clip((np.float32(log) + np.float32(50.0)) / np.float32(1200.0), 0, 255))
        semis = int(round(_f32(np.float32(log) / np.float32(100.0)))) % 12
        cents = _fold_cents_f32(log)
        name, accidental = _CHROMATIC[semis]
        return cls(name=name, accidental=accidental, octave=octave, cents=cents)

    @classmethod
    def from_midi(cls, midi: int) -> "Note":
        return cls.from_freq(MidiNote(midi, 0.0).to_freq(None), None)

    def get_name(self) -> str:
        acc = _ACCIDENTAL_STR[self.accidental] if self.accidental else ""
        return f"{self.name}{acc}{self.octave}"

    def get_cents(self) -> float:
        return self.cents

    def __str__(self) -> str:
        acc = _ACCIDENTAL_STR[self.accidental] if self.accidental else ""
        sign = "+" if self.cents >= 0.0 else ""
        return f"{self.name}{acc}{self.octave} {sign}{self.cents:.3f}"


# ── Intervals (ref theory.rs:278-391) ───────────────────────────────────

_INT_NAMES = ("Per8", "Min2", "Maj2", "Min3", "Maj3", "Per4", "Aug4",
              "Per5", "Min6", "Maj6", "Min7", "Maj7", "Per8")

_RATIOS_ET = np.array(
    [1.0, 1.0595, 1.1225, 1.1892, 1.2599, 1.3348, 1.4142, 1.4983, 1.5874,
     1.6818, 1.7818, 1.8877, 2.0], dtype=np.float32)
_RATIOS_JUST = np.array(
    [1.0, 16/15, 9/8, 6/5, 5/4, 4/3, 45/32, 3/2, 8/5, 5/3, 9/5, 15/8, 2.0],
    dtype=np.float32)
_RATIOS_PYTH = np.array(
    [1.0, 256/243, 9/8, 32/27, 81/64, 4/3, 729/512, 3/2, 128/81, 27/16,
     32/9, 243/128, 2.0], dtype=np.float32)


@dataclass
class Interval:
    name: str
    accuracy: float

    @classmethod
    def new(cls, freqs: Sequence[float], system: Optional[str] = None) -> "Interval":
        if len(freqs) < 2 or freqs[0] == 0.0:
            return cls("Per8", 0.0)
        ratio = np.float32(freqs[1]) / np.float32(freqs[0])
        while ratio > 2.0:
            ratio = np.float32(ratio / np.float32(2.0))
        if system == "JustIntonation":
            ratios = _RATIOS_JUST
        elif system == "Pythagorean":
            ratios = _RATIOS_PYTH
        else:
            ratios = _RATIOS_ET
        idx = int(np.argmin(np.abs(ratio - ratios)))
        accuracy = _f32(-np.float32(math.log(ratios[idx] / ratio)) * np.float32(1732.5))
        return cls(_INT_NAMES[idx], accuracy)

    def get_name(self) -> str:
        return self.name

    def get_accuracy(self) -> float:
        return self.accuracy


# ── Keys (ref theory.rs:630-692) ────────────────────────────────────────

_QUALITY_SEMIS = {
    "Major":        (2, 2, 1, 2, 2, 2, 1),
    "Minor":        (2, 1, 2, 2, 1, 2, 2),
    "Harmonic":     (2, 1, 2, 2, 1, 3, 1),
    "Melodic":      (2, 1, 2, 2, 2, 2, 1),
    "Ionian":       (2, 2, 1, 2, 2, 2, 1),
    "Dorian":       (2, 1, 2, 2, 2, 1, 2),
    "Phrygian":     (1, 2, 2, 2, 1, 2, 2),
    "Lydian":       (2, 2, 2, 1, 2, 2, 1),
    "Mixolydian":   (2, 2, 1, 2, 2, 1, 2),
    "Aeolian":      (2, 1, 2, 2, 1, 2, 2),
    "Locrian":      (1, 2, 2, 1, 2, 2, 2),
}


class Key:
    def __init__(self, key: str):
        parts = key.split()
        if not parts:
            raise ValueError("invalid format")
        first = parts[0]
        if first[0] not in _NAME_SEMIS:
            raise ValueError("Invalid note name")
        self.name = first[0]
        self.accidental = None
        if len(first) > 1:
            self.accidental = {"#": "sharp", "x": "double_sharp", "b": "flat",
                               "n": "natural", "B": "double_flat"}.get(first[1])
        quality = parts[1] if len(parts) > 1 else "Major"
        if quality not in _QUALITY_SEMIS:
            raise ValueError("Invalid key")
        self.quality = quality
        self.semis_map = _QUALITY_SEMIS[quality]


def note_name_to_midi(name: str) -> Optional[int]:
    """Parse "C#4"-style note names to MIDI numbers (ref practice/mod.rs:566-591)."""
    if not name:
        return None
    semitone_map = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
    if name[0] not in semitone_map:
        return None
    semitone = semitone_map[name[0]]
    if len(name) < 2:
        return None
    nxt = name[1]
    if nxt == "#":
        accidental, octave_str = 1, name[2:]
    elif nxt == "b":
        accidental, octave_str = -1, name[2:]
    else:
        accidental, octave_str = 0, name[1:]
    try:
        octave = int(octave_str)
    except ValueError:
        return None
    midi = (octave + 1) * 12 + semitone + accidental
    return midi if 0 <= midi <= 127 else None


def freq_to_midi(freq: float) -> int:
    """Round a frequency to the nearest MIDI number (ref practice/buffer.rs:303-305)."""
    return int(np.clip(round(69.0 + 12.0 * math.log2(np.float32(freq) / np.float32(440.0))), 0, 127))
