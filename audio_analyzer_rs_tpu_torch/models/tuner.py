"""Tuner — note/interval identification over stable pitch streams.

Port of ref src/analysis/tuner.rs:1-212: single pitch → note name + cents;
two pitches → Interval with tuning system; 3+ → joined note names.  Commands:
SetKey / SetBaseFreq (clamp 220-880) / SetMode / SetSystem / End.  The Rust
worker thread polling a ring becomes a plain `process(pitches, beat)` call
driven by the engine after each analysis chunk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..theory import Interval, Note

TUNING_SYSTEMS = ("EqualTemperament", "JustIntonation", "Pythagorean")
TUNER_MODES = ("MultiPitch", "SinglePitch")


@dataclass
class TunerOutput:
    """ref tuner.rs:38-56."""
    label: str = ""
    cents: float = 0.0
    notes: List[str] = field(default_factory=list)
    accuracies: List[float] = field(default_factory=list)
    mode: str = "MultiPitch"
    system: str = "EqualTemperament"
    base_freq: float = 440.0
    key: str = "C major"
    beat_position: float = 0.0

    def to_dict(self) -> dict:
        return {"label": self.label, "cents": self.cents, "notes": self.notes,
                "accuracies": self.accuracies, "mode": self.mode,
                "system": self.system, "base_freq": self.base_freq,
                "key": self.key, "beat_position": self.beat_position}


class Tuner:
    def __init__(self):
        self.key = "C major"
        self.base = 440.0
        self.mode = "MultiPitch"
        self.system = "EqualTemperament"
        self.output = TunerOutput()
        self.finished = False
        self._commands: List[tuple] = []

    def send(self, cmd: str, *args) -> None:
        self._commands.append((cmd, *args))

    def _handle_commands(self):
        """ref tuner.rs:117-127."""
        for cmd in self._commands:
            name = cmd[0]
            if name == "SetBaseFreq":
                self.base = float(np.clip(cmd[1], 220.0, 880.0))
            elif name == "SetKey":
                self.key = cmd[1]
            elif name == "SetMode":
                self.mode = cmd[1]
            elif name == "SetSystem":
                self.system = cmd[1]
            elif name == "End":
                self.finished = True
        self._commands.clear()

    def process(self, notes_data: List[Tuple[float, float]],
                beat_pos: float) -> None:
        """One (pitches, beat) hop (ref tuner.rs:134-211)."""
        self._handle_commands()
        if self.finished or not notes_data:
            return
        note_names: List[str] = []
        accuracies: List[float] = []
        cents = 0.0
        if len(notes_data) == 1 or self.mode == "SinglePitch":
            best = max(notes_data, key=lambda p: p[1])
            note = Note.from_freq(best[0], self.base)
            label = note.get_name()
            cents = note.get_cents()
            note_names.append(note.get_name())
            accuracies.append(note.get_cents())
        elif len(notes_data) == 2:
            freqs = sorted(f for f, _ in notes_data)
            interval = Interval.new(freqs, self.system)
            for f in freqs:
                n = Note.from_freq(f, self.base)
                note_names.append(n.get_name())
                accuracies.append(n.get_cents())
            label = interval.get_name()
            cents = interval.get_accuracy()
        else:
            for f, _ in notes_data:
                n = Note.from_freq(f, self.base)
                note_names.append(n.get_name())
                accuracies.append(n.get_cents())
            label = " ".join(note_names)

        self.output = TunerOutput(
            label=label, cents=cents, notes=note_names,
            accuracies=accuracies, mode=self.mode, system=self.system,
            base_freq=self.base, key=self.key, beat_position=beat_pos)
