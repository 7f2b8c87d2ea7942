"""Minimal Standard MIDI File (SMF) parser → sequencer Measures.

Replaces the reference's `midly`-based loader (ref src/generators/mod.rs:111-277)
with a self-contained parser (no pip deps available for MIDI).  Semantics match
`load_midi_file` exactly: metrical timing only, all tracks merged by absolute
tick, NoteOn/NoteOff pairing (velocity-0 NoteOn = NoteOff), tempo and
time-signature change tracking with a BPM-override ratio, and slicing into
measures with notes timed relative to their measure start.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

MAX_MIDI_VELOCITY = 127.0  # ref src/generators/mod.rs:19


@dataclass
class SynthNote:
    """ref src/generators/mod.rs:52-59 (velocity normalized 0..1)."""
    freq: float
    start_beat_in_measure: float
    duration_beats: float
    velocity: float
    instrument: str = "Piano"


@dataclass
class Measure:
    """ref src/generators/mod.rs:85-109."""
    notes: List[SynthNote] = field(default_factory=list)
    time_signature: Tuple[int, int] = (4, 4)
    bpm: float = 120.0
    global_start_beat: float = 0.0

    def duration_beats(self) -> float:
        return self.time_signature[0] * 4.0 / self.time_signature[1]

    def get_pattern(self) -> List[str]:
        """Downbeat-strong metronome pattern (ref generators/mod.rs:100-108)."""
        return ["Strong"] + ["Weak"] * (self.time_signature[0] - 1)


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


@dataclass
class _AbsEvent:
    abs_tick: int
    kind: str            # "tempo" | "timesig" | "on" | "off"
    data: tuple


def parse_smf(blob: bytes) -> Tuple[float, List[_AbsEvent]]:
    """Parse an SMF byte blob → (ticks_per_beat, merged+sorted abs events)."""
    if blob[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    hlen = struct.unpack(">I", blob[4:8])[0]
    _fmt, ntrks, division = struct.unpack(">HHH", blob[8:14])
    if division & 0x8000:
        raise ValueError("Timecode timing not supported, only Metrical")
    ticks_per_beat = float(division)

    events: List[_AbsEvent] = []
    pos = 8 + hlen
    for _ in range(ntrks):
        if blob[pos:pos + 4] != b"MTrk":
            raise ValueError("malformed MIDI: expected MTrk")
        tlen = struct.unpack(">I", blob[pos + 4:pos + 8])[0]
        track = blob[pos + 8:pos + 8 + tlen]
        pos += 8 + tlen
        tpos, abs_tick, running_status = 0, 0, 0
        while tpos < len(track):
            delta, tpos = _read_varlen(track, tpos)
            abs_tick += delta
            status = track[tpos]
            if status & 0x80:
                tpos += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status
            if status == 0xFF:                      # meta event
                meta_type = track[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(track, tpos)
                body = track[tpos:tpos + mlen]
                tpos += mlen
                if meta_type == 0x51 and mlen >= 3:  # tempo
                    micros = (body[0] << 16) | (body[1] << 8) | body[2]
                    events.append(_AbsEvent(abs_tick, "tempo", (micros,)))
                elif meta_type == 0x58 and mlen >= 2:  # time signature
                    events.append(_AbsEvent(abs_tick, "timesig",
                                            (body[0], 2 ** body[1])))
            elif status in (0xF0, 0xF7):            # sysex
                mlen, tpos = _read_varlen(track, tpos)
                tpos += mlen
            else:
                hi = status & 0xF0
                if hi in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = track[tpos], track[tpos + 1]
                    tpos += 2
                    if hi == 0x90:
                        events.append(_AbsEvent(
                            abs_tick, "on" if d2 > 0 else "off", (d1, d2)))
                    elif hi == 0x80:
                        events.append(_AbsEvent(abs_tick, "off", (d1, d2)))
                elif hi in (0xC0, 0xD0):
                    tpos += 1
                else:
                    raise ValueError(f"unexpected MIDI status byte {status:#x}")
    events.sort(key=lambda e: e.abs_tick)
    return ticks_per_beat, events


def load_midi_file(path: str, instrument: str = "Piano",
                   bpm: Optional[float] = None) -> List[Measure]:
    """Parse a MIDI file into Measures (ref src/generators/mod.rs:112-277)."""
    with open(path, "rb") as f:
        blob = f.read()
    return load_midi_bytes(blob, instrument, bpm)


def load_midi_bytes(blob: bytes, instrument: str = "Piano",
                    bpm: Optional[float] = None) -> List[Measure]:
    ticks_per_beat, events = parse_smf(blob)

    current_bpm = bpm if bpm is not None else 120.0
    active_notes: List[Optional[Tuple[int, int]]] = [None] * 128
    final_notes_abs: List[Tuple[int, float, float, float]] = []  # (note, start, end, vel)
    sig_changes: List[Tuple[float, int, int]] = []
    bpm_changes: List[Tuple[float, float]] = []

    for ev in events:
        beat = ev.abs_tick / ticks_per_beat
        if ev.kind == "tempo":
            bpm_changes.append((beat, 60_000_000.0 / ev.data[0]))
        elif ev.kind == "timesig":
            sig_changes.append((beat, ev.data[0], ev.data[1]))
        elif ev.kind == "on":
            key, vel = ev.data
            active_notes[key] = (ev.abs_tick, vel)
        elif ev.kind == "off":
            key, _ = ev.data
            if active_notes[key] is not None:
                start_tick, start_vel = active_notes[key]
                final_notes_abs.append(
                    (key, start_tick / ticks_per_beat, beat, start_vel / 127.0))
                active_notes[key] = None

    max_beat = max((n[2] for n in final_notes_abs), default=0.0)
    measures: List[Measure] = []
    cursor, sig_idx, bpm_idx = 0.0, 0, 0
    current_time_sig = (4, 4)
    first_file_bpm = bpm_changes[0][1] if bpm_changes else current_bpm
    bpm_ratio = current_bpm / first_file_bpm

    while cursor < max_beat or cursor == 0.0:
        if sig_idx < len(sig_changes) and sig_changes[sig_idx][0] <= cursor + 0.001:
            current_time_sig = (sig_changes[sig_idx][1], sig_changes[sig_idx][2])
            sig_idx += 1
        if bpm_idx < len(bpm_changes) and bpm_changes[bpm_idx][0] <= cursor + 0.001:
            current_bpm = bpm_changes[bpm_idx][1] * bpm_ratio
            bpm_idx += 1

        beats_in_measure = current_time_sig[0] * 4.0 / current_time_sig[1]
        end_of_measure = cursor + beats_in_measure
        measure_notes = [
            SynthNote(
                freq=float(np.float32(440.0)
                           * np.float32(2.0) ** (np.float32(note - 69) / np.float32(12.0))),
                start_beat_in_measure=float(np.float32(start - cursor)),
                duration_beats=float(np.float32(end - start)),
                velocity=vel,
                instrument=instrument,
            )
            for (note, start, end, vel) in final_notes_abs
            if cursor <= start < end_of_measure
        ]
        measures.append(Measure(notes=measure_notes,
                                time_signature=current_time_sig,
                                bpm=current_bpm,
                                global_start_beat=cursor))
        cursor = end_of_measure
        if beats_in_measure <= 0.0:
            break
    return measures


# ── SMF writer (for tests and the CLI sim; the reference has no writer) ──

def write_midi_file(path: str, notes: List[Tuple[int, float, float, int]],
                    ticks_per_beat: int = 480, bpm: float = 120.0,
                    time_signature: Tuple[int, int] = (4, 4)) -> None:
    """Write a single-track SMF. notes: [(midi, start_beat, dur_beats, velocity)]."""
    def varlen(v: int) -> bytes:
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(out))

    events: List[Tuple[int, bytes]] = []
    micros = int(round(60_000_000 / bpm))
    events.append((0, bytes([0xFF, 0x51, 0x03]) + micros.to_bytes(3, "big")))
    den_pow = int(np.log2(time_signature[1]))
    events.append((0, bytes([0xFF, 0x58, 0x04, time_signature[0], den_pow, 24, 8])))
    for midi, start, dur, vel in notes:
        on_tick = int(round(start * ticks_per_beat))
        off_tick = int(round((start + dur) * ticks_per_beat))
        events.append((on_tick, bytes([0x90, midi, vel])))
        events.append((off_tick, bytes([0x80, midi, 0])))
    events.sort(key=lambda e: e[0])

    body = b""
    last = 0
    for tick, payload in events:
        body += varlen(tick - last) + payload
        last = tick
    body += varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_beat))
        f.write(b"MTrk" + struct.pack(">I", len(body)) + body)
