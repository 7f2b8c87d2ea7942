"""Dev-tools visualization — the reference's feature-gated debug telemetry.

Port of the `dev-tools` feature (ref Cargo.toml:17, src/audio_io/stft.rs:
674-931, src/analysis/onset.rs:559-651): per-frame spectrum / noise-floor /
pitch streaming plus periodic 3-panel PNG export (raw signal, windowed
signal, log-frequency spectrum with floor + pitch labels), and per-frame
onset *decision telemetry* (which gate blocked a candidate: tick / energy /
frame gate / tracker).

The Rerun live viewer becomes an in-memory `DebugRecorder` ring (drainable as
dicts / JSONL for any frontend); the plotters PNG export becomes matplotlib.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import asdict, dataclass
from typing import List

import numpy as np



def freq_to_note_label(freq: float) -> str:
    """Nearest note name + cents (ref stft.rs:652-669)."""
    if freq <= 0.0:
        return "?"
    midi = 69.0 + 12.0 * np.log2(freq / 440.0)
    midi_round = int(round(midi))
    names = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
    name = names[midi_round % 12]
    octave = midi_round // 12 - 1
    cents = int((midi - round(midi)) * 100.0)
    return f"{name}{octave}" if cents == 0 else f"{name}{octave} {cents:+}¢"


@dataclass
class PitchFrameRecord:
    frame: int
    magnitudes: np.ndarray
    noise_floor: np.ndarray
    bin_width: float
    stable_pitches: List[tuple]          # (freq, score)

    def to_dict(self) -> dict:
        return {"frame": self.frame, "bin_width": self.bin_width,
                "stable_pitches": [
                    {"freq": f, "score": s,
                     "label": freq_to_note_label(f)}
                    for f, s in self.stable_pitches]}


@dataclass
class OnsetFrameRecord:
    """Per-frame decision telemetry (ref onset.rs:458-533)."""
    frame: int
    flux: float
    burst_count: int
    detected: bool
    fired: bool
    status: str                           # DETECTED / blocked: … / candidate / idle

    def to_dict(self) -> dict:
        return asdict(self)


def onset_status(fired: bool, detected: bool, tick_suppressed: bool,
                 energy_rising: bool, frames_since_onset: int,
                 flux: float, burst_count: int) -> str:
    """Decision label logic (ref onset.rs:471-519)."""
    if fired:
        return f"DETECTED flux={flux:.1f} burst={burst_count}"
    if detected and tick_suppressed:
        return "blocked: tick"
    if detected and not energy_rising:
        return "blocked: energy"
    if detected and frames_since_onset < 3:
        return f"blocked: frame gate (gap={frames_since_onset})"
    if flux > 0.0 or burst_count > 0:
        return (f"candidate: flux={flux:.1f} (tracker rejected), "
                f"burst={burst_count}")
    return "idle"


class DebugRecorder:
    """Bounded ring of debug records — the Rerun-stream equivalent."""

    def __init__(self, max_frames: int = 4096):
        self.pitch_frames: deque = deque(maxlen=max_frames)
        self.onset_frames: deque = deque(maxlen=max_frames)

    def log_pitch_frame(self, frame, magnitudes, noise_floor, bin_width,
                        stable_pitches):
        self.pitch_frames.append(PitchFrameRecord(
            frame=frame, magnitudes=np.asarray(magnitudes),
            noise_floor=np.asarray(noise_floor), bin_width=bin_width,
            stable_pitches=list(stable_pitches)))

    def log_onset_frame(self, record: OnsetFrameRecord):
        self.onset_frames.append(record)

    def drain_jsonl(self) -> str:
        lines = [json.dumps({"kind": "pitch", **r.to_dict()})
                 for r in self.pitch_frames]
        lines += [json.dumps({"kind": "onset", **r.to_dict()})
                  for r in self.onset_frames]
        self.pitch_frames.clear()
        self.onset_frames.clear()
        return "\n".join(lines)


class JsonlStreamRecorder(DebugRecorder):
    """DebugRecorder that also streams every record to a JSONL file live.

    The Rerun-viewer equivalent of the reference's per-frame streaming
    (ref stft.rs:674-747, onset.rs:559-651): each logged frame is written
    and flushed immediately, so `tail -f <path>` (or any frontend watching
    the file) sees spectrum/pitch/onset decisions as the analysis runs —
    not just a post-hoc drain.  `include_spectrum=True` adds the per-frame
    magnitude/floor arrays to pitch lines (heavier; the default streams the
    decision telemetry only, like `to_dict`)."""

    def __init__(self, path: str, max_frames: int = 4096,
                 include_spectrum: bool = False):
        super().__init__(max_frames)
        self._file = open(path, "w")
        self._include_spectrum = include_spectrum

    def _emit(self, record: dict) -> None:
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_pitch_frame(self, frame, magnitudes, noise_floor, bin_width,
                        stable_pitches):
        super().log_pitch_frame(frame, magnitudes, noise_floor, bin_width,
                                stable_pitches)
        rec = {"kind": "pitch", **self.pitch_frames[-1].to_dict()}
        if self._include_spectrum:
            rec["magnitudes"] = np.asarray(magnitudes, np.float32).tolist()
            rec["noise_floor"] = np.asarray(noise_floor, np.float32).tolist()
        self._emit(rec)

    def log_onset_frame(self, record: OnsetFrameRecord):
        super().log_onset_frame(record)
        self._emit({"kind": "onset", **record.to_dict()})

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


class DebugStreamView:
    """Terminal renderer for the JSONL debug stream — the live-viewer half
    of the Rerun analog (ref stft.rs:674-747 streams spectrum/pitches into
    the Rerun GUI; onset.rs:559-651 streams decision labels).

    Feed it parsed JSONL records (`JsonlStreamRecorder` output); it keeps a
    rolling status (latest pitch labels, median floor when the stream
    carries spectra, last onset decision) and returns an *event line* for
    moments worth scrolling (fired onsets, pitch-set changes) — the
    surrounding loop decides how to print.  Pure logic, no I/O: the CLI
    (`cli.py debug-view`) owns the terminal."""

    def __init__(self):
        self.pitch_labels: list = []
        self.floor_db: float | None = None
        self.onset_status = "idle"
        self.n_pitch = self.n_onset = self.n_fired = 0
        self.last_frame = 0

    def feed(self, rec: dict) -> str | None:
        kind = rec.get("kind")
        if kind == "pitch":
            self.n_pitch += 1
            self.last_frame = rec.get("frame", self.last_frame)
            labels = [p.get("label", f"{p.get('freq', 0.0):.1f}Hz")
                      for p in rec.get("stable_pitches", [])]
            if "noise_floor" in rec:
                nf = np.asarray(rec["noise_floor"], np.float64)
                med = float(np.median(nf[nf > 0])) if (nf > 0).any() else 0.0
                self.floor_db = (20.0 * np.log10(med) if med > 0 else None)
            changed = labels != self.pitch_labels
            self.pitch_labels = labels
            if changed and labels:
                return (f"[pitch  f{rec.get('frame', 0):>6}] "
                        + "  ".join(labels))
            return None
        if kind == "onset":
            self.n_onset += 1
            self.onset_status = rec.get("status", "idle")
            if rec.get("fired"):
                self.n_fired += 1
                return (f"[ONSET  f{rec.get('frame', 0):>6}] "
                        f"{self.onset_status}")
            return None
        return None

    def status_line(self) -> str:
        pitches = "  ".join(self.pitch_labels) if self.pitch_labels else "—"
        floor = (f"{self.floor_db:+.1f} dB" if self.floor_db is not None
                 else "n/a")
        return (f"f{self.last_frame:>6} | pitches: {pitches:<24} | "
                f"floor: {floor} | onsets: {self.n_fired:>3} | "
                f"{self.onset_status}")


def export_frame_png(path: str, raw: np.ndarray, windowed: np.ndarray,
                     magnitudes: np.ndarray, bin_width: float,
                     noise_floor: np.ndarray,
                     stable_pitches: List[tuple],
                     min_freq: float = 24.0, max_freq: float = 10_000.0,
                     frame: int = 0) -> None:
    """3-panel debug PNG (ref stft.rs:754-930): raw, windowed (shared y
    range), log-frequency spectrum with per-bin floor + pitch labels."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, figsize=(10, 15))
    y_pad = (raw.max() - raw.min()) * 0.05
    y_lo, y_hi = raw.min() - y_pad, raw.max() + y_pad
    if abs(y_hi - y_lo) < 1e-10:
        y_lo, y_hi = y_lo - 1.0, y_hi + 1.0

    ax1.plot(raw, color="#d16666", linewidth=0.8)
    ax1.set_title(f"Raw Signal — Frame {frame}")
    ax1.set_ylim(y_lo, y_hi)

    ax2.plot(windowed, color="#d16666", linewidth=0.8)
    ax2.set_title("Hann-Windowed Signal")
    ax2.set_ylim(y_lo, y_hi)

    half = len(magnitudes)
    min_bin = max(int(np.ceil(min_freq / bin_width)), 1)
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 1)
    freqs = np.arange(min_bin, max_bin + 1) * bin_width
    ax3.plot(freqs, magnitudes[min_bin:max_bin + 1], color="#d16666",
             linewidth=0.8, label="spectrum")
    ax3.plot(freqs, noise_floor[min_bin:max_bin + 1], color="#a14b4b",
             linewidth=0.8, label="noise floor")
    ax3.set_xscale("log")
    ax3.set_title("FFT Spectrum — Detected Pitches")
    for f, score in stable_pitches:
        if not (min_freq <= f <= max_freq):
            continue
        b = int(round(f / bin_width))
        y = magnitudes[min(b, half - 1)]
        ax3.plot([f], [y], "o", color="#a14b4b")
        ax3.annotate(f"{freq_to_note_label(f)} {score:.1f}", (f, y),
                     textcoords="offset points", xytext=(0, 8), fontsize=9)
    ax3.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
