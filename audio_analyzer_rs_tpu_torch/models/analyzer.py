"""Pitch and onset analyzer pipelines (port of the offline halves of
audio_analyzer_rs_tpu/models/analyzer.py; ref src/audio_io/stft.rs:155-441,
src/analysis/onset.rs:104-546).

Pitch: frame → Hann × rDFT magnitude (K1) → per-bin noise-floor scan (K5)
→ harmonic-comb pitch extraction (K2) → PitchTracker scan (K3).  Onset:
frame → Hann × FFT magnitude (cuFFT) → onset scan (K4).  The functions take
a leading stream axis S: state leaves [S, ...], frames [S, N, W], per-frame
inputs [S, N].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import noisefloor, onset as onset_ops, pitch as pitch_ops, tracker
from ..ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                        PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW, windowed_mags)
from ..utils.framing import frame_signal, num_frames


class PitchChunkOut(NamedTuple):
    raw_freqs: torch.Tensor      # [..., N, 8]
    raw_scores: torch.Tensor     # [..., N, 8]
    raw_valid: torch.Tensor      # [..., N, 8]
    stable_freqs: torch.Tensor   # [..., N, 8]
    stable_scores: torch.Tensor  # [..., N, 8]
    stable_valid: torch.Tensor   # [..., N, 8]
    mags: torch.Tensor           # [..., N, B]


def pitch_extract_frames(nf_state, frames, global_floor, sample_rate: float,
                         window: int = PITCH_WINDOW, hop: int = PITCH_HOP,
                         backend: str = PITCH_BACKEND):
    """The frame-parallel front of the pitch pipeline (no tracker): frames
    [S, N, window] → (nf_state, PitchFrame [S, N, 8], mags, eff_floor).

    A backend suffixed "_band" (the default "dft_band") computes only the
    candidate-band bins [0, kc+1) — everything the pitch stages read — and
    the floor recurrence runs on [0, kc) either way (floors above the
    candidate band are never read)."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    band = pitch_ops.candidate_band(bin_width, half)
    if backend.endswith("_band"):
        mags = windowed_mags(frames, window, backend[:-len("_band")],
                             band + 1)
    else:
        mags = windowed_mags(frames, window, backend)
    nf_state, eff_floor = noisefloor.noise_floor_scan(nf_state, mags,
                                                      global_floor, band)
    s, n = mags.shape[:2]
    pf = pitch_ops.extract_pitches(mags.reshape(s * n, -1),
                                   eff_floor.reshape(s * n, -1), bin_width,
                                   true_half=half)
    pf = pitch_ops.PitchFrame(*(a.reshape(s, n, -1) for a in pf))
    return nf_state, pf, mags, eff_floor


def pitch_analyze_frames(nf_state, tr_state, frames, global_floor, onsets,
                         sample_rate: float, window: int = PITCH_WINDOW,
                         hop: int = PITCH_HOP, backend: str = PITCH_BACKEND):
    """Frames [S, N, window] → (nf_state, tr_state, PitchChunkOut): the
    frame-parallel stages, then the batched tracker scan."""
    nf_state, pf, mags, _ = pitch_extract_frames(
        nf_state, frames, global_floor, sample_rate, window, hop, backend)
    tr_state, (sf, ss, sv) = tracker.tracker_scan_batched(
        tr_state, pf.freqs, pf.scores, pf.valid, onsets)
    return nf_state, tr_state, PitchChunkOut(pf.freqs, pf.scores, pf.valid,
                                             sf, ss, sv, mags)


@dataclass
class PitchAnalyzer:
    """Streaming pitch detection (ring buffer + device scans).

    Samples accumulate until >= window, then frames advance by hop
    (ref stft.rs:268-273,436-437).  State lives on `device`; each call
    uploads its samples once and reads the outputs back once."""
    sample_rate: float
    window: int = PITCH_WINDOW
    hop: int = PITCH_HOP
    backend: str = PITCH_BACKEND
    device: str = "cuda"
    # Frames per device call; longer inputs are split with the state
    # carried (the pipeline is a scan, so results are identical).
    max_chunk_frames: int = 4096
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.nf_state = noisefloor.init_state(self.window // 2 + 1,
                                              self.device, (1,))
        self.tr_state = tracker.init_state(self.device, (1,))

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                onset_pending: Optional[np.ndarray] = None,
                onset_first: bool = False):
        """Feed a chunk; returns per-frame outputs as numpy arrays (a
        PitchChunkOut with [n, ...] leaves), or None when no frame
        completed.  `onset_pending`: optional [n_frames] bool onset flags
        (ref stft.rs:387); `onset_first` marks just the first frame."""
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        self._tail = buf[n * self.hop:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        if onset_pending is not None:
            onsets = np.asarray(onset_pending, bool)[:n]
        else:
            onsets = np.zeros(n, bool)
            if onset_first:
                onsets[0] = True
        buf_dev = torch.from_numpy(buf).to(self.device)
        onsets_dev = torch.from_numpy(onsets).to(self.device)
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)[None]
            gf = torch.full((1, c1 - c0), gf_lin, dtype=torch.float32,
                            device=self.device)
            self.nf_state, self.tr_state, out = pitch_analyze_frames(
                self.nf_state, self.tr_state, frames, gf,
                onsets_dev[None, c0:c1], self.sample_rate, self.window,
                self.hop, self.backend)
            outs.append(out)
        return PitchChunkOut(*(torch.cat(parts, 1)[0].cpu().numpy()
                               for parts in zip(*outs)))


class OnsetChunkOut(NamedTuple):
    fired: torch.Tensor          # [..., N] bool
    detected: torch.Tensor       # [..., N] bool
    velocity: torch.Tensor       # [..., N] float32
    flux: torch.Tensor           # [..., N] float32
    energy: torch.Tensor         # [..., N] float32
    burst_count: torch.Tensor    # [..., N] int32
    energy_rising: torch.Tensor  # [..., N] bool
    frames_since: torch.Tensor   # [..., N] int32


def onset_analyze_frames(state, frames, global_floor, tick_suppressed,
                         calibration_hold=None, window: int = ONSET_WINDOW,
                         backend: str = DEFAULT_BACKEND):
    """Frames [S, N, window] → (state, OnsetChunkOut [S, N]): the windowed
    magnitudes (backend "fft": torch.fft, cuFFT on the card, as the JAX
    package uses jnp.fft), then the onset scan (K4 on CUDA tensors)."""
    mags = windowed_mags(frames, window, backend=backend)
    state, out = onset_ops.onset_scan(state, mags, global_floor,
                                      tick_suppressed, calibration_hold)
    return state, OnsetChunkOut(*out)


@dataclass
class OnsetAnalyzer:
    """Streaming onset detection (window 256 / hop 64).  State lives on
    `device`; each call uploads its samples once and reads the outputs back
    once."""
    sample_rate: float
    window: int = ONSET_WINDOW
    hop: int = ONSET_HOP
    backend: str = DEFAULT_BACKEND
    device: str = "cuda"
    # Frames per device call; longer inputs are split with the state carried
    # (the scan makes the results identical).  Onset arrays are [n, 129], so
    # the bound is looser than PitchAnalyzer's.
    max_chunk_frames: int = 131072
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.state = onset_ops.init_state(self.window // 2 + 1, self.device,
                                          (1,))
        self.frames_consumed = 0

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                tick_suppressed: Optional[np.ndarray] = None,
                calibration_hold: bool = False):
        """Feed a chunk; returns per-frame outputs as numpy arrays (an
        OnsetChunkOut with [n] leaves), or None when no frame completed.
        `tick_suppressed`: optional [n_frames] bool; `calibration_hold`
        applies to every frame of the chunk."""
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        self._tail = buf[n * self.hop:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        ts = (np.zeros(n, bool) if tick_suppressed is None
              else np.asarray(tick_suppressed, bool)[:n])
        buf_dev = torch.from_numpy(buf).to(self.device)
        ts_dev = torch.from_numpy(np.ascontiguousarray(ts)).to(self.device)
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)[None]
            gf = torch.full((1, c1 - c0), gf_lin, dtype=torch.float32,
                            device=self.device)
            hold = torch.full((1, c1 - c0), bool(calibration_hold),
                              dtype=torch.bool, device=self.device)
            self.state, out = onset_analyze_frames(
                self.state, frames, gf, ts_dev[None, c0:c1].contiguous(),
                hold, self.window, self.backend)
            outs.append(out)
        self.frames_consumed += n
        return OnsetChunkOut(*(torch.cat(parts, 1)[0].cpu().numpy()
                               for parts in zip(*outs)))
