"""One-call buffer analysis: audio in → per-frame feature structs out (port
of audio_analyzer_rs_tpu/analysis.py).

A mono buffer goes in; per-frame features come out: spectrogram, RMS and
energy, centroid, rolloff, flux, polyphonic pitches, stable pitches,
onsets and the YIN f0.  This is the offline face of the same kernels the
segmented paths use.  Both entry points take `device` (default "cuda").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .models.analyzer import OnsetAnalyzer, PitchAnalyzer
from .ops.features import feature_pack
from .ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                       PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW, windowed_mags)
from .ops.yin import yin_pitch
from .utils.framing import frame_signal, num_frames


@dataclass
class FrameFeatures:
    """Per-frame feature struct (one pitch-geometry frame)."""
    time_s: float
    rms: float
    energy: float
    centroid_hz: float
    rolloff_hz: float
    flux: float
    yin_f0_hz: float
    yin_voiced: bool
    pitches: List[tuple]          # raw (freq, score), up to 8
    stable_pitches: List[tuple]   # hysteresis-stable (freq, score)


@dataclass
class AnalysisResult:
    sample_rate: float
    frames: List[FrameFeatures]
    spectrogram: np.ndarray       # [N, 1025] magnitudes
    onsets: List[dict]            # {"time_s", "frame", "velocity"}

    def to_dicts(self) -> List[dict]:
        return [vars(f) for f in self.frames]


@dataclass
class AnalysisArrays:
    """Columnar variant of AnalysisResult: every per-frame feature as one
    array over all N frames."""
    sample_rate: float
    time_s: np.ndarray            # [N]
    rms: np.ndarray               # [N]
    energy: np.ndarray            # [N]
    centroid_hz: np.ndarray       # [N]
    rolloff_hz: np.ndarray        # [N]
    flux: np.ndarray              # [N]
    yin_f0_hz: np.ndarray         # [N]
    yin_voiced: np.ndarray        # [N] bool
    raw_freqs: np.ndarray         # [N, 8]
    raw_scores: np.ndarray        # [N, 8]
    raw_valid: np.ndarray         # [N, 8] bool
    stable_freqs: np.ndarray      # [N, 8]
    stable_scores: np.ndarray     # [N, 8]
    stable_valid: np.ndarray      # [N, 8] bool
    spectrogram: np.ndarray       # [N, 1025]
    onsets: List[dict]            # {"time_s", "frame", "velocity"}


def _onset_events(fired: np.ndarray, velocity: np.ndarray,
                  sample_rate: float) -> List[dict]:
    """Onset frame flags → event dicts (the shared frame → time rule)."""
    return [{"time_s": (int(i) * ONSET_HOP + ONSET_WINDOW // 2) / sample_rate,
             "frame": int(i), "velocity": float(velocity[i])}
            for i in np.flatnonzero(fired)]


def _empty_arrays(sample_rate: float, onsets: List[dict]) -> AnalysisArrays:
    def z(shape=(0,), dt=np.float32):
        return np.zeros(shape, dt)
    return AnalysisArrays(
        sample_rate=sample_rate, time_s=z(), rms=z(), energy=z(),
        centroid_hz=z(), rolloff_hz=z(), flux=z(), yin_f0_hz=z(),
        yin_voiced=z(dt=bool), raw_freqs=z((0, 8)), raw_scores=z((0, 8)),
        raw_valid=z((0, 8), bool), stable_freqs=z((0, 8)),
        stable_scores=z((0, 8)), stable_valid=z((0, 8), bool),
        spectrogram=z((0, PITCH_WINDOW // 2 + 1)), onsets=onsets)


def _frame_times(n: int, sample_rate: float) -> np.ndarray:
    return ((np.arange(n) * PITCH_HOP + PITCH_WINDOW / 2) / sample_rate
            ).astype(np.float32)


def analyze_buffer(audio: np.ndarray, sample_rate: float,
                   backend: str = DEFAULT_BACKEND,
                   global_floor_db: float = -96.0,
                   as_arrays: bool = False,
                   device: str | torch.device = "cuda"):
    """Analyze a mono buffer (float32, or int16 scaled by 1/32768) with the
    sequential analyzers on `device`.

    Returns AnalysisResult (a list of per-frame structs) by default, or the
    columnar AnalysisArrays when `as_arrays=True`.  `backend` must give the
    full [N, W//2+1] spectrum (the default "fft" does): the pitch pass's
    magnitudes are also the spectrogram and the feature pack's input."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / np.float32(32768.0)
    audio = audio.astype(np.float32, copy=False)
    out = PitchAnalyzer(sample_rate, backend=backend,
                        device=device).process(
        audio, global_floor_db=global_floor_db)
    n = 0 if out is None else len(out.mags)
    oout = OnsetAnalyzer(sample_rate, backend=backend,
                         device=device).process(
        audio, global_floor_db=global_floor_db)
    onsets = ([] if oout is None else
              _onset_events(oout.fired, oout.velocity, sample_rate))
    if not n:
        if as_arrays:
            return _empty_arrays(sample_rate, onsets)
        return AnalysisResult(sample_rate=sample_rate, frames=[],
                              spectrogram=np.zeros((0, PITCH_WINDOW // 2 + 1),
                                                   np.float32),
                              onsets=onsets)

    # Framing is a view of the one upload; the [N, window] expansion never
    # reaches the host.
    f = frame_signal(torch.from_numpy(audio).to(device), PITCH_WINDOW,
                     PITCH_HOP)
    mags = torch.from_numpy(out.mags).to(device)
    feats = [a.cpu().numpy() for a in feature_pack(f, mags, sample_rate,
                                                   PITCH_WINDOW)]
    rms, energy, centroid, rolloff, flux = feats
    yin = [a.cpu().numpy() for a in yin_pitch(f, sample_rate)]
    f0, voiced = yin[0], yin[2].astype(bool)

    if as_arrays:
        return AnalysisArrays(
            sample_rate=sample_rate, time_s=_frame_times(n, sample_rate),
            rms=rms, energy=energy, centroid_hz=centroid, rolloff_hz=rolloff,
            flux=flux, yin_f0_hz=f0, yin_voiced=voiced,
            raw_freqs=out.raw_freqs, raw_scores=out.raw_scores,
            raw_valid=out.raw_valid.astype(bool),
            stable_freqs=out.stable_freqs, stable_scores=out.stable_scores,
            stable_valid=out.stable_valid.astype(bool),
            spectrogram=out.mags, onsets=onsets)

    frames = [FrameFeatures(
        time_s=(i * PITCH_HOP + PITCH_WINDOW / 2) / sample_rate,
        rms=float(rms[i]), energy=float(energy[i]),
        centroid_hz=float(centroid[i]), rolloff_hz=float(rolloff[i]),
        flux=float(flux[i]), yin_f0_hz=float(f0[i]),
        yin_voiced=bool(voiced[i]),
        pitches=[(float(a), float(b)) for a, b, v in
                 zip(out.raw_freqs[i], out.raw_scores[i], out.raw_valid[i])
                 if v],
        stable_pitches=[(float(a), float(b)) for a, b, v in
                        zip(out.stable_freqs[i], out.stable_scores[i],
                            out.stable_valid[i]) if v])
        for i in range(n)]
    return AnalysisResult(sample_rate=sample_rate, frames=frames,
                          spectrogram=out.mags, onsets=onsets)


def analyze_buffer_segmented(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             backend: str | None = None,
                             global_floor_db: float = -96.0,
                             feature_chunk_frames: int = 8192,
                             device: str | torch.device = "cuda"
                             ) -> AnalysisArrays:
    """Columnar bulk analysis through the segment-parallel pipelines.

    Stable pitches and onsets come from `models.segmented` (S parallel
    device-resident scan streams: the only stages with sequential state);
    the feature pack, spectrogram and YIN f0 are computed batched in
    chunks of `feature_chunk_frames` frames to bound device memory.  Raw
    (pre-hysteresis) pitch candidates are not produced here: `raw_*` are
    empty.

    `backend=None` routes each stage to its own backend: the pitch pass to
    the candidate-banded rDFT (ops.stft.PITCH_BACKEND, kernel K1), the onset
    pass and the full-spectrum feature chunks to "fft".  An explicit
    backend is used for every stage.  The recording (float32, or int16
    converted on the device) is uploaded once and shared by every pass."""
    from .models.segmented import (_as_host_audio, _upload_f32,
                                   segmented_onset_analysis,
                                   segmented_pitch_analysis)

    audio = _as_host_audio(audio)
    audio_dev = _upload_f32(audio, device)
    n = num_frames(len(audio), PITCH_WINDOW, PITCH_HOP)
    pitch_backend = backend or PITCH_BACKEND
    full_backend = backend or DEFAULT_BACKEND

    fired, vel, _, _ = segmented_onset_analysis(
        audio, sample_rate, segments=segments, backend=full_backend,
        global_floor_db=global_floor_db, device_audio=audio_dev,
        device=device)
    onsets = _onset_events(fired, vel, sample_rate)
    if not n:
        return _empty_arrays(sample_rate, onsets)

    sf, ss, sv = segmented_pitch_analysis(
        audio, sample_rate, segments=segments, backend=pitch_backend,
        global_floor_db=global_floor_db, device_audio=audio_dev,
        device=device)

    # Stateless per-frame stages, in chunks.  Each chunk after the first
    # carries one lead frame so the spectral flux stays continuous across
    # the boundary (feature_pack's first row diffs against zeros); the lead
    # row is dropped.  The last chunk is zero-padded to the common length.
    cols = {k: [] for k in ("spec", "rms", "energy", "centroid_hz",
                            "rolloff_hz", "flux", "f0", "voiced")}
    step = feature_chunk_frames
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        lead = 1 if c0 else 0
        s0 = (c0 - lead) * PITCH_HOP
        s1 = (s0 + (lead + step - 1) * PITCH_HOP + PITCH_WINDOW if c0
              else (c1 - 1) * PITCH_HOP + PITCH_WINDOW)
        sl = audio_dev[s0:min(s1, len(audio))]
        if c0 and s1 > len(audio):
            sl = torch.nn.functional.pad(sl, (0, s1 - len(audio)))
        f = frame_signal(sl, PITCH_WINDOW, PITCH_HOP)
        mags = windowed_mags(f, PITCH_WINDOW, backend=full_backend)
        feats = feature_pack(f, mags, sample_rate, PITCH_WINDOW)
        y = yin_pitch(f, sample_rate)
        lo, hi = lead, lead + c1 - c0
        for key, col in zip(cols, (mags, *feats, y.f0_hz, y.voiced)):
            cols[key].append(col[lo:hi])
    cols = {k: torch.cat(v).cpu().numpy() for k, v in cols.items()}

    z = np.zeros((0, 8), np.float32)
    return AnalysisArrays(
        sample_rate=sample_rate, time_s=_frame_times(n, sample_rate),
        rms=cols["rms"], energy=cols["energy"],
        centroid_hz=cols["centroid_hz"], rolloff_hz=cols["rolloff_hz"],
        flux=cols["flux"], yin_f0_hz=cols["f0"],
        yin_voiced=cols["voiced"].astype(bool),
        raw_freqs=z, raw_scores=z.copy(), raw_valid=np.zeros((0, 8), bool),
        stable_freqs=sf, stable_scores=ss, stable_valid=sv.astype(bool),
        spectrogram=cols["spec"], onsets=onsets)
