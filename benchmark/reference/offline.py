"""The plain offline pitch analysis of one segment of a long recording,
in float64 NumPy: the segment-parallel plan, and one segment's stream
analysed from fresh states (windowed magnitudes, the noise floor under a
constant global floor, the extraction and the tracker, no onsets).

The plan is the semantics of segment-parallel analysis: the recording's
frames are split into S segments of equal payload (a whole number of
chunks); segment 0 is analysed from the first frame, each later segment
from `warmup` frames before its payload, whose outputs are discarded.
Frames past the recording read zeros.  It imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np

from .pitch import floor_state, magnitudes, noise_floor, num_frames, \
    pitch_frames


def auto_segments(n_frames: int, warmup: int, cap: int = 128) -> int:
    """The segment count: payloads near 10x the warm-up, a power of two,
    at most `cap`."""
    ideal = min(cap, n_frames // (warmup * 10))
    if ideal <= 1:
        return 1
    lower = 1 << (ideal.bit_length() - 1)
    upper = min(lower * 2, cap)
    return upper if ideal >= lower + lower // 2 else lower


def plan(samples: int, window: int, hop: int, chunk: int,
         warmup: int) -> dict:
    n = num_frames(samples, window, hop)
    segments = auto_segments(n, warmup)
    segments = max(1, min(segments, max(n // max(chunk, 1), 1)))
    payload = -(-max(n - warmup, 1) // segments)
    payload = -(-payload // chunk) * chunk
    stream_len = warmup + payload
    steps = -(-stream_len // chunk)
    starts = [0] + [stream_len + (s - 1) * payload - warmup
                    for s in range(1, segments)]
    return {"frames": n, "segments": segments, "payload": payload,
            "stream_len": stream_len, "steps": steps, "starts": starts,
            "stream_frames": steps * chunk}


def payload_range(p: dict, s: int) -> tuple[int, int]:
    """Segment s's frames of the recording, [lo, hi)."""
    if s == 0:
        return 0, min(p["stream_len"], p["frames"])
    lo = p["stream_len"] + (s - 1) * p["payload"]
    return lo, min(lo + p["payload"], p["frames"])


def stream_audio(audio: np.ndarray, p: dict, s: int, window: int,
                 hop: int) -> np.ndarray:
    """Segment s's stream of samples, zeros past the recording's end."""
    a = p["starts"][s] * hop
    n = (p["stream_frames"] - 1) * hop + window
    out = np.zeros(n, np.float32)
    got = audio[a:a + n]
    out[:len(got)] = got
    return out


def segment(x: np.ndarray, sample_rate: float, floor_db: float,
            window: int, hop: int, precision: str = "float64"):
    """One segment's stream from fresh states → (freqs, scores, valid),
    each [frames, 8]."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    kc = min(half - 1, max(min(int(math.floor(10_000.0 / bin_width)),
                               half - 2), 32))
    mags = magnitudes(x, window, hop, kc + 1, precision)
    gf = np.full(len(mags), 10.0 ** (floor_db / 20.0) * (half / 2.0))
    eff, _ = noise_floor(mags[:, :kc], gf, floor_state(kc))
    return pitch_frames(mags, eff, bin_width, half, [])
