"""The work a cell asks of the card, counted from its shapes alone.

The counts do not depend on how the program computes: each distinct input
sample or element is read once (a frame view does not count its overlap),
each output and each carried state is written once, a real N-point
transform is 2.5 N log2 N flops plus N for its window and 4 a magnitude
(two squares, a sum, a root), and the recurrences (the reducer, the AGC,
the noise floor, the tracker, the onset scan) count their bytes alone.
Arrays that pass between two stages of the program are its own choice
and are not counted, so no fusion of stages can take the time under the
bound.  The bound of a request is the larger of its bytes over the HBM
peak and its flops over the float32 peak, so a share of it cannot pass
100% unless the time leaves out work.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its 700 W
limit, dense float32 outside the tensor cores and HBM bandwidth.
"""

from __future__ import annotations

import math
from typing import NamedTuple

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12
F32 = 4


class Work(NamedTuple):
    bytes: float
    flops: float

    def __add__(self, other):
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def bound_s(self) -> float:
        return max(self.bytes / PEAK_BYTES_S, self.flops / PEAK_FLOPS_S)


def num_frames(samples: int, window: int, hop: int) -> int:
    return 0 if samples < window else (samples - window) // hop + 1


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def transform_flops(frames: int, window: int, bins: int) -> float:
    """Windowed real transforms of `frames` frames, `bins` magnitudes each."""
    return frames * (rfft_flops(window) + window + 4 * bins)


def candidate_band(sample_rate: float, window: int,
                   max_freq: float = 10_000.0) -> int:
    """The bins the pitch extraction reads: [0, kc + 1)."""
    half = window // 2 + 1
    bin_width = sample_rate / window
    kc = min(half - 1, max(min(int(max_freq // bin_width), half - 2), 32))
    return kc + 1


# The carried state a stream needs, in float32 words (the reference's):
# the two biquads' 4 values each, the gate's envelope and hold; the AGC's
# 256- and 5,000-slot rings, their positions and fill flags, the gain;
# the noise floor's floor, last magnitudes and volatility over the band;
# the tracker's 24 tracks of (freq, score, life, seq) and its count; the
# onset scan's last magnitudes and floors over 129 bins, its threshold,
# energy average and refractory count.
REDUCER_STATE = 4 + 4 + 2
AGC_STATE = 256 + 5000 + 2 + 2 + 1
TRACKER_STATE = 24 * 4 + 1


def pitch_state(band: int) -> int:
    return 3 * band + 1


def onset_state(bins: int) -> int:
    return 2 * bins + 4


def full_step(streams: int, samples: int, sample_rate: float,
              slot: int = 1024, pitch_window: int = 2048,
              pitch_hop: int = 512, onset_window: int = 256,
              onset_hop: int = 64, notes: int = 8) -> Work:
    """One step of the batched full chain over `streams` chunks of
    `samples`: the chunks in; each stream's stable notes (a float and a
    flag each), onset flags and velocities and slot levels out; every
    stage's state in and out; the two STFTs' flops."""
    band = candidate_band(sample_rate, pitch_window)
    onset_bins = onset_window // 2 + 1
    n_slots = samples // slot
    used = n_slots * slot
    n_p = num_frames(used, pitch_window, pitch_hop)
    n_o = num_frames(used, onset_window, onset_hop)
    outputs = n_p * notes * (F32 + 1) + n_o * (1 + F32) + n_slots * F32
    state = (REDUCER_STATE + AGC_STATE + pitch_state(band) + TRACKER_STATE
             + onset_state(onset_bins)) * F32
    per_stream = Work(samples * F32 + outputs + 2 * state,
                      transform_flops(n_p, pitch_window, band)
                      + transform_flops(n_o, onset_window, onset_bins))
    return Work(per_stream.bytes * streams, per_stream.flops * streams)


def segmented_pitch(samples: int, frames_analysed: int, frames_out: int,
                    sample_rate: float, window: int = 2048,
                    notes: int = 8) -> Work:
    """One offline pitch call over a recording of `samples`: the recording
    in once; each of its `frames_out` frames' stable notes (freq, score,
    flag) out; `frames_analysed` frames transformed (the segments'
    look-back frames with the rest, as the segmented plan analyses
    them)."""
    band = candidate_band(sample_rate, window)
    return Work(samples * F32 + frames_out * notes * (2 * F32 + 1),
                transform_flops(frames_analysed, window, band))
