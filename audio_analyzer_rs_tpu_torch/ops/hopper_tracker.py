"""K3 — the batched PitchTracker scan as a Hopper kernel (csrc/tracker.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_tracker.py `_kernel` (launched
by `tracker_scan_pallas`), which the JAX segmented path runs on the TPU
through `tracker.tracker_scan_batched`.

What bounds it on an H100: latency, not bytes or FLOPs.  At the main-path
shape (S = 128 streams x N = 64 frames) it moves ~1.6 MB of raw pitches
and emissions (under 1 us of HBM time) and does a few hundred integer and
float operations per slot per frame, but each frame depends on the one
before: a stream is a serial chain of N frames x 8 match rounds, each
ending in a warp-wide reduction.  As plain PyTorch the same recurrence is
~90 small launches per frame.

Design: one warp per stream with the 24 track slots on lanes and the whole
state in registers across the N frames; the greedy match's "first track in
creation order" is a warp min-reduction over seq, and spawn ranks come from
a ballot and popc.  The launch covers S / 4 blocks of 4 warps — a small
grid, so the kernel is latency-bound by design; interleaving frames of
independent streams per warp is later work.

`tracker_scan` is the wrapper: the plain loop for CPU tensors, the kernel
for CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
_SLOTS = 24      # MAX_TRACKS; the kernel keeps one slot per lane
_RAWS = 8        # MAX_NOTES raw pitches per frame


def tracker_scan(state, raw_freqs, raw_scores, raw_valid, onsets):
    """state: TrackerState with leaves [S, 24] / next_seq [S]; raw_*
    [S, N, 8]; onsets [S, N] → (state, (freq, score, stable, seq) each
    [S, N, 24]), the per-frame slot emissions before `select_stable`."""
    from .tracker import TrackerState, tracker_scan_plain
    if raw_freqs.device.type == "cpu":
        return tracker_scan_plain(state, raw_freqs, raw_scores, raw_valid,
                                  onsets)
    if raw_freqs.device.type != "cuda":
        raise ValueError(f"tracker_scan: unsupported device {raw_freqs.device}")
    if raw_freqs.dim() != 3 or raw_freqs.shape[-1] != _RAWS:
        raise ValueError(f"tracker_scan: raw_freqs must be [S, N, {_RAWS}], "
                         f"got {tuple(raw_freqs.shape)}")
    s, n, _ = raw_freqs.shape
    expect = {
        "raw_freqs": (raw_freqs, torch.float32, (s, n, _RAWS)),
        "raw_scores": (raw_scores, torch.float32, (s, n, _RAWS)),
        "raw_valid": (raw_valid, torch.bool, (s, n, _RAWS)),
        "onsets": (onsets, torch.bool, (s, n)),
        "freq": (state.freq, torch.float32, (s, _SLOTS)),
        "score": (state.score, torch.float32, (s, _SLOTS)),
        "life": (state.life, torch.int32, (s, _SLOTS)),
        "valid": (state.valid, torch.bool, (s, _SLOTS)),
        "seq": (state.seq, torch.int32, (s, _SLOTS)),
        "next_seq": (state.next_seq, torch.int32, (s,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != raw_freqs.device:
            raise ValueError("tracker_scan: all tensors must share one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"tracker_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"tracker_scan: {name} must be contiguous")
    dev = raw_freqs.device
    of = torch.empty((s, n, _SLOTS), dtype=torch.float32, device=dev)
    osc = torch.empty((s, n, _SLOTS), dtype=torch.float32, device=dev)
    ot = torch.empty((s, n, _SLOTS), dtype=torch.bool, device=dev)
    oq = torch.empty((s, n, _SLOTS), dtype=torch.int32, device=dev)
    new = TrackerState(torch.empty_like(state.freq),
                       torch.empty_like(state.score),
                       torch.empty_like(state.life),
                       torch.empty_like(state.valid),
                       torch.empty_like(state.seq),
                       torch.empty_like(state.next_seq))
    ptrs = [t.data_ptr() for t in (raw_freqs, raw_scores, raw_valid, onsets,
                                   *state, of, osc, ot, oq, *new)]
    code = _build.lib().aat_tracker_scan(
        *ptrs, s, n, ctypes.c_void_p(_build.stream_ptr(raw_freqs)))
    _build.check(code, "aat_tracker_scan")
    global LAUNCHES
    LAUNCHES += 1
    return new, (of, osc, ot, oq)
