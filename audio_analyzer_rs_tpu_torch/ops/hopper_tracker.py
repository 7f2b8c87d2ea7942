"""K3 — the batched PitchTracker scan with its stable top-8, as one Hopper
kernel (csrc/tracker.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_tracker.py `_kernel` (launched
by `tracker_scan_pallas`), which the JAX segmented path runs on the TPU
through `tracker.tracker_scan_batched`, and the `select_stable` that path
runs on the kernel's per-slot emissions.

What bounds it on an H100: latency, not bytes or FLOPs.  At the main-path
shape (S = 128 streams x N = 64 frames) it moves ~1.3 MB (under 0.4 us of
HBM time), but each frame depends on the one before: a stream is a serial
chain of N frames x 8 greedy match rounds.  As plain PyTorch the same
recurrence is ~90 small launches per frame.

Design (the source note in csrc/tracker.cu has the detail): a block a
stream, one chain warp with the 24 track slots on lanes and the state in
registers, and helper warps that stage the raws in shared memory a tile of
64 frames ahead and run `select_stable` on the tile behind; the match
rounds run on warp-uniform bitmasks in creation order.  The per-slot
emissions stay in shared memory.

`tracker_scan` is the wrapper: on CPU tensors the plain scan and
`select_stable`, on CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
_SLOTS = 24      # MAX_TRACKS; the kernel keeps one slot per lane
_RAWS = 8        # MAX_NOTES raw pitches per frame, and stable pitches out


def tracker_scan(state, raw_freqs, raw_scores, raw_valid, onsets):
    """state: TrackerState with leaves [S, 24] / next_seq [S]; raw_*
    [S, N, 8]; onsets [S, N] → (state, (freq, score, valid) each [S, N, 8]):
    `tracker_scan_plain` followed by `select_stable`."""
    from . import tracker
    if raw_freqs.device.type == "cpu":
        state, emits = tracker.tracker_scan_plain(state, raw_freqs, raw_scores,
                                                  raw_valid, onsets)
        return state, tracker.select_stable(*emits)
    if raw_freqs.device.type != "cuda":
        raise ValueError(f"tracker_scan: unsupported device {raw_freqs.device}")
    if raw_freqs.dim() != 3 or raw_freqs.shape[-1] != _RAWS:
        raise ValueError(f"tracker_scan: raw_freqs must be [S, N, {_RAWS}], "
                         f"got {tuple(raw_freqs.shape)}")
    s, n, _ = raw_freqs.shape
    expect = {
        "raw_freqs": (raw_freqs, torch.float32, (s, n, _RAWS), 16),
        "raw_scores": (raw_scores, torch.float32, (s, n, _RAWS), 16),
        "raw_valid": (raw_valid, torch.bool, (s, n, _RAWS), 8),
        "onsets": (onsets, torch.bool, (s, n), 1),
        "freq": (state.freq, torch.float32, (s, _SLOTS), 1),
        "score": (state.score, torch.float32, (s, _SLOTS), 1),
        "life": (state.life, torch.int32, (s, _SLOTS), 1),
        "valid": (state.valid, torch.bool, (s, _SLOTS), 1),
        "seq": (state.seq, torch.int32, (s, _SLOTS), 1),
        "next_seq": (state.next_seq, torch.int32, (s,), 1),
    }
    for name, (t, dtype, shape, align) in expect.items():
        if t.device != raw_freqs.device:
            raise ValueError("tracker_scan: all tensors must share one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"tracker_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"tracker_scan: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"tracker_scan: {name} must be {align}-byte "
                             f"aligned")
    dev = raw_freqs.device
    out_f = torch.empty((s, n, _RAWS), dtype=torch.float32, device=dev)
    out_s = torch.empty((s, n, _RAWS), dtype=torch.float32, device=dev)
    out_v = torch.empty((s, n, _RAWS), dtype=torch.bool, device=dev)
    new = tracker.TrackerState(*(torch.empty_like(leaf) for leaf in state))
    if s == 0:
        return new, (out_f, out_s, out_v)
    ptrs = [t.data_ptr() for t in (raw_freqs, raw_scores, raw_valid, onsets,
                                   *state, out_f, out_s, out_v, *new)]
    code = _build.lib().aat_tracker_select(
        *ptrs, s, n, ctypes.c_void_p(_build.stream_ptr(raw_freqs)))
    _build.check(code, "aat_tracker_select")
    global LAUNCHES
    LAUNCHES += 1
    return new, (out_f, out_s, out_v)
