"""K4 — the onset recurrence over S streams, as one Hopper kernel
(csrc/onset.cu).

Replaces: the `lax.scan` of audio_analyzer_rs_tpu/ops/onset.py
`onset_scan` (:145), which XLA compiles to one device loop.  It has no
Pallas twin; as plain PyTorch each frame is ~60-80 small launches on [S, H]
tensors, so the scan is a kernel here.

What bounds it on an H100: each stream is a serial recurrence, ~226
cycles a frame, and a block runs one stream.  Where the S blocks fit the
card at once they run in one wave and one stream's chain is the time (the
full step's [128, 7,485, 129] call, ~0.87 ms; the sequential
`OnsetAnalyzer`, S = 1).  Where S is larger the time is the rounds of
resident blocks, ceil(S / (SMs x blocks a SM)), each one chain long; the
bytes (7.9 GB at [2048, 7,485, 129], ~2.4 ms at 3.35 TB/s) are a floor
below both.

Design (the source note in csrc/onset.cu has the detail): a block a stream,
the bins on the threads of five warps with each bin's floor and previous
magnitude in registers, 32-frame tiles of magnitudes staged into shared
memory ahead by cp.async, and one chain warp that runs the scalar
recurrence (EMA, threshold, gates, counter) of the tile behind.  The flux
and energy sums run in `onset.tree_sum`'s order, so K4 is bitwise equal to
`onset_scan_plain`.  Up to 160 bins a block holds two magnitude tiles,
so two blocks share a SM (the full step's 2,048 streams run in 8 rounds,
not 16); wider blocks keep four tiles and one a SM.  `RESIDENT` records,
for each H launched, the blocks a SM it gets.

`onset_scan` is the wrapper: on CPU tensors the plain scan, on CUDA tensors
the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
# H → the blocks of H bins that stay resident on one SM, as the occupancy
# calculator reports them; read at the first launch of each H.
RESIDENT = {}
_MAX_BINS = 256      # the kernel's eight bin warps


def resident_blocks(h: int) -> int:
    """Blocks a SM at H bins (the occupancy calculator's count), read from
    the card once and kept in RESIDENT."""
    if h not in RESIDENT:
        blocks = ctypes.c_int(0)
        code = _build.lib().aat_onset_blocks_per_sm(h, ctypes.byref(blocks))
        _build.check(code, "aat_onset_blocks_per_sm")
        RESIDENT[h] = blocks.value
    return RESIDENT[h]


def onset_scan(state, mags, global_floor, tick_suppressed, calibration_hold):
    """state: OnsetState with leaves [S, H] / [S]; mags [S, N, H] float32;
    global_floor [S, N] float32; tick_suppressed, calibration_hold [S, N]
    bool → (state, OnsetFrameOut of [S, N])."""
    from . import onset
    if mags.device.type == "cpu":
        return onset.onset_scan_plain(state, mags, global_floor,
                                      tick_suppressed, calibration_hold)
    if mags.device.type != "cuda":
        raise ValueError(f"onset_scan: unsupported device {mags.device}")
    if mags.dim() != 3 or not 2 <= mags.shape[-1] <= _MAX_BINS:
        raise ValueError(f"onset_scan: mags must be [S, N, H] with 2 <= H <= "
                         f"{_MAX_BINS}, got {tuple(mags.shape)}")
    s, n, h = mags.shape
    expect = {
        "mags": (mags, torch.float32, (s, n, h)),
        "global_floor": (global_floor, torch.float32, (s, n)),
        "tick_suppressed": (tick_suppressed, torch.bool, (s, n)),
        "calibration_hold": (calibration_hold, torch.bool, (s, n)),
        "prev_mag": (state.prev_mag, torch.float32, (s, h)),
        "floor": (state.floor, torch.float32, (s, h)),
        "floor_init": (state.floor_init, torch.bool, (s,)),
        "threshold": (state.threshold, torch.float32, (s,)),
        "energy_ema": (state.energy_ema, torch.float32, (s,)),
        "frames_since_onset": (state.frames_since_onset, torch.int32, (s,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != mags.device:
            raise ValueError("onset_scan: all tensors must share one device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"onset_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"onset_scan: {name} must be contiguous")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"onset_scan: {name} must be "
                             f"{t.element_size()}-byte aligned")
    dev = mags.device
    out = onset.OnsetFrameOut(
        *(torch.empty((s, n), dtype=dtype, device=dev) for dtype in (
            torch.bool, torch.bool, torch.float32, torch.float32,
            torch.float32, torch.int32, torch.bool, torch.int32)))
    new = onset.OnsetState(*(torch.empty_like(leaf) for leaf in state))
    if s == 0:
        return new, out
    ptrs = [t.data_ptr() for t in (mags, global_floor, tick_suppressed,
                                   calibration_hold, *state, *out, *new)]
    resident_blocks(h)
    code = _build.lib().aat_onset_scan(
        *ptrs, s, n, h, ctypes.c_void_p(_build.stream_ptr(mags)))
    _build.check(code, "aat_onset_scan")
    global LAUNCHES
    LAUNCHES += 1
    return new, out
