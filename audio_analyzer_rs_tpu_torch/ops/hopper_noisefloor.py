"""K5 — the per-bin noise-floor recurrence over S streams, as one Hopper
kernel (csrc/noisefloor.cu).

Replaces: the `lax.scan` of audio_analyzer_rs_tpu/ops/noisefloor.py
`noise_floor_scan` (:98 full width, :107 banded), which XLA compiles to one
device loop.  It has no Pallas twin; as plain PyTorch each frame is ~30
small launches on [S, B] tensors, so the scan is a kernel here.

What bounds it on an H100: bytes wherever S is large (the full step's
call, S = 128 streams x N = 933 frames x B = 426 of 1,025-float rows:
203.5 MB of magnitudes read, 203.5 MB of effective floors written, ~0.123
ms at 3.35 TB/s; the segmented step, S = 128 x N = 64 x B = 464: ~9.5 us),
and the per-frame chain of each bin wherever S is small (the sequential
`PitchAnalyzer`, S = 1).

Design (the source note in csrc/noisefloor.cu has the detail): a lane a
(stream, bin), warps of 32 bins flattened over the streams, the state in
registers, the next frames' loads issued ahead, coalesced along the bins;
the two quotients of the step computed only where they can change the
result.  The kernel writes the whole [S, H] state: the band it scans and
the state above it (frozen, or seeded once from full-width magnitudes or
a first frame handed in, as `noisefloor.with_tail` does), so no torch op
runs after the launch.

`noise_floor_scan` is the wrapper: on CPU tensors the plain scan, on CUDA
tensors the kernel (or it raises).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

LAUNCHES = 0


def check_args(state, mags, global_floor, band: int,
               first=None) -> torch.Tensor:
    """Raise ValueError on what the kernel does not take; return mags as
    [S, N, H'] (a view where the leading axes allow it)."""
    lead = tuple(state.initialized.shape)
    half = state.floor.shape[-1]
    if mags.dim() != len(lead) + 2 or tuple(mags.shape[:len(lead)]) != lead:
        raise ValueError(f"noise_floor_scan: mags must be {lead} + (N, H'), "
                         f"got {tuple(mags.shape)}")
    n, width = mags.shape[-2:]
    if not 1 <= band <= min(half, width):
        raise ValueError(f"noise_floor_scan: band {band} must be in [1, "
                         f"{min(half, width)}]")
    expect = {
        "mags": (mags, torch.float32, lead + (n, width)),
        "global_floor": (global_floor, torch.float32, lead + (n,)),
        "floor": (state.floor, torch.float32, lead + (half,)),
        "prev_mag": (state.prev_mag, torch.float32, lead + (half,)),
        "volatility": (state.volatility, torch.float32, lead + (half,)),
        "initialized": (state.initialized, torch.bool, lead),
    }
    if first is not None:
        expect["first"] = (first, torch.float32, lead + (half,))
    for name, (t, dtype, shape) in expect.items():
        if t.device != mags.device:
            raise ValueError("noise_floor_scan: all tensors must share one "
                             "device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"noise_floor_scan: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if name != "mags" and not t.is_contiguous():
            raise ValueError(f"noise_floor_scan: {name} must be contiguous")
    if mags.numel() and mags.stride(-1) != 1:
        raise ValueError("noise_floor_scan: mags needs unit stride along "
                         "the bins")
    m3 = mags.reshape(math.prod(lead), n, width)
    if m3.data_ptr() % 4:
        raise ValueError("noise_floor_scan: mags must be 4-byte aligned")
    return m3


def noise_floor_scan(state, mags, global_floor, band: int, first=None):
    """state: NoiseFloorState with leaves [..., H] / [...]; mags [..., N,
    H'] float32 with unit stride along the bins, H' >= band; global_floor
    [..., N] float32; 1 <= band <= H; first: None or [..., H] float32
    contiguous, each stream's first frame at full width (the tail's seed
    beside banded magnitudes) → (state, effective floor [..., N, band])."""
    from . import noisefloor
    if mags.device.type == "cpu":
        return noisefloor.noise_floor_scan_plain(state, mags, global_floor,
                                                 band, first)
    if mags.device.type != "cuda":
        raise ValueError(f"noise_floor_scan: unsupported device "
                         f"{mags.device}")
    m3 = check_args(state, mags, global_floor, band, first)
    s, n, width = m3.shape
    lead = tuple(state.initialized.shape)
    half = state.floor.shape[-1]
    dev = mags.device
    eff = torch.empty(lead + (n, band), dtype=torch.float32, device=dev)
    if n == 0 or s == 0:
        return state, eff
    out = noisefloor.NoiseFloorState(
        *(torch.empty(lead + (half,), dtype=torch.float32, device=dev)
          for _ in range(3)),
        torch.empty_like(state.initialized))
    lib = _build.lib()
    head = (m3.data_ptr(), m3.stride(0), m3.stride(1),
            global_floor.data_ptr(), *(t.data_ptr() for t in state),
            eff.data_ptr(), *(t.data_ptr() for t in out))
    tail = (s, n, band, half, width, ctypes.c_void_p(_build.stream_ptr(mags)))
    if first is None:
        name, code = "aat_noise_floor_scan", lib.aat_noise_floor_scan(
            *head, *tail)
    else:
        name = "aat_noise_floor_scan_first"
        code = lib.aat_noise_floor_scan_first(*head, first.data_ptr(), *tail)
    _build.check(code, name)
    global LAUNCHES
    LAUNCHES += 1
    return out, eff

