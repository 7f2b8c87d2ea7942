"""K7 — the dynamics (AGC) scan over B streams, as one Hopper kernel
(csrc/dynamics.cu).

Replaces: the `lax.scan` of audio_analyzer_rs_tpu/ops/dynamics.py
`dynamics_scan` (:253; the step is `_step`, :123), which XLA compiles to
one device loop.  It has no Pallas twin; as plain PyTorch each slot is ~100
small launches on [B] and [B, L] tensors, so the scan is a kernel here.

What bounds it on an H100: the per-slot chain.  The bytes (the slots in,
the gained slots out, the rings and histograms in and out) take ~0.15 ms
at the full step's B = 128 x 468 slots; only the scalar chain (floor,
classification, ring and histogram update, percentiles, gain) is carried
from slot to slot.

Design (the source note in csrc/dynamics.cu has the detail): the work is
split by what is carried: (A) the slot sums (in `dynamics.tree_sum`'s
order), the peak and what follows from them alone, a warp a slot over all
B x S slots; (B) the scalar chain, in "hist" mode one warp a stream with
the histograms as prefix counts (a percentile is two ballots, a shuffle
and a shared load) and the dB and gain target of each bucket as tables,
in "exact" mode a 1,024-thread block a stream with a radix select; (C)
the gained slots, elementwise: in "hist" mode by the other warps of (B)'s
block while the chain runs, in "exact" mode by a third launch.  K7 is
bitwise equal to `dynamics_scan_plain`.

`dynamics_scan` is the wrapper: on CPU tensors the plain scan, on CUDA
tensors the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

LAUNCHES = 0
_MAX_SLOT = 1024     # (A): 32 lanes of 32 samples a slot


def check_args(state, slots: torch.Tensor) -> None:
    """Raise ValueError on what the kernel does not take."""
    from . import dynamics
    if slots.dim() != 3:
        raise ValueError(f"dynamics_scan: slots must be [B, S, L], got "
                         f"{tuple(slots.shape)}")
    b, _, length = slots.shape
    if not 1 <= length <= _MAX_SLOT:
        raise ValueError(f"dynamics_scan: slot length {length} must be in "
                         f"[1, {_MAX_SLOT}]")
    if slots.dtype != torch.float32 or not slots.is_contiguous():
        raise ValueError("dynamics_scan: slots must be contiguous float32")
    shapes = {"long_hist": (dynamics.LONG_LEN,),
              "play_hist": (dynamics.PLAY_LEN,),
              "long_counts": (dynamics._HIST_BINS,),
              "play_counts": (dynamics._HIST_BINS,)}
    dtypes = {"long_pos": torch.int32, "play_pos": torch.int32,
              "long_filled": torch.bool, "play_filled": torch.bool,
              "long_counts": torch.int32, "play_counts": torch.int32}
    for name, t in zip(dynamics.DynamicsState._fields, state):
        shape = (b,) + shapes.get(name, ())
        dtype = dtypes.get(name, torch.float32)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"dynamics_scan: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != slots.device or not t.is_contiguous():
            raise ValueError(f"dynamics_scan: {name} must be contiguous on "
                             f"{slots.device}")


def dynamics_scan(state, slots: torch.Tensor, sample_rate: float,
                  slot_len: int, mode: str):
    """state: DynamicsState with leaves [B, ...]; slots [B, S, L] float32 →
    (state, DynamicsOut of [B, S], gained [B, S, L])."""
    from . import dynamics
    if slots.device.type == "cpu":
        return dynamics.dynamics_scan_plain(state, slots, sample_rate,
                                            slot_len, mode)
    if slots.device.type != "cuda":
        raise ValueError(f"dynamics_scan: unsupported device {slots.device}")
    check_args(state, slots)
    b, s, length = slots.shape
    dev = slots.device
    gained = torch.empty_like(slots)
    outs = dynamics.DynamicsOut(
        torch.empty((b, s), dtype=torch.int32, device=dev),
        *(torch.empty((b, s), dtype=torch.float32, device=dev)
          for _ in range(5)))
    if b == 0 or s == 0:
        return state, outs, gained
    new = dynamics.DynamicsState(*(torch.empty_like(t) for t in state))
    smooth, silence = dynamics.smoothing_alphas(sample_rate, slot_len)
    code = _build.lib().aat_dynamics_scan(
        slots.data_ptr(), *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in outs), gained.data_ptr(),
        *(t.data_ptr() for t in new), b, s, length, int(mode == "exact"),
        float(np.float32(1.0 / length)), smooth, silence,
        ctypes.c_void_p(_build.stream_ptr(slots)))
    _build.check(code, "aat_dynamics_scan")
    global LAUNCHES
    LAUNCHES += 1
    return new, outs, gained
