"""K8 and K9 — the Mosaic probe's lane gathers as Hopper kernels
(csrc/gather.cu).

Replaces: the two Pallas kernels of tools/mosaic_probe.py, `gather_kernel`
(:24, launched :31: `jnp.take_along_axis(x, idx, axis=1)` over [F, P]
float32 with [F, P] int32 indices) and `kern` (:83, launched :90: twelve
gathers at (idx + n) mod P summed, the comb's harmonic read).  They asked
whether Mosaic lowers a lane gather; their port is the probe's twin,
port_tools/gather_probe.py.

What bounds them on an H100: bytes, and at the probe's shapes the launch:
[8, 7296] moves 3 x 233 KB = 0.70 MB, 0.21 us at 3.35 TB/s.

Design (the source note in csrc/gather.cu has the detail): a thread an
output, coalesced along the columns; K8's one read of x and K9's 12 go
through the read-only cache, where a 29 KB row stays (staging the row in
shared memory a block, K9's first design, was slower on the card).  Both
are bitwise equal to the plain versions in ops/gather.py: JAX's index
semantics (a negative index wraps once, one outside [-P, P) gives NaN;
K9's int32-wrapping add and floor-mod), and K9's sum from +0.0 in the
order n = 0..11.

`lane_gather` and `comb_gather12` are the wrappers: on CPU tensors the
plain versions, on CUDA tensors the kernels (or they raise).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import gather

LAUNCHES_K8 = 0
LAUNCHES_K9 = 0


def check_args(x: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    """Raise on what the kernels do not take: x [F, P] float32 and idx
    [F, P] int32, both contiguous on one device, F and P below 2**31."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"{name}: x and idx must both be [F, P], got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError(f"{name}: x and idx must share one device")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: x and idx must be contiguous")
    f, p = x.shape
    if f >= 2 ** 31 or p >= 2 ** 31:
        raise ValueError(f"{name}: [F, P] = {tuple(x.shape)} is too large")


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8: x [F, P] float32, idx [F, P] int32 → x[f, idx[f, p]] [F, P], with
    JAX's index semantics (ops/gather.py `lane_gather`)."""
    check_args(x, idx, "lane_gather")
    if x.device.type == "cpu":
        return gather.lane_gather(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"lane_gather: unsupported device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    code = _build.lib().aat_lane_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], ctypes.c_void_p(_build.stream_ptr(x)))
    _build.check(code, "aat_lane_gather")
    global LAUNCHES_K8
    LAUNCHES_K8 += 1
    return out


def comb_gather12(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9: x [F, P] float32, idx [F, P] int32 → the sum over n = 0..11 of
    x[f, (idx[f, p] + n) mod P] [F, P] (ops/gather.py `comb_gather12`)."""
    check_args(x, idx, "comb_gather12")
    if x.device.type == "cpu":
        return gather.comb_gather12(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"comb_gather12: unsupported device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    code = _build.lib().aat_comb_gather12(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], ctypes.c_void_p(_build.stream_ptr(x)))
    _build.check(code, "aat_comb_gather12")
    global LAUNCHES_K9
    LAUNCHES_K9 += 1
    return out
