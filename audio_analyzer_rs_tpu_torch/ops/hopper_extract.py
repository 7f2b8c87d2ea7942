"""K10 — the pitch extraction as one Hopper kernel (csrc/extract.cu).

Replaces no Pallas kernel: on the TPU, XLA fused these ops (JAX
audio_analyzer_rs_tpu/ops/pitch.py `_pre_comb` :259 and `_extract_single`
:294, the dedup at :386).  Before K10 the port ran them as ~360 plain
torch kernels a call around K2.  The plain version, ops/pitch.py
`_extract`, is plain torch throughout, its comb included.

What bounds it on an H100: bytes, in the bound's count.  A frame's kc + 1
magnitudes and kc floors are read and three [8] outputs written: 30.4 MB
at the main path's 8,192 frames a call (9.3 us at 3.35 TB/s), 0.124 ms at
the full step's 119,424 frames.  Below the bytes, what holds it back is
instruction issue and latency (the comb chains, the peak scan, the tail).

Design: persistent one-warp blocks (about 30 an SM), block b taking frames
b, b + grid, ..., each streaming its frames through a shared-memory frame
buffer that `cp.async` fills with the next frame behind the current one's
tail; a lane a bin for the peaks (the comb's row pm and a bin-ordered peak
list), a lane a peak for the gates, the logs, the interpolation and K2's
comb (csrc/comb.cuh), then the max score, the candidates, the top 32 by
counted ranks, the ghost test and the 32-step dedup.  Bitwise to the plain `_extract` (every rounding spelled as torch
rounds it on the card).

`extract` is the wrapper: the plain version for CPU tensors, the kernel for
CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
MAX_NOTES = 8


def extract(mags: torch.Tensor, noise_floor: torch.Tensor, bin_width: float,
            min_bin: int, max_bin: int, min_freq: float, max_freq: float,
            half: int):
    """mags [N, >= kc+1] and floors [N, >= kc] (rows read in place through
    their stride) → PitchFrame [N, 8] (freqs f32, scores f32, valid bool),
    kc = min(half - 1, max(max_bin, 32)).  The arguments are checked on
    either device, so a CPU run refuses what the kernel refuses."""
    from .pitch import TOP_K, PitchFrame, _extract
    if mags.device.type not in ("cpu", "cuda"):
        raise ValueError(f"extract: unsupported device {mags.device}")
    kc = min(half - 1, max(max_bin, TOP_K))
    for name, t, cols in (("mags", mags, kc + 1),
                          ("noise_floor", noise_floor, kc)):
        if t.dtype != torch.float32:
            raise TypeError(f"extract: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != mags.device:
            raise ValueError("extract: all tensors must share one device")
        if t.dim() != 2 or t.shape[0] != mags.shape[0] or t.shape[1] < cols:
            raise ValueError(f"extract: {name} must be [N, >= {cols}] with "
                             f"N = {mags.shape[0]}, got {tuple(t.shape)}")
        if t.stride(1) != 1:
            raise ValueError(f"extract: {name} needs unit stride along its "
                             f"rows")
    if not 0 < max_bin <= kc < half:
        raise ValueError(f"extract: need 0 < max_bin ({max_bin}) <= kc "
                         f"({kc}) < half ({half})")
    if mags.device.type == "cpu":
        return _extract(mags, noise_floor, bin_width, min_bin, max_bin,
                        min_freq, max_freq, half)
    n = mags.shape[0]
    shape = (n, MAX_NOTES)
    freq = torch.empty(shape, dtype=torch.float32, device=mags.device)
    score = torch.empty(shape, dtype=torch.float32, device=mags.device)
    valid = torch.empty(shape, dtype=torch.bool, device=mags.device)
    if n == 0:
        return PitchFrame(freq, score, valid)
    code = _build.lib().aat_extract(
        mags.data_ptr(), mags.stride(0), noise_floor.data_ptr(),
        noise_floor.stride(0), freq.data_ptr(), score.data_ptr(),
        valid.data_ptr(), n, kc, half, min_bin, max_bin, bin_width,
        min_freq, max_freq, ctypes.c_void_p(_build.stream_ptr(mags)))
    _build.check(code, "aat_extract")
    global LAUNCHES
    LAUNCHES += 1
    return PitchFrame(freq, score, valid)
