"""K1 — the windowed, banded rDFT magnitude as a Hopper kernel (csrc/stft.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_stft.py `_stft_kernel` (launched
by `windowed_mags_pallas`), and with it the XLA GEMM the JAX pitch path
used in its place (ops/fft.py `rfft_mag(backend="dft", band=...)`).

What bounds it on an H100: arithmetic.  At the main-path shape (8192 frames
of 2048 samples into 465 bins) the product is 2 * 8192 * 2048 * 930 ≈ 31.2
GFLOP in FP32, against 67 MB of frames and 7.6 MB of table: ~400 FLOP per
byte, far above the card's FP32 balance point (67 TFLOP/s over 3.35 TB/s
≈ 20).  FP32 has no tensor-core path short of TF32, which the 1e-6
spectral gate forbids, so the bound is the CUDA cores' FFMA rate (~0.47 ms
at the published peak).

Design: a shared-memory tiled FFMA product (64 frames x 64 bins a block,
32 accumulators a thread), the Hann multiply fused into the frame load and
the magnitude into the epilogue, frames read in place through their strides
(no framed copy of the audio).  Each output sums its samples in ascending
order in one register, so results do not depend on the batch geometry.
Tensor cores (3xTF32 split products) and TMA pipelining are later work.

`dft_mag` is the wrapper: the plain version for CPU tensors, the kernel for
CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0


def dft_mag_plain(frames: torch.Tensor, trig: torch.Tensor,
                  window: torch.Tensor | None = None) -> torch.Tensor:
    """frames [..., W] (× window [W]) @ trig [W, 2B] (interleaved cos/-sin
    columns) → magnitudes [..., B]."""
    x = frames if window is None else frames * window
    re_im = torch.matmul(x, trig)
    re_im = re_im.reshape(re_im.shape[:-1] + (trig.shape[1] // 2, 2))
    return torch.sqrt(re_im[..., 0] ** 2 + re_im[..., 1] ** 2)


def dft_mag(frames: torch.Tensor, trig: torch.Tensor,
            window: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitudes [..., B] of (frames × window) through the rDFT table
    `trig` [W, 2B].  `frames` is [N, W] or [S, F, W] with unit stride along
    W (other strides are free: an unfold view is read in place)."""
    if frames.device.type == "cpu":
        return dft_mag_plain(frames, trig, window)
    if frames.device.type != "cuda":
        raise ValueError(f"dft_mag: unsupported device {frames.device}")
    if frames.dtype != torch.float32 or trig.dtype != torch.float32:
        raise TypeError("dft_mag: frames and trig must be float32")
    if frames.dim() not in (2, 3):
        raise ValueError(f"dft_mag: frames must be [N, W] or [S, F, W], "
                         f"got {tuple(frames.shape)}")
    width = frames.shape[-1]
    if trig.dim() != 2 or trig.shape[0] != width or trig.shape[1] % 2:
        raise ValueError(f"dft_mag: trig {tuple(trig.shape)} does not fit "
                         f"window {width}")
    if frames.stride(-1) != 1 or trig.stride(1) != 1:
        raise ValueError("dft_mag: frames and trig need unit stride along "
                         "their last axis")
    if width % 16:
        raise ValueError(f"dft_mag: window {width} is not a multiple of 16")
    if window is not None:
        if (window.shape != (width,) or window.dtype != torch.float32
                or not window.is_contiguous()):
            raise ValueError("dft_mag: window must be contiguous float32 [W]")
    for t in (trig, window):
        if t is not None and t.device != frames.device:
            raise ValueError("dft_mag: all tensors must share one device")
    band = trig.shape[1] // 2
    lead = frames.shape[:-1]
    if frames.dim() == 3:
        per_row = frames.shape[1]
        s_out, s_in = frames.stride(0), frames.stride(1)
    else:
        per_row = max(frames.shape[0], 1)
        s_out, s_in = 0, frames.stride(0)
    n = frames.numel() // width if width else 0
    out = torch.empty(lead + (band,), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    lib = _build.lib()
    code = lib.aat_stft_mag(
        frames.data_ptr(), s_out, s_in, per_row,
        None if window is None else window.data_ptr(),
        trig.data_ptr(), trig.stride(0), out.data_ptr(), n, width, band,
        ctypes.c_void_p(_build.stream_ptr(frames)))
    _build.check(code, "aat_stft_mag")
    global LAUNCHES
    LAUNCHES += 1
    return out
