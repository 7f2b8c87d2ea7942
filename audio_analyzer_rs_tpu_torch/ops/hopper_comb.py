"""K2 — the harmonic comb as a Hopper kernel (csrc/comb.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_comb.py `_comb_kernel` (launched
by `comb_pallas`), the fused twin of ops/pitch.py `_comb_xla` that never
compiled on the TPU (Mosaic rejects stride-n lane slices).

What bounds it on an H100: neither bytes nor FLOPs.  At the main-path shape
(8192 frames x kc = 464 candidates) it reads 3 x 15 MB and writes 3 x 15 MB
(~14 us of HBM time at 3.35 TB/s) and does ~13 x 29 compare-selects per
candidate (~44 M in all).  The limit is latency: each thread runs a serial
dependent chain of 13 harmonics x up to 31 shared-memory loads, so the
kernel lives on occupancy and shared-memory throughput (strided reads
conflict on banks).

Design: one block per frame with the frame's zero-padded peak row staged
once in shared memory (~26 KB at kc = 464), one thread per candidate, the
reference's ascending first-maximum scan with IEEE-rounded products so the
output is bit-exact to the plain `_comb` in ops/pitch.py.  Every candidate
runs every harmonic (the plain version's truncation bounds skip only work
whose result is the identity or a miss), which requires pm to be zero at
and above the 10 kHz cap `max_bin`, as `_pre_comb` makes it.

`comb` is the wrapper: the plain version for CPU tensors, the kernel for
CUDA tensors (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0


def comb(pm: torch.Tensor, frac_c: torch.Tensor, fund_mag: torch.Tensor,
         half: int, max_bin: int):
    """pm/frac_c/fund_mag [N, kc] → (score f32, longest_run i32,
    total_harms i32), each [N, kc]."""
    if pm.device.type == "cpu":
        from .pitch import _comb
        return _comb(pm, frac_c, fund_mag, half, max_bin)
    if pm.device.type != "cuda":
        raise ValueError(f"comb: unsupported device {pm.device}")
    for name, t in (("pm", pm), ("frac_c", frac_c), ("fund_mag", fund_mag)):
        if t.dtype != torch.float32:
            raise TypeError(f"comb: {name} must be float32, got {t.dtype}")
        if t.device != pm.device:
            raise ValueError("comb: all tensors must share one device")
        if t.dim() != 2 or t.shape != pm.shape:
            raise ValueError(f"comb: {name} must be [N, kc] like pm, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"comb: {name} must be contiguous")
    n, kc = pm.shape
    if not 0 < max_bin <= kc < half:
        raise ValueError(f"comb: need 0 < max_bin ({max_bin}) <= kc ({kc}) "
                         f"< half ({half})")
    score = torch.empty((n, kc), dtype=torch.float32, device=pm.device)
    run = torch.empty((n, kc), dtype=torch.int32, device=pm.device)
    tot = torch.empty((n, kc), dtype=torch.int32, device=pm.device)
    if n == 0:
        return score, run, tot
    code = _build.lib().aat_comb(
        pm.data_ptr(), frac_c.data_ptr(), fund_mag.data_ptr(),
        score.data_ptr(), run.data_ptr(), tot.data_ptr(), n, kc, half,
        ctypes.c_void_p(_build.stream_ptr(pm)))
    _build.check(code, "aat_comb")
    global LAUNCHES
    LAUNCHES += 1
    return score, run, tot
