"""K2 — the harmonic comb as a Hopper kernel (csrc/comb.cu).

Replaces: audio_analyzer_rs_tpu/ops/pallas_comb.py `_comb_kernel` (launched
by `comb_pallas`), the fused twin of ops/pitch.py `_comb_xla` that never
compiled on the TPU (Mosaic rejects stride-n lane slices).

What bounds it on an H100: bytes.  At the main-path shape (8192 frames x
kc = 464 candidates) it reads pm, frac_c and fund_mag and writes score,
longest_run and total_harms, 6 x 15.2 MB = 91.2 MB: 27 us at 3.35 TB/s.
Scanning every offset -n-1..n+1 of every harmonic, as the reference does,
is 247 compare-selects a candidate, 0.94 G at this shape.  Almost all of
them read zeros: a harmonic's window [floor(e-1), ceil(e+1)] holds at most
4 bins, and pm is zero at and above the 10 kHz cap `max_bin`, so only ~1,050
of a frame's 6,032 (candidate, harmonic) pairs can find a peak.

Design: one warp per frame, 8 frames a block, the frame's kc values of pm
staged in shared memory with float4 loads, a lane per candidate.  Each
harmonic scans only the window clipped to [0, max_bin - 1] and to the
reference's offsets, ascending with a strict `>` (the first maximum wins);
an empty window is a miss with no read; the first harmonic with e >= half
(all later ones are identities) or with its window past max_bin (all later
ones are misses) ends the candidate: ~1,070 live (candidate, harmonic)
pairs a frame are left of 6,032.  Products and sums are IEEE-rounded
(`__fmul_rn` / `__fadd_rn`) in the reference's order, so the output is
bit-exact to the plain `_comb` in ops/pitch.py.  This requires pm
to be zero at and above `max_bin` and fund_mag non-negative, as `_pre_comb`
makes them.

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
        max_bin, ctypes.c_void_p(_build.stream_ptr(pm)))
    _build.check(code, "aat_comb")
    global LAUNCHES
    LAUNCHES += 1
    return score, run, tot
