"""YIN monophonic pitch detection, batched (port of
audio_analyzer_rs_tpu/ops/yin.py; de Cheveigné & Kawahara 2002).

The difference function comes from an FFT autocorrelation (`ops.fft`
`rfft_complex` / `irfft`), the cumulative-mean normalisation is a cumsum
and the threshold search a masked argmax: no data-dependent loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fft import irfft, rfft_complex

DEFAULT_THRESHOLD = 0.1


class YinResult(NamedTuple):
    f0_hz: torch.Tensor       # [N] estimated fundamental (0 where unvoiced)
    confidence: torch.Tensor  # [N] 1 - cmndf at the chosen lag
    voiced: torch.Tensor      # [N] bool


def _spectrum(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(*rfft_complex(x))


def yin_pitch(frames: torch.Tensor, sample_rate: float, fmin: float = 60.0,
              fmax: float = 2000.0, threshold: float = DEFAULT_THRESHOLD
              ) -> YinResult:
    """frames [N, W] → per-frame f0 via YIN with the CMNDF threshold."""
    n, w = frames.shape
    half = w // 2
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(sample_rate / fmin) + 1, half - 1)
    dev = frames.device

    x = frames.float()
    spec = _spectrum(torch.cat([x, torch.zeros_like(x)], -1))

    # d[tau] = sum_{j<half} (x_j - x_{j+tau})^2 = E0 + E_tau - 2 r_half[tau]:
    # E_tau from a sliding cumsum, r_half the cross-correlation of the first
    # half-window against the whole frame.
    cs = torch.cumsum(x ** 2, -1)
    cs = torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=dev), cs],
                   -1)
    taus = torch.arange(half, device=dev)
    e0 = cs[:, half][:, None] - cs[:, 0][:, None]
    e_tau = cs[:, taus + half] - cs[:, taus]
    spec_half = _spectrum(torch.cat(
        [x[:, :half], torch.zeros((n, 2 * w - half), dtype=torch.float32,
                                  device=dev)], -1))
    prod = torch.conj(spec_half) * spec
    r_half = irfft(prod.real, prod.imag)[:, :half]
    d = (e0 + e_tau - 2.0 * r_half).clamp_min(0.0)

    # CMNDF.
    cum = torch.cumsum(d[:, 1:], -1)
    tau_idx = torch.arange(1, half, dtype=torch.float32, device=dev)
    cmndf = torch.cat([torch.ones((n, 1), dtype=torch.float32, device=dev),
                       d[:, 1:] * tau_idx / cum.clamp_min(1e-12)], -1)

    # The first tau in [tau_min, tau_max] below threshold at a local min.
    in_range = (taus >= tau_min) & (taus <= tau_max)
    next_c = torch.cat([cmndf[:, 1:], cmndf[:, -1:]], -1)
    below = in_range & (cmndf < threshold) & (next_c >= cmndf)
    any_below = below.any(-1)
    first_below = torch.argmax(below.to(torch.uint8), -1)
    masked = torch.where(in_range, cmndf, torch.inf)
    global_min = torch.argmin(masked, -1)
    tau_star = torch.where(any_below, first_below, global_min)

    # Parabolic interpolation on cmndf around tau_star.
    t0 = (tau_star - 1).clamp(0, half - 1)
    t2 = (tau_star + 1).clamp(0, half - 1)
    y0 = cmndf.gather(1, t0[:, None])[:, 0]
    y1 = cmndf.gather(1, tau_star[:, None])[:, 0]
    y2 = cmndf.gather(1, t2[:, None])[:, 0]
    denom = y0 - 2.0 * y1 + y2
    delta = torch.where(denom.abs() < 1e-12, 0.0,
                        (0.5 * (y0 - y2) / denom).clamp(-1.0, 1.0))
    tau_refined = tau_star.float() + delta

    f0 = sample_rate / tau_refined.clamp_min(1.0)
    conf = 1.0 - y1
    voiced = any_below & (f0 >= fmin) & (f0 <= fmax)
    return YinResult(torch.where(voiced, f0, 0.0), conf, voiced)


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def yin_pitch_np(frame: np.ndarray, sample_rate: float, fmin: float = 60.0,
                 fmax: float = 2000.0, threshold: float = DEFAULT_THRESHOLD):
    """Slow loop oracle for one frame (float64)."""
    w = len(frame)
    half = w // 2
    x = frame.astype(np.float64)
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(sample_rate / fmin) + 1, half - 1)
    d = np.zeros(half)
    for tau in range(1, half):
        diff = x[:half] - x[tau:tau + half]
        d[tau] = np.sum(diff * diff)
    cmndf = np.ones(half)
    cum = 0.0
    for tau in range(1, half):
        cum += d[tau]
        cmndf[tau] = d[tau] * tau / max(cum, 1e-12)
    tau_star = None
    for tau in range(tau_min, tau_max + 1):
        nxt = cmndf[tau + 1] if tau + 1 < half else cmndf[tau]
        if cmndf[tau] < threshold and nxt >= cmndf[tau]:
            tau_star = tau
            break
    voiced = tau_star is not None
    if not voiced:
        seg = np.where((np.arange(half) >= tau_min)
                       & (np.arange(half) <= tau_max), cmndf, np.inf)
        tau_star = int(np.argmin(seg))
    t0, t2 = max(tau_star - 1, 0), min(tau_star + 1, half - 1)
    y0, y1, y2 = cmndf[t0], cmndf[tau_star], cmndf[t2]
    denom = y0 - 2 * y1 + y2
    delta = 0.0 if abs(denom) < 1e-12 else float(np.clip(0.5 * (y0 - y2) / denom,
                                                         -1, 1))
    f0 = sample_rate / max(tau_star + delta, 1.0)
    return f0 if voiced and fmin <= f0 <= fmax else 0.0, voiced
