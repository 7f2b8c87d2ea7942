"""Batched STFT: frame → Hann window → rDFT magnitude (port of
audio_analyzer_rs_tpu/ops/stft.py).

The pitch pipeline's backend is the candidate-banded rDFT (`"dft_band"`):
the pitch stages read only bins [0, kc+1), ~465 of 1025.  Its `"dft"` base
is kernel K1 on CUDA tensors (window multiply fused, ops/hopper_stft.py).
The `"fft"` backend is kernel K11 on CUDA tensors (the window applied as
the frames load, ops/hopper_rfft.py) and `torch.fft.rfft(frames *
hann).abs()` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.framing import frame_signal, num_frames
from . import hopper_rfft
from .fft import DEFAULT_BACKEND, dft_mag, hann, hann_window, rfft_mag

# Pitch-analysis geometry (ref stft.rs:169-171).
PITCH_WINDOW = 2048
PITCH_HOP = 512
# Onset-analysis geometry (ref onset.rs:122-125).
ONSET_WINDOW = 256
ONSET_HOP = 64

# The pitch pipeline's backend: the candidate-banded rDFT (see the module
# docstring).  Full-spectrum consumers keep fft.DEFAULT_BACKEND.
PITCH_BACKEND = "dft_band"

# The spectral fidelity gate: relative MSE of the magnitudes against the
# float64 oracle on a harmonic probe.
FIDELITY_MAX_REL_MSE = 1e-6


def windowed_mags(frames: torch.Tensor, window: int = PITCH_WINDOW,
                  backend: str = DEFAULT_BACKEND,
                  band: int | None = None) -> torch.Tensor:
    """[..., N, window] pre-framed audio → [..., N, band or window//2+1]
    magnitudes.  backend "fft" (kernel K11 on CUDA, torch.fft on the CPU)
    or "dft" (kernel K1 on CUDA); on CUDA both apply the Hann window as
    they load the frames."""
    if backend == "dft":
        return dft_mag(frames, band, hann(window, frames.device))
    if backend == "fft":
        return hopper_rfft.rfft_mag(frames, band, hann(window, frames.device))
    return rfft_mag(frames * hann(window, frames.device), backend=backend,
                    band=band)


def stft_mags(x: torch.Tensor, window: int = PITCH_WINDOW,
              hop: int = PITCH_HOP,
              backend: str = DEFAULT_BACKEND) -> torch.Tensor:
    """[n] float32 mono → [num_frames, window//2+1] magnitude spectra.
    A "_band" backend name computes the full width with its base backend."""
    if backend.endswith("_band"):
        backend = backend[:-len("_band")]
    return windowed_mags(frame_signal(x, window, hop), window, backend)


def stft_mags_np(x: np.ndarray, window: int = PITCH_WINDOW,
                 hop: int = PITCH_HOP) -> np.ndarray:
    """Float64 NumPy oracle of `stft_mags` (reference-transcribed semantics)."""
    n = num_frames(len(x), window, hop)
    win = hann_window(window).astype(np.float64)
    out = np.empty((n, window // 2 + 1), dtype=np.float64)
    for i in range(n):
        seg = x[i * hop:i * hop + window].astype(np.float64) * win
        out[i] = np.abs(np.fft.rfft(seg))
    return out


def spectral_rel_mse(x: np.ndarray, window: int = PITCH_WINDOW,
                     hop: int = PITCH_HOP, backend: str = PITCH_BACKEND,
                     device: str | torch.device = "cuda") -> float:
    """The fidelity gate's measure: relative MSE of `stft_mags` on `device`
    against the float64 oracle (the JAX bench's gate).  The gate passes
    below FIDELITY_MAX_REL_MSE."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    mags = stft_mags(xt, window, hop, backend).cpu().numpy()
    oracle = stft_mags_np(x, window, hop)
    return float(np.mean((mags - oracle) ** 2) / np.mean(oracle ** 2))
