"""Per-frame spectral feature pack: RMS/energy, centroid, rolloff, flux
(port of audio_analyzer_rs_tpu/ops/features.py; ref onset.rs:261-291,
dynamics.rs:195-199).  Plain PyTorch reductions over [N, ...] frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FrameFeatures(NamedTuple):
    rms: torch.Tensor          # [N] time-domain RMS per frame
    energy: torch.Tensor       # [N] sum of spectral magnitudes
    centroid_hz: torch.Tensor  # [N] spectral centroid
    rolloff_hz: torch.Tensor   # [N] 85% rolloff frequency
    flux: torch.Tensor         # [N] positive spectral flux vs the frame before


def feature_pack(frames: torch.Tensor, mags: torch.Tensor,
                 sample_rate: float, window: int,
                 rolloff_pct: float = 0.85) -> FrameFeatures:
    """frames [N, W] (unwindowed), mags [N, H] → per-frame features.  The
    first frame's flux is taken against zeros."""
    half = mags.shape[-1]
    bin_hz = float(np.float32(sample_rate / window))
    freqs = torch.arange(half, dtype=torch.float32,
                         device=mags.device) * bin_hz

    rms = torch.sqrt(torch.mean(frames.float() ** 2, dim=-1))
    energy = mags.sum(-1)
    centroid = (mags * freqs).sum(-1) / energy.clamp_min(1e-12)

    cum = torch.cumsum(mags, dim=-1)
    target = rolloff_pct * cum[:, -1:]
    # The first bin where the cumulative sum reaches the target.
    rolloff_bin = torch.argmax((cum >= target).to(torch.uint8), dim=-1)
    rolloff = rolloff_bin.float() * bin_hz

    prev = torch.cat([torch.zeros_like(mags[:1]), mags[:-1]], 0)
    flux = (mags - prev).clamp_min(0.0).sum(-1)
    return FrameFeatures(rms=rms, energy=energy, centroid_hz=centroid,
                         rolloff_hz=rolloff, flux=flux)


def rms_db(rms_linear: torch.Tensor) -> torch.Tensor:
    """Linear → dBFS with the reference's 1e-9 floor (ref
    dynamics.rs:365-368)."""
    return 20.0 * torch.log10(rms_linear.clamp_min(1e-9))


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def feature_pack_np(frames: np.ndarray, mags: np.ndarray, sample_rate: float,
                    window: int, rolloff_pct: float = 0.85):
    """Float64 NumPy oracle of `feature_pack`."""
    half = mags.shape[-1]
    freqs = np.arange(half) * (sample_rate / window)
    rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=-1))
    energy = mags.sum(axis=-1)
    centroid = (mags * freqs).sum(axis=-1) / np.maximum(energy, 1e-12)
    cum = np.cumsum(mags, axis=-1)
    rolloff_bin = np.argmax(cum >= rolloff_pct * cum[:, -1:], axis=-1)
    rolloff = rolloff_bin * (sample_rate / window)
    prev = np.vstack([np.zeros_like(mags[:1]), mags[:-1]])
    flux = np.maximum(mags - prev, 0.0).sum(axis=-1)
    return rms, energy, centroid, rolloff, flux
