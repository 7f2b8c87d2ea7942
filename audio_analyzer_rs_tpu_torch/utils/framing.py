"""Hop-strided framing: audio → [frames, window] (port of
audio_analyzer_rs_tpu/utils/framing.py).

`frame_signal` is `Tensor.unfold`: a strided view, no copy.  Kernel K1 reads
such views in place, so framing never materialises the 4x-expanded
[frames, window] array on the hot path.
"""

from __future__ import annotations

import numpy as np
import torch


def num_frames(n_samples: int, window: int, hop: int) -> int:
    """Frames produced by the reference ring-buffer loop: while avail >= window."""
    if n_samples < window:
        return 0
    return (n_samples - window) // hop + 1


def frame_signal(x: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """[..., n] → [..., num_frames, window], a view of x."""
    return x.unfold(-1, window, hop)


def pad_to_frames(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Zero-pad the tail so every sample lands in at least one full frame."""
    n = len(x)
    if n < window:
        return np.pad(x, (0, window - n)).astype(np.float32)
    rem = (n - window) % hop
    if rem:
        x = np.pad(x, (0, hop - rem))
    return x.astype(np.float32)


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def frame_signal_np(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    """NumPy oracle twin of `frame_signal` for parity tests."""
    n = num_frames(len(x), window, hop)
    out = np.empty((n, window), dtype=np.float32)
    for i in range(n):
        out[i] = x[i * hop:i * hop + window]
    return out
