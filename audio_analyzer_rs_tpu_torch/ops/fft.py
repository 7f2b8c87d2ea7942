"""Real-FFT magnitudes (port of audio_analyzer_rs_tpu/ops/fft.py).

Two backends:

* ``fft`` — the real FFT's magnitude, full spectrum (the full-spectrum
  default).  On a CUDA tensor this is kernel K11 (ops/hopper_rfft.py: one
  fixed order of operations a frame, so a frame's bits do not depend on the
  batch); on a CPU tensor its plain version, `torch.fft.rfft(...).abs()`.
* ``dft`` — frames @ an interleaved cos/-sin table, then the magnitude; with
  `band`, only the first `band` bins.  On a CUDA tensor this is kernel K1
  (ops/hopper_stft.py); on a CPU tensor its plain matmul version.

`rfft_complex` and `irfft` (YIN's FFT autocorrelation) are library FFTs
(cuFFT on the card), as in the JAX package, which computes them with
`jnp.fft`.

The constant tables are built with the JAX module's own numpy formulas, so
they are bit-equal to the reference's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import hopper_rfft, hopper_stft

DEFAULT_BACKEND = "fft"


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann, exactly the reference's formula (ref stft.rs:641-648)."""
    i = np.arange(n, dtype=np.float32)
    x = i / np.float32(n)
    return (np.float32(0.5) - np.float32(0.5)
            * np.cos(np.float32(2.0) * np.float32(np.pi) * x)).astype(np.float32)


@lru_cache(maxsize=8)
def _rdft_trig(n: int) -> np.ndarray:
    """[W, 2H] matrix with interleaved cos/-sin columns (built in float64)."""
    half = n // 2 + 1
    t = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(half, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / n
    trig = np.empty((n, 2 * half), dtype=np.float32)
    trig[:, 0::2] = np.cos(ang)
    trig[:, 1::2] = -np.sin(ang)
    trig.flags.writeable = False
    return trig


@lru_cache(maxsize=16)
def rdft_trig(n: int, device: torch.device) -> torch.Tensor:
    """The [W, 2H] rDFT table on `device` (cached per device)."""
    return torch.from_numpy(_rdft_trig(n).copy()).to(device)


@lru_cache(maxsize=16)
def hann(n: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window on `device` (cached per device)."""
    return torch.from_numpy(hann_window(n)).to(device)


def dft_mag(frames: torch.Tensor, band: int | None = None,
            window: torch.Tensor | None = None) -> torch.Tensor:
    """[..., W] frames (× window) → [..., band] rDFT magnitudes."""
    n = frames.shape[-1]
    half = n // 2 + 1
    if band is None or band >= half:
        band = half
    trig = rdft_trig(n, frames.device)[:, :2 * band]
    return hopper_stft.dft_mag(frames, trig, window)


def rfft_mag(frames: torch.Tensor, backend: str = DEFAULT_BACKEND,
             band: int | None = None) -> torch.Tensor:
    """Magnitude spectrum of real frames: [..., W] → [..., B] float32
    (B = band, default W//2+1)."""
    n = frames.shape[-1]
    half = n // 2 + 1
    if band is None or band >= half:
        band = half
    if backend == "fft":
        return hopper_rfft.rfft_mag(frames.float(), band)
    if backend != "dft":
        raise ValueError(f"backend={backend!r}: expected 'fft' or 'dft'")
    return dft_mag(frames.float(), band)


def rfft_complex(frames: torch.Tensor, backend: str = DEFAULT_BACKEND
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of the rDFT, [..., W] → two [..., W//2+1] float32 — for
    callers that need phase.  "fft" is torch.fft (cuFFT on the card); "dft"
    the float32 product with the rDFT table (a plain matmul, as the JAX
    package leaves it to XLA)."""
    if backend == "fft":
        spec = torch.fft.rfft(frames.float(), dim=-1)
        return spec.real.contiguous(), spec.imag.contiguous()
    if backend != "dft":
        raise ValueError(f"backend={backend!r}: expected 'fft' or 'dft'")
    n = frames.shape[-1]
    re_im = torch.matmul(frames.float(), rdft_trig(n, frames.device))
    re_im = re_im.reshape(frames.shape[:-1] + (n // 2 + 1, 2))
    return re_im[..., 0], re_im[..., 1]


def irfft(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse real FFT of (re, im) [..., H] → [..., 2*(H-1)] float32,
    normalised like `numpy.fft.irfft` (irfft(rfft(x)) == x)."""
    return torch.fft.irfft(torch.complex(re.float(), im.float()),
                           dim=-1).float()


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def rfft_mag_np(frames: np.ndarray) -> np.ndarray:
    return np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1))
