"""K11 — the windowed real-FFT magnitude as a Hopper kernel (csrc/rfft_mag.cu).

Replaces no TPU kernel.  The JAX package computes these magnitudes with
`jnp.abs(jnp.fft.rfft(...))` (audio_analyzer_rs_tpu/ops/fft.py:77, left to
XLA); the port's "fft" backend was `torch.fft.rfft(frames * hann).abs()`,
cuFFT on the card.  K11 took its place there for two reasons:

* cuFFT's 2,048-point bits change with how many frames share the call, so a
  stream's results depended on the batch, the mesh and the pool's lanes;
* the window product, the complex spectrum and the magnitude were three
  passes over device memory: 5.1 of the full step's 11.75 card ms.

K11 computes every frame by one fixed sequence of IEEE float32 operations,
whatever the batch, the frame's place in it or the launch's grid: a frame's
magnitudes are bitwise the same at any B, on any mesh, in a live slot or a
pool wave.  `rfft_mag_fixed_np` below is that sequence in numpy, vectorized
over frames; the card tests hold K11 to it bit for bit.

The sequence, for a frame x of W = 2M samples (W a power of two, 64-4,096)
and a window w (None: rectangular):
  1. z[m] = w[2m]·x[2m] + i·w[2m+1]·x[2m+1], one rounded product each;
  2. Z = the M-point FFT of z by log2(M) radix-2 Stockham stages: stage s
     (Ns = 2^s) takes a = z[j], b = z[j + M/2] for j < M/2, k = j mod Ns,
     t = b·T (T = e^{-iπk/Ns} from the table; re = br·Tr − bi·Ti,
     im = br·Ti + bi·Tr), and writes a + t to [2j − k], a − t to
     [2j − k + Ns];
  3. the real spectrum's bin k in [0, band), doubled: with (a, b) = Z[k mod
     M] and (c, d) = Z[(M − k) mod M], E = (a + c, b − d), O = (b + d,
     c − a), (Tr, Ti) = e^{-2πik/W}: X2 = (Er + (Tr·Or − Ti·Oi), Ei +
     (Tr·Oi + Ti·Or));
  4. |X| = sqrt(X2r² + X2i²)·½, the sum of squares taken after scaling both
     parts by 2^100 where the larger is below 2^-60, by 2^-100 where it is
     above 2^60, and the ½ folded into the scale back: a power of two,
     exact outside the subnormal range, so silence-level frames keep their
     relative precision.

The twiddles are one float32 table built in float64 by numpy (as
ops/fft.py `_rdft_trig` is), cached per device: each stage's Ns factors in
a row of their own (stage s at [Ns − 1, 2Ns − 1)), then the W/2 + 1 factors
of step 3.

The plain version is `torch.fft.rfft(frames * window).abs()`, today's
"fft" path and on the card the library yardstick: cuFFT sums in another
order than K11, so it is held to K11 within a tolerance, not bitwise.
`rfft_mag` is the wrapper: the plain version for CPU tensors (every CPU
result keeps its bits), K11 for CUDA tensors (or it raises).
`rfft_mag_first` adds each outer row's first frame at full width, from
the same launch (the full step's pitch call: its first frames seed the
noise floor's state above the band on a fresh stream).

`rfft_complex` and `irfft` (YIN's autocorrelation, ops/fft.py) stay on
cuFFT: they are the library FFTs of a JAX `jnp.fft` call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build

LAUNCHES = 0
MIN_WIDTH = 64      # csrc/rfft_mag.cu: 32 complex values a thread
MAX_WIDTH = 4096
# Step 4's scaling (csrc/rfft_mag.cu `magnitude`).
TINY = np.float32(2.0 ** -60)
HUGE = np.float32(2.0 ** 60)


def widths() -> tuple[int, ...]:
    """The frame widths K11 takes: powers of two from 64 to 4,096."""
    w, out = MIN_WIDTH, []
    while w <= MAX_WIDTH:
        out.append(w)
        w *= 2
    return tuple(out)


@lru_cache(maxsize=16)
def twiddles_np(width: int) -> tuple[np.ndarray, np.ndarray]:
    """(stage [M, 2], post [M + 1, 2]) float32, M = width / 2: post[k] =
    (cos, −sin)(2πk / width) rounded from float64; stage row Ns − 1 + k is
    post[k · M / Ns], stage s's factor e^{-iπk/Ns} (the last row is unused
    padding)."""
    half = width // 2
    k = np.arange(half + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / width
    post = np.empty((half + 1, 2), dtype=np.float32)
    post[:, 0] = np.cos(ang)
    post[:, 1] = -np.sin(ang)
    stage = np.zeros((half, 2), dtype=np.float32)
    levels = half.bit_length() - 1
    for s in range(levels):
        ns = 1 << s
        stage[ns - 1:2 * ns - 1] = post[np.arange(ns) << (levels - s)]
    post.flags.writeable = False
    stage.flags.writeable = False
    return stage, post


@lru_cache(maxsize=32)
def twiddle_table(width: int, device: torch.device) -> torch.Tensor:
    """The kernel's table on `device`: [2M + 1, 2] float32, the stage rows
    then the post rows (cached per device)."""
    stage, post = twiddles_np(width)
    return torch.from_numpy(np.concatenate([stage, post])).to(device)


@lru_cache(maxsize=32)
def _ones(width: int, device: torch.device) -> torch.Tensor:
    """The rectangular window: x·1.0 is x, so K11 multiplies always."""
    return torch.ones(width, dtype=torch.float32, device=device)


def _check_width(width: int) -> None:
    if width not in widths():
        raise ValueError(f"rfft_mag: window width {width} is not a power of "
                         f"two from {MIN_WIDTH} to {MAX_WIDTH}")


def _band(width: int, band: int | None) -> int:
    half = width // 2 + 1
    return half if band is None or band >= half else band


def rfft_mag_fixed_np(frames: np.ndarray, band: int | None = None,
                      window: np.ndarray | None = None) -> np.ndarray:
    """K11's operation sequence in numpy float32 (the module docstring's
    steps 1-4), vectorized over frames: [..., W] → [..., band]."""
    x = np.asarray(frames, dtype=np.float32)
    width = x.shape[-1]
    _check_width(width)
    band = _band(width, band)
    if window is not None:
        x = x * np.asarray(window, dtype=np.float32)
    half = width // 2
    levels = half.bit_length() - 1
    stage, post = twiddles_np(width)
    zr = np.ascontiguousarray(x[..., 0::2])
    zi = np.ascontiguousarray(x[..., 1::2])
    j = np.arange(half // 2)
    for s in range(levels):
        ns = 1 << s
        k = j & (ns - 1)
        wr, wi = stage[ns - 1 + k, 0], stage[ns - 1 + k, 1]
        ar, ai = zr[..., :half // 2], zi[..., :half // 2]
        br, bi = zr[..., half // 2:], zi[..., half // 2:]
        tr = br * wr - bi * wi
        ti = br * wi + bi * wr
        yr, yi = np.empty_like(zr), np.empty_like(zi)
        lo = 2 * j - k
        yr[..., lo], yi[..., lo] = ar + tr, ai + ti
        yr[..., lo + ns], yi[..., lo + ns] = ar - tr, ai - ti
        zr, zi = yr, yi
    k = np.arange(band)
    a, b = zr[..., k % half], zi[..., k % half]
    c, d = zr[..., (half - k) % half], zi[..., (half - k) % half]
    er, ei, o_r, o_i = a + c, b - d, b + d, c - a
    tr, ti = post[k, 0], post[k, 1]
    xr = er + (tr * o_r - ti * o_i)
    xi = ei + (tr * o_i + ti * o_r)
    big = np.fmax(np.abs(xr), np.abs(xi))
    one = np.float32(1.0)
    up = np.where(big < TINY, np.float32(2.0 ** 100),
                  np.where(big > HUGE, np.float32(2.0 ** -100), one))
    back = np.where(big < TINY, np.float32(2.0 ** -101),
                    np.where(big > HUGE, np.float32(2.0 ** 99),
                             np.float32(0.5)))
    xr, xi = xr * up, xi * up
    return (np.sqrt(xr * xr + xi * xi) * back).astype(np.float32)


def rfft_mag_plain(frames: torch.Tensor, band: int | None = None,
                   window: torch.Tensor | None = None) -> torch.Tensor:
    """The library version: torch.fft.rfft of (frames × window), its
    magnitude, the first `band` bins."""
    x = frames if window is None else frames * window
    mags = torch.fft.rfft(x.float(), dim=-1).abs()
    band = _band(frames.shape[-1], band)
    return mags if band == mags.shape[-1] else mags[..., :band]


def rfft_mag_first_plain(frames: torch.Tensor, band: int | None = None,
                         window: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `rfft_mag_first`: the full width's magnitudes,
    their first `band` bins and their frame 0 along the frame axis (as the
    kernel writes it, contiguous)."""
    full = rfft_mag_plain(frames, None, window)
    band = _band(frames.shape[-1], band)
    return full[..., :band], full[..., 0, :].contiguous()


def check_args(frames: torch.Tensor, band: int | None,
               window: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """Raise on what K11 does not take → (frames as [A, F, W] with unit
    stride along W, band)."""
    if frames.dtype != torch.float32:
        raise TypeError(f"rfft_mag: frames must be float32, got "
                        f"{frames.dtype}")
    if frames.dim() < 1:
        raise ValueError("rfft_mag: frames need a sample axis")
    width = frames.shape[-1]
    _check_width(width)
    band = _band(width, band)
    if band < 1:
        raise ValueError(f"rfft_mag: band {band} < 1")
    if window is not None and (
            window.shape != (width,) or window.dtype != torch.float32
            or not window.is_contiguous()
            or window.device != frames.device):
        raise ValueError(f"rfft_mag: window must be contiguous float32 "
                         f"[{width}] on {frames.device}")
    if frames.stride(-1) != 1 and frames.shape[-1] > 1:
        raise ValueError("rfft_mag: frames need unit stride along W")
    if frames.dim() == 1:
        return frames.reshape(1, 1, width), band
    if frames.dim() == 2:
        return frames[None], band
    return frames.reshape(-1, frames.shape[-2], width), band


def rfft_mag(frames: torch.Tensor, band: int | None = None,
             window: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitudes [..., band] of the real FFT of (frames [..., W] ×
    window [W]); band defaults to W/2 + 1.  On CPU tensors the plain
    version; on CUDA tensors K11, read in place through the frames'
    strides (an unfold view is not copied)."""
    if frames.device.type == "cpu":
        return rfft_mag_plain(frames, band, window)
    if frames.device.type != "cuda":
        raise ValueError(f"rfft_mag: unsupported device {frames.device}")
    f3, band = check_args(frames, band, window)
    out = torch.empty(frames.shape[:-1] + (band,), dtype=torch.float32,
                      device=frames.device)
    return _launch(f3, band, window, out)


def rfft_mag_first(frames: torch.Tensor, band: int | None = None,
                   window: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """`rfft_mag` of frames [..., F, W] (F >= 1) and the full width of each
    frame 0 along F → (magnitudes [..., F, band], first [..., W/2 + 1]),
    the same bits as `rfft_mag(frames)[..., :band]` and `[..., 0, :]`.  On
    CPU tensors the plain version; on CUDA tensors one K11 launch writes
    both."""
    if frames.dim() < 2 or frames.shape[-2] < 1:
        raise ValueError("rfft_mag_first: frames need a frame axis with a "
                         "frame")
    if frames.device.type == "cpu":
        return rfft_mag_first_plain(frames, band, window)
    if frames.device.type != "cuda":
        raise ValueError(f"rfft_mag_first: unsupported device "
                         f"{frames.device}")
    f3, band = check_args(frames, band, window)
    out = torch.empty(frames.shape[:-1] + (band,), dtype=torch.float32,
                      device=frames.device)
    first = torch.empty(frames.shape[:-2] + (frames.shape[-1] // 2 + 1,),
                        dtype=torch.float32, device=frames.device)
    return _launch(f3, band, window, out, first), first


def _launch(f3: torch.Tensor, band: int, window: torch.Tensor | None,
            out: torch.Tensor, first: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Launch K11 on checked [A, F, W] frames into `out` (contiguous,
    A·F·band floats) and, where given, frame 0 of each of the A rows at
    full width into `first` (contiguous, A·(W/2 + 1) floats)."""
    lib = _build.lib()
    outer, per_row, width = f3.shape
    n = outer * per_row
    if n == 0:
        return out
    win = _ones(width, f3.device) if window is None else window
    s_out, s_in = f3.stride(0), f3.stride(1)
    # float2 loads where every frame starts on an 8-byte boundary.
    vec2 = int(f3.data_ptr() % 8 == 0
               and (outer == 1 or s_out % 2 == 0)
               and (per_row == 1 or s_in % 2 == 0))
    head = (f3.data_ptr(), s_out, s_in, per_row, win.data_ptr(),
            twiddle_table(width, f3.device).data_ptr(), out.data_ptr())
    tail = (n, width.bit_length() - 1, band, vec2,
            ctypes.c_void_p(_build.stream_ptr(f3)))
    if first is None:
        name, code = "aat_rfft_mag", lib.aat_rfft_mag(*head, *tail)
    else:
        name = "aat_rfft_mag_first"
        code = lib.aat_rfft_mag_first(*head, first.data_ptr(), *tail)
    _build.check(code, name)
    global LAUNCHES
    LAUNCHES += 1
    return out
