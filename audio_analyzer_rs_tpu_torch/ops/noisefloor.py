"""Variance-aware per-bin noise floor (port of
audio_analyzer_rs_tpu/ops/noisefloor.py; ref src/audio_io/stft.rs:209-367).

The recurrence runs on tensors with any leading batch axes (a segment-stream
axis S in the segmented pipeline).  `noise_floor_scan` runs kernel K5
(ops/hopper_noisefloor.py, csrc/noisefloor.cu) on CUDA tensors and
`noise_floor_scan_plain`, a loop over `_step`, on CPU tensors.

Rounding: the JAX scan compiled by XLA:CPU contracts the alpha blend and the
floor update into fused multiply-adds (its bitwise oracle is
`noise_floor_np(fma=True)`); it does not contract the volatility EMA.  This
port computes the two fused expressions with `rounding.fma32`, which rounds
once to float32 as a hardware FMA does, and the kernel with `fmaf`, so the
plain loop, the kernel and the reference are bitwise equal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hopper_noisefloor
from .rounding import fma32

FLOOR_BASE_ALPHA = 0.04
FLOOR_FAST_ALPHA = 0.35
FLOOR_RELEASE = 0.02
VOL_MEMORY = 0.75
NOTE_RATIO = 1.5
NOTE_VOL_MAX = 0.15

# float32 values of the fused constants, as Python floats (exact in f64).
_BASE32 = float(np.float32(FLOOR_BASE_ALPHA))
_FAST_MINUS_BASE32 = float(np.float32(FLOOR_FAST_ALPHA - FLOOR_BASE_ALPHA))


class NoiseFloorState(NamedTuple):
    floor: torch.Tensor        # [..., H] per-bin noise floor
    prev_mag: torch.Tensor     # [..., H] previous frame magnitudes
    volatility: torch.Tensor   # [..., H] inter-frame jitter EMA
    initialized: torch.Tensor  # [...] bool


def init_state(half_size: int, device="cuda", batch: tuple = ()
               ) -> NoiseFloorState:
    z = torch.zeros(batch + (half_size,), dtype=torch.float32, device=device)
    return NoiseFloorState(z, z.clone(), z.clone(),
                           torch.zeros(batch, dtype=torch.bool, device=device))


def _step(state: NoiseFloorState, mags: torch.Tensor, global_floor):
    """One frame: mags [..., B], global_floor [...] → (new_state,
    effective_floor [..., B])."""
    g = global_floor[..., None]
    init_floor = torch.maximum(mags, g * 5.0)

    delta = (mags - state.prev_mag).abs()
    vol = state.volatility * VOL_MEMORY + delta * (1.0 - VOL_MEMORY)
    floor = state.floor
    above_ratio = mags / floor.clamp_min(0.01)
    vol_norm = (vol / mags.clamp_min(0.05)).clamp(0.0, 1.0)
    is_sustained = (above_ratio > NOTE_RATIO) & (vol_norm < NOTE_VOL_MAX)
    alpha_hot = fma32(vol_norm, _FAST_MINUS_BASE32, _BASE32)
    alpha = torch.where(mags > floor, alpha_hot, FLOOR_RELEASE)
    updated = torch.where(is_sustained, floor,
                          fma32(alpha, mags - floor, floor))

    init = state.initialized[..., None]
    new_floor = torch.where(init, updated, init_floor)
    new_vol = torch.where(init, vol, state.volatility)
    new_state = NoiseFloorState(new_floor, mags, new_vol,
                                torch.ones_like(state.initialized))
    effective = torch.minimum(new_floor, g * 2.5)
    return new_state, effective


def _scan_width(state: NoiseFloorState, mags: torch.Tensor,
                band: int | None) -> int:
    """The scanned width B: `band`, or the state's full width H when band
    is None or >= H (which needs full-width magnitudes)."""
    half = state.floor.shape[-1]
    if band is None or band >= half:
        if mags.shape[-1] < half:
            raise ValueError("full-width scan needs full-width magnitudes")
        return half
    return band


def with_tail(state: NoiseFloorState, sub: NoiseFloorState,
              mags: torch.Tensor, global_floor: torch.Tensor,
              first: torch.Tensor | None = None) -> NoiseFloorState:
    """The scanned state `sub` (width B) joined to the state above B: frozen
    while banded, but with a full-width first frame (`first` [..., H], or
    full-width magnitudes' frame 0) an uninitialized state's tail is seeded
    once by the first-frame rule.  `mags` has N >= 1 frames."""
    band, half = sub.floor.shape[-1], state.floor.shape[-1]
    if band == half:
        return sub
    init = state.initialized[..., None]
    if first is None and mags.shape[-1] >= half:
        first = mags[..., 0, :]
    if first is not None:
        first = first[..., band:half]
        seed_floor = torch.maximum(first, global_floor[..., 0, None] * 5.0)
        tail_floor = torch.where(init, state.floor[..., band:], seed_floor)
        tail_prev = torch.where(init, state.prev_mag[..., band:], first)
    else:
        tail_floor = state.floor[..., band:]
        tail_prev = state.prev_mag[..., band:]
    return NoiseFloorState(
        torch.cat([sub.floor, tail_floor], -1),
        torch.cat([sub.prev_mag, tail_prev], -1),
        torch.cat([sub.volatility, state.volatility[..., band:]], -1),
        sub.initialized)


def noise_floor_scan_plain(state: NoiseFloorState, mags: torch.Tensor,
                           global_floor: torch.Tensor,
                           band: int | None = None,
                           first: torch.Tensor | None = None):
    """The plain scan, a loop over `_step`: arguments and results as
    `noise_floor_scan`."""
    band = _scan_width(state, mags, band)
    n = mags.shape[-2]
    sub = NoiseFloorState(state.floor[..., :band], state.prev_mag[..., :band],
                          state.volatility[..., :band], state.initialized)
    eff = torch.empty(mags.shape[:-1] + (band,), dtype=torch.float32,
                      device=mags.device)
    if n == 0:
        return state, eff
    for i in range(n):
        sub, eff[..., i, :] = _step(sub, mags[..., i, :band],
                                    global_floor[..., i])
    return with_tail(state, sub, mags, global_floor, first), eff


def noise_floor_scan(state: NoiseFloorState, mags: torch.Tensor,
                     global_floor: torch.Tensor, band: int | None = None,
                     first: torch.Tensor | None = None):
    """mags [..., N, H'], global_floor [..., N] → (final state,
    effective_floor [..., N, B]).  Kernel K5 on CUDA tensors,
    `noise_floor_scan_plain` on CPU tensors.

    `band`: run the recurrence on the first `band` bins only and carry the
    state above it through frozen (B = band).  With full-width magnitudes
    an uninitialized state's above-band floor is seeded once by the
    first-frame rule; with banded magnitudes the tail stays frozen, unless
    `first` [..., H] (each stream's first frame at full width, the same
    bits as full-width magnitudes' frame 0) is given: then it seeds the
    tail as they would.  band=None (or >= H) scans the full width and
    needs full-width mags."""
    return hopper_noisefloor.noise_floor_scan(state, mags, global_floor,
                                              _scan_width(state, mags, band),
                                              first)


def global_floor_linear(noise_floor_db, half_size: int):
    """ref stft.rs:322-324.  A float computes in numpy float32 (the JAX
    module's host form); a tensor (the full step's per-frame causal floors,
    parallel/sharding.py) as XLA computes the JAX module's traced form:
    10 ** (db * float32(0.05)) * (half_size / 2)."""
    if isinstance(noise_floor_db, torch.Tensor):
        return (torch.pow(10.0, noise_floor_db.to(torch.float32)
                          * float(np.float32(0.05))) * (half_size / 2.0))
    return np.float32(
        np.float32(10.0) ** (np.float32(noise_floor_db) / np.float32(20.0))
        * np.float32(half_size / 2.0))


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def _fma32(a, b, c):
    """float32 fused multiply-add emulation: the exact product a*b is
    representable in float64 (f32 has 24 mantissa bits), so computing
    a*b + c in float64 and rounding once to float32 reproduces a hardware
    f32 FMA except in astronomically rare double-rounding ties."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def noise_floor_np(mags: np.ndarray, global_floor: np.ndarray,
                   fma: bool = False) -> np.ndarray:
    """[N, H] magnitudes → [N, H] effective floors, float32 loop transcription.

    `fma=False` is the plain transcription (every multiply and add rounds
    separately, like the reference's Rust f32 expressions without
    contraction).  `fma=True` contracts the alpha blend and the floor
    update into fused multiply-adds — the rounding XLA:CPU's LLVM backend
    actually emits for `_step`.  With fma=True the output is bitwise equal
    to `noise_floor_scan` at the production banded configuration on the
    CPU backend (verified over a 25 s mixed scene,
    tests/test_divergence_proof.py); the two variants differ only at
    1-ulp scale, which is precisely the fp32 sensitivity the composed
    divergence tests quantify."""
    n, h = mags.shape
    floor = np.zeros(h, dtype=np.float32)
    prev = np.zeros(h, dtype=np.float32)
    vol = np.zeros(h, dtype=np.float32)
    out = np.zeros_like(mags, dtype=np.float32)
    initialized = False
    for i in range(n):
        m = mags[i].astype(np.float32)
        g = np.float32(global_floor[i])
        if not initialized:
            floor = np.maximum(m, g * np.float32(5.0))
            prev = m.copy()
            initialized = True
        else:
            delta = np.abs(m - prev)
            vol = vol * np.float32(VOL_MEMORY) + delta * np.float32(1.0 - VOL_MEMORY)
            prev = m.copy()
            above = m / np.maximum(floor, np.float32(0.01))
            vn = np.clip(vol / np.maximum(m, np.float32(0.05)), 0.0, 1.0)
            sustained = (above > NOTE_RATIO) & (vn < NOTE_VOL_MAX)
            fast_minus_base = np.float32(FLOOR_FAST_ALPHA - FLOOR_BASE_ALPHA)
            if fma:
                alpha_hot = _fma32(fast_minus_base, vn,
                                   np.float32(FLOOR_BASE_ALPHA))
                updated = _fma32(np.where(m > floor, alpha_hot,
                                          np.float32(FLOOR_RELEASE)),
                                 m - floor, floor)
            else:
                alpha_hot = (np.float32(FLOOR_BASE_ALPHA)
                             + fast_minus_base * vn)
                alpha = np.where(m > floor, alpha_hot,
                                 np.float32(FLOOR_RELEASE))
                updated = floor + alpha * (m - floor)
            floor = np.where(sustained, floor, updated).astype(np.float32)
        out[i] = np.minimum(floor, g * np.float32(2.5))
    return out
