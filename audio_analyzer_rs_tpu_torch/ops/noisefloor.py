"""Variance-aware per-bin noise floor (port of
audio_analyzer_rs_tpu/ops/noisefloor.py; ref src/audio_io/stft.rs:209-367).

The recurrence runs as a loop over frames on tensors with any leading batch
axes (a segment-stream axis S in the segmented pipeline).

Rounding: the JAX scan compiled by XLA:CPU contracts the alpha blend and the
floor update into fused multiply-adds (its bitwise oracle is
`noise_floor_np(fma=True)`).  This port computes those two expressions in
float64 and rounds once to float32 — the oracle's `_fma32` — so it is
bitwise equal to the reference on every device, independent of what a
compiler would contract.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def _fma32(a, b, c):
    """a*b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b + c).float()


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
    alpha_hot = _fma32(vol_norm, _FAST_MINUS_BASE32, _BASE32)
    alpha = torch.where(mags > floor, alpha_hot, FLOOR_RELEASE)
    updated = torch.where(is_sustained, floor,
                          _fma32(alpha, (mags - floor).double(),
                                 floor.double()))

    init = state.initialized[..., None]
    new_floor = torch.where(init, updated, init_floor)
    new_vol = torch.where(init, vol, state.volatility)
    new_state = NoiseFloorState(new_floor, mags, new_vol,
                                torch.ones_like(state.initialized))
    effective = torch.minimum(new_floor, g * 2.5)
    return new_state, effective


def noise_floor_scan(state: NoiseFloorState, mags: torch.Tensor,
                     global_floor: torch.Tensor, band: int | None = None):
    """mags [..., N, H'], global_floor [..., N] → (final state,
    effective_floor [..., N, B]).

    `band`: run the recurrence on the first `band` bins only and carry the
    state above it through frozen (B = band).  With full-width magnitudes
    an uninitialized state's above-band floor is seeded once by the
    first-frame rule; with banded magnitudes the tail stays frozen.
    band=None (or >= H) scans the full width and needs full-width mags."""
    half = state.floor.shape[-1]
    n = mags.shape[-2]
    full = band is None or band >= half
    if full:
        if mags.shape[-1] < half:
            raise ValueError("full-width scan needs full-width magnitudes")
        band = half
    sub = NoiseFloorState(state.floor[..., :band], state.prev_mag[..., :band],
                          state.volatility[..., :band], state.initialized)
    eff = torch.empty(mags.shape[:-1] + (band,), dtype=torch.float32,
                      device=mags.device)
    for i in range(n):
        sub, eff[..., i, :] = _step(sub, mags[..., i, :band],
                                    global_floor[..., i])
    if full or n == 0:
        return (sub if n else state), eff

    init = state.initialized[..., None]
    if mags.shape[-1] >= half:
        first = mags[..., 0, band:half]
        seed_floor = torch.maximum(first, global_floor[..., 0, None] * 5.0)
        tail_floor = torch.where(init, state.floor[..., band:], seed_floor)
        tail_prev = torch.where(init, state.prev_mag[..., band:], first)
    else:
        tail_floor = state.floor[..., band:]
        tail_prev = state.prev_mag[..., band:]
    new_state = NoiseFloorState(
        torch.cat([sub.floor, tail_floor], -1),
        torch.cat([sub.prev_mag, tail_prev], -1),
        torch.cat([sub.volatility, state.volatility[..., band:]], -1),
        sub.initialized)
    return new_state, eff


def global_floor_linear(noise_floor_db: float, half_size: int) -> np.float32:
    """ref stft.rs:322-324, in numpy float32 (the JAX module's host form)."""
    return np.float32(
        np.float32(10.0) ** (np.float32(noise_floor_db) / np.float32(20.0))
        * np.float32(half_size / 2.0))
