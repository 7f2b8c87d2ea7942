"""Spectral-flux onset detection over 256-point STFT frames (port of
audio_analyzer_rs_tpu/ops/onset.py; ref src/analysis/onset.rs:47-84,244-543).

Frequency-weighted positive flux over 3-bin-smoothed magnitudes, per-bin
"rise-once" burst floors, the adaptive FluxTracker threshold, the
asymmetric energy EMA gate, a 3-frame refractory counter and the per-frame
tick and calibration gates.  Every function takes a leading stream axis S:
state leaves [S, ...], magnitudes [S, N, H], per-frame inputs [S, N].

`onset_scan` runs kernel K4 (ops/hopper_onset.py, csrc/onset.cu) on CUDA
tensors and `onset_scan_plain`, a loop over `_step`, on CPU tensors.

Rounding, so that the plain loop, the kernel and the JAX scan agree:
- The flux and energy sums run in one fixed order, `tree_sum`: the bins
  padded with +0.0 to 256, a stride-halving tree inside each group of 32
  bins, then across the 8 groups.  The kernel repeats it with warp
  shuffles.  (XLA's own order is not specified; the CPU tests hold these
  sums to the JAX scan within a stated tolerance.)
- XLA:CPU contracts four expressions into fused multiply-adds: the bin
  weight fma(-i, 1/H, 1), the floor blend fma(rise, m - floor0, floor0),
  the energy EMA fma(ema, mem, energy*(1 - mem)) and the threshold
  fma(thr, mem, flux*(1 - mem)); and it divides by a constant as a product
  with the float32 reciprocal (the smoothing's / 3, the velocity's / 50).
  tests/test_torch_onset.py finds each of these from JAX's bits.  The port
  computes the contracted ones with `rounding.fma32`, one rounding to
  float32, and the kernel with `fmaf`; everything else rounds after each
  operation, and `r`'s division of two tensors is IEEE division everywhere.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import hopper_onset
from .rounding import fma32

WINDOW = 256
HOP = 64
HALF = WINDOW // 2 + 1

FLUX_MULTIPLIER = 1.5
FLUX_RISE_MEMORY = 0.84
FLUX_DECAY_MEMORY = 0.89
FLUX_THRESHOLD_FLOOR = 0.9
ENERGY_EMA_RISE = 0.84
ENERGY_EMA_DECAY = 0.95
ENERGY_RISING_RATIO = 1.5
BIN_BURST_RATIO = 2.5
FLOOR_OVERCOMPENSATE = 1.3
FLOOR_RISE = 0.1
FLOOR_DECAY = 0.04
TICK_GUARD_S = 0.015
REFRACTORY_FRAMES = 3

TREE_WIDTH = 256     # tree_sum pads the bins to this many
_GROUP = 32          # the kernel's warp: the tree's first levels


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(v))


class OnsetState(NamedTuple):
    prev_mag: torch.Tensor            # [..., H]
    floor: torch.Tensor               # [..., H]
    floor_init: torch.Tensor          # [...] bool
    threshold: torch.Tensor           # [...] FluxTracker threshold
    energy_ema: torch.Tensor          # [...]
    frames_since_onset: torch.Tensor  # [...] int32


class OnsetFrameOut(NamedTuple):
    fired: torch.Tensor          # bool — passed every gate
    detected: torch.Tensor       # bool — flux + burst trigger (pre-gates)
    velocity: torch.Tensor       # float32
    flux: torch.Tensor           # float32 (post silence gate)
    energy: torch.Tensor         # float32
    burst_count: torch.Tensor    # int32
    energy_rising: torch.Tensor  # bool
    frames_since: torch.Tensor   # int32 — refractory counter BEFORE the frame


def init_state(half: int = HALF, device="cuda", batch: tuple = ()
               ) -> OnsetState:
    z = torch.zeros(batch + (half,), dtype=torch.float32, device=device)
    zs = torch.zeros(batch, dtype=torch.float32, device=device)
    return OnsetState(
        prev_mag=z, floor=z.clone(),
        floor_init=torch.zeros(batch, dtype=torch.bool, device=device),
        threshold=zs, energy_ema=zs.clone(),
        frames_since_onset=torch.full(batch, 4, dtype=torch.int32,
                                      device=device))


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (at most 256 wide) in the kernel's order: pad
    with +0.0 to 256, view as [8, 32], add halves (x[:k] + x[k:2k], k = 16,
    8, 4, 2, 1) inside each group of 32, then across the 8 groups (k = 4,
    2, 1)."""
    h = x.shape[-1]
    if h > TREE_WIDTH:
        raise ValueError(f"tree_sum: at most {TREE_WIDTH} values, got {h}")
    x = torch.nn.functional.pad(x, (0, TREE_WIDTH - h))
    x = x.reshape(x.shape[:-1] + (TREE_WIDTH // _GROUP, _GROUP))
    k = _GROUP // 2
    while k:
        x = x[..., :k] + x[..., k:2 * k]
        k //= 2
    x = x[..., 0]
    k = TREE_WIDTH // _GROUP // 2
    while k:
        x = x[..., :k] + x[..., k:2 * k]
        k //= 2
    return x[..., 0]


@lru_cache(maxsize=16)
def _bin_constants(half: int, device: torch.device):
    """The flux weight 1 - i/half (as XLA:CPU computes it, fma(-i, 1/half,
    1)) and the mask of the two unsmoothed edge bins."""
    i = torch.arange(half, dtype=torch.float32, device=device)
    return fma32(-i, _f32(1.0 / half), 1.0), (i == 0) | (i == half - 1)


def _step(state: OnsetState, mags, global_floor, tick_suppressed,
          calibration_hold):
    """One frame for S streams: mags [S, H], the rest [S] → (state,
    OnsetFrameOut of [S])."""
    weight, edge = _bin_constants(mags.shape[-1], mags.device)

    # 3-bin smoothed magnitudes; edges unsmoothed (ref onset.rs:264-269).
    left = torch.cat([mags[..., :1], mags[..., :-1]], -1)
    right = torch.cat([mags[..., 1:], mags[..., -1:]], -1)
    sm = torch.where(edge, mags, (left + mags + right) * _f32(1.0 / 3.0))
    diff = sm - state.prev_mag
    flux = tree_sum(torch.where(diff > 0.0, diff * weight, 0.0))
    energy = tree_sum(mags)

    # Per-bin burst + floor update (ref onset.rs:293-332).
    g = global_floor[..., None]
    floor_eps = global_floor.clamp_min(_f32(0.01))[..., None]
    floor0 = torch.where(state.floor_init[..., None], state.floor,
                         torch.maximum(mags, g))
    r = mags / torch.maximum(floor0, floor_eps)
    burst = r > BIN_BURST_RATIO
    rate = torch.where(mags > floor0, _f32(FLOOR_RISE), _f32(FLOOR_DECAY))
    floor1 = torch.where(burst, mags * _f32(FLOOR_OVERCOMPENSATE),
                         fma32(rate.float(), mags - floor0, floor0))
    burst_count = burst.sum(-1, dtype=torch.int32)
    max_excess = r.amax(-1)

    # Silence gate (ref onset.rs:337-339).
    flux = torch.where(burst_count < 2, 0.0, flux)

    # Energy EMA, asymmetric (ref onset.rs:341-350).
    ema_mem = torch.where(energy > state.energy_ema, _f32(ENERGY_EMA_RISE),
                          _f32(ENERGY_EMA_DECAY)).float()
    energy_ema = fma32(state.energy_ema, ema_mem, energy * (1.0 - ema_mem))

    # FluxTracker (ref onset.rs:67-83).
    is_onset = flux > state.threshold
    mem = torch.where(is_onset, _f32(FLUX_RISE_MEMORY),
                      _f32(FLUX_DECAY_MEMORY)).float()
    threshold = fma32(state.threshold, mem, flux * (1.0 - mem)).clamp_min(
        _f32(FLUX_THRESHOLD_FLOOR))
    flux_onset = is_onset & (flux > threshold * _f32(FLUX_MULTIPLIER))

    bin_burst_onset = (max_excess > 3.0) & (burst_count >= 3)
    detected = flux_onset & bin_burst_onset

    energy_rising = energy > energy_ema * _f32(ENERGY_RISING_RATIO)
    velocity = (torch.maximum(flux, max_excess * 5.0)
                * _f32(1.0 / 50.0)).clamp(0.0, 1.0)
    since = state.frames_since_onset
    fired = (detected & ~tick_suppressed & energy_rising
             & (since >= REFRACTORY_FRAMES))

    # A `calibration_hold` frame never resets the counter on `fired` (the
    # host may reject the event; ref onset.rs:535-539).
    frames_since = torch.where(
        (fired & ~calibration_hold) | (detected & (since < REFRACTORY_FRAMES)),
        0, since + 1).to(torch.int32)

    new_state = OnsetState(mags, floor1, torch.ones_like(state.floor_init),
                           threshold, energy_ema, frames_since)
    return new_state, OnsetFrameOut(fired, detected, velocity, flux, energy,
                                    burst_count, energy_rising, since)


def onset_scan_plain(state: OnsetState, mags, global_floor, tick_suppressed,
                     calibration_hold):
    """The plain scan: a loop over `_step`.  mags [S, N, H], the per-frame
    inputs [S, N] → (state, OnsetFrameOut of [S, N])."""
    outs = []
    for t in range(mags.shape[1]):
        state, out = _step(state, mags[:, t], global_floor[:, t],
                           tick_suppressed[:, t], calibration_hold[:, t])
        outs.append(out)
    if not outs:
        s, dev = mags.shape[0], mags.device
        zf = torch.zeros((s, 0), dtype=torch.float32, device=dev)
        zb = torch.zeros((s, 0), dtype=torch.bool, device=dev)
        zi = torch.zeros((s, 0), dtype=torch.int32, device=dev)
        return state, OnsetFrameOut(zb, zb.clone(), zf, zf.clone(),
                                    zf.clone(), zi, zb.clone(), zi.clone())
    return state, OnsetFrameOut(*(torch.stack(x, 1) for x in zip(*outs)))


def onset_scan(state: OnsetState, mags: torch.Tensor,
               global_floor: torch.Tensor, tick_suppressed: torch.Tensor,
               calibration_hold: torch.Tensor | None = None):
    """mags [S, N, H] float32, global_floor [S, N] float32, tick_suppressed
    and calibration_hold [S, N] bool (hold defaults to all False) → (state,
    OnsetFrameOut of [S, N]).  Kernel K4 on CUDA tensors, `onset_scan_plain`
    on CPU tensors."""
    if calibration_hold is None:
        calibration_hold = torch.zeros(mags.shape[:2], dtype=torch.bool,
                                       device=mags.device)
    return hopper_onset.onset_scan(state, mags, global_floor,
                                   tick_suppressed, calibration_hold)


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def onset_np(mags: np.ndarray, global_floor: np.ndarray,
             tick_suppressed: np.ndarray,
             calibration_hold: np.ndarray | None = None):
    """Transcription of onset.rs:244-543's per-frame math. Returns dict of arrays."""
    n, half = mags.shape
    if calibration_hold is None:
        calibration_hold = np.zeros(n, dtype=bool)
    prev = np.zeros(half, dtype=np.float32)
    floor = np.zeros(half, dtype=np.float32)
    floor_init = False
    threshold = np.float32(0.0)
    energy_ema = np.float32(0.0)
    frames_since = 4
    fired_all, det_all, vel_all, flux_all = [], [], [], []
    for fidx in range(n):
        m = mags[fidx].astype(np.float32)
        g = np.float32(global_floor[fidx])
        flux = np.float32(0.0)
        energy = np.float32(0.0)
        sm = np.empty(half, dtype=np.float32)
        for k in range(half):
            if k == 0 or k >= half - 1:
                sm[k] = m[k]
            else:
                sm[k] = (m[k - 1] + m[k] + m[k + 1]) / np.float32(3.0)
        for k in range(half):
            energy += m[k]
            w = np.float32(1.0 - k / half)
            d = sm[k] - prev[k]
            if d > 0.0:
                flux += d * w
            prev[k] = m[k]
        floor_eps = max(g, np.float32(0.01))
        if not floor_init:
            floor = np.maximum(m, g)
            floor_init = True
        max_excess = np.float32(0.0)
        burst_count = 0
        for k in range(half):
            fk = max(floor[k], floor_eps)
            r = m[k] / fk
            if r > BIN_BURST_RATIO:
                burst_count += 1
                floor[k] = m[k] * np.float32(FLOOR_OVERCOMPENSATE)
            elif m[k] > floor[k]:
                floor[k] += np.float32(FLOOR_RISE) * (m[k] - floor[k])
            else:
                floor[k] += np.float32(FLOOR_DECAY) * (m[k] - floor[k])
            max_excess = max(max_excess, r)
        if burst_count < 2:
            flux = np.float32(0.0)
        ema_mem = np.float32(ENERGY_EMA_RISE if energy > energy_ema else ENERGY_EMA_DECAY)
        energy_ema = energy_ema * ema_mem + energy * (np.float32(1.0) - ema_mem)
        is_onset = flux > threshold
        mem = np.float32(FLUX_RISE_MEMORY if is_onset else FLUX_DECAY_MEMORY)
        threshold = threshold * mem + flux * (np.float32(1.0) - mem)
        threshold = max(threshold, np.float32(FLUX_THRESHOLD_FLOOR))
        flux_onset = is_onset and flux > threshold * np.float32(FLUX_MULTIPLIER)
        bin_burst_onset = max_excess > 3.0 and burst_count >= 3
        detected = flux_onset and bin_burst_onset
        energy_rising = energy > energy_ema * np.float32(ENERGY_RISING_RATIO)
        velocity = float(np.clip(max(flux, max_excess * np.float32(5.0))
                                 / np.float32(50.0), 0.0, 1.0))
        fired = (detected and not tick_suppressed[fidx] and energy_rising
                 and frames_since >= REFRACTORY_FRAMES)
        if ((fired and not calibration_hold[fidx])
                or (detected and frames_since < REFRACTORY_FRAMES)):
            frames_since = 0
        else:
            frames_since += 1
        fired_all.append(fired)
        det_all.append(detected)
        vel_all.append(velocity)
        flux_all.append(float(flux))
    return {"fired": np.array(fired_all), "detected": np.array(det_all),
            "velocity": np.array(vel_all), "flux": np.array(flux_all)}
