"""Automatic gain control and musical dynamics classification (port of
audio_analyzer_rs_tpu/ops/dynamics.py; ref src/audio_io/dynamics.rs:1-374).

Per slot: RMS -> p10 of a 256-slot quiet-frame history (noise floor),
kurtosis broadband detector, 5000-slot play history -> p50 session median
+ p95 AGC target, smoothed gain with peak-headroom clamp 0.97, ppp...fff
classification.

The device scan `dynamics_scan` takes slots [..., S, L] with state leaves
[..., ...]: kernel K7 (ops/hopper_dynamics.py, csrc/dynamics.cu) on CUDA
tensors, its plain version `dynamics_scan_plain` (a loop over `_step`) on
CPU tensors.  Two modes, as in the JAX package: ``exact`` takes the
percentiles in sorted order, ``hist`` from incremental 1024-bucket dB
histograms (0.18 dB quantization).

Rounding: the sums of squares and fourth powers run in one fixed order,
`tree_sum` (XLA's own order is not specified; the CPU tests hold them to
the JAX step within a stated tolerance).  The rest follows XLA:CPU's forms,
found from the JAX step's bits: 20*log10(x) is log(x) * DB_PER_LOG (the
float32 constant XLA folds), divisions by constants are products with
float32 reciprocals, the bucket's log(x)*DB_PER_LOG + 180 and the AGC
target's -18 - log(p95)*DB_PER_LOG are fused multiply-adds (`fma32` here,
`fmaf` in the kernel), and nothing else is fused.

`DynamicsTrackerNp` is the per-slot DynamicsTracker the live engine runs
on the host; the host piece below the device half is the JAX module's,
line for line (tests/test_torch_host_copies.py holds it so).

Dynamic levels: Silence=-1, Ppp=0 … Fff=7 (ref dynamics.rs:49-77,672-686).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hopper_dynamics
from .rounding import fma32

LONG_LEN = 256        # ref dynamics.rs:164
PLAY_LEN = 5000       # ref dynamics.rs:168
TARGET_DB = -18.0     # ref mod.rs:344
MAX_BOOST_DB = 100.0  # ref mod.rs:345
SMOOTH_SECS = 240.0   # ref mod.rs:346
SILENCE_DECAY_SECS = 10.0
ACTIVE_SNR_DB = 20.0
BOOTSTRAP_FLOOR_DB = -55.0
PEAK_HEADROOM = 0.97

LEVEL_NAMES = ("silence", "ppp", "pp", "p", "mp", "mf", "f", "ff", "fff")


_F32 = np.float32
_HIST_BINS = 1024
_HIST_LO_DB = -180.0
_HIST_HI_DB = 6.0
# The float32 constants of the JAX step as XLA:CPU folds them (read from
# its bits, tests/test_torch_dynamics.py): 20*log10(x) is log(x) times
# `DB_PER_LOG`; (db + 180) / 186 * 1024 is (db + 180) times
# `BUCKETS_PER_DB`; db / 20 is db times float32(0.05).
DB_PER_LOG = float.fromhex("0x1.15f2dp+3")
BUCKETS_PER_DB = float(_F32(_F32(1.0) / _F32(_HIST_HI_DB - _HIST_LO_DB))
                       * _F32(_HIST_BINS))
DB_PER_BUCKET = (_HIST_HI_DB - _HIST_LO_DB) / _HIST_BINS   # exact
_EPS = float(_F32(1e-9))
_TWENTIETH = float(_F32(0.05))
TREE_WIDTH = 1024    # the sums run over a slot padded to this many
_GROUP = 32


class DynamicsState(NamedTuple):
    long_hist: torch.Tensor    # [..., LONG_LEN] rms_linear (+inf unwritten)
    long_pos: torch.Tensor     # [...] int32
    long_filled: torch.Tensor  # [...] bool
    play_hist: torch.Tensor    # [..., PLAY_LEN]
    play_pos: torch.Tensor
    play_filled: torch.Tensor
    gain_linear: torch.Tensor  # [...] float32
    # Histogram-mode accumulators (counts mirror the ring contents).
    long_counts: torch.Tensor  # [..., _HIST_BINS] int32
    play_counts: torch.Tensor  # [..., _HIST_BINS] int32


class DynamicsOut(NamedTuple):
    level: torch.Tensor              # int32: -1 silence … 7 fff
    rms_db: torch.Tensor
    gain_db: torch.Tensor            # applied gain (post headroom clamp)
    session_median_db: torch.Tensor
    noise_floor_db: torch.Tensor
    effective_gain: torch.Tensor     # linear gain applied to the slot


def init_state(device="cuda", batch: tuple = ()) -> DynamicsState:
    def full(shape, value, dtype):
        return torch.full(batch + shape, value, dtype=dtype, device=device)
    return DynamicsState(
        long_hist=full((LONG_LEN,), float("inf"), torch.float32),
        long_pos=full((), 0, torch.int32),
        long_filled=full((), False, torch.bool),
        play_hist=full((PLAY_LEN,), float("inf"), torch.float32),
        play_pos=full((), 0, torch.int32),
        play_filled=full((), False, torch.bool),
        gain_linear=full((), 1.0, torch.float32),
        long_counts=full((_HIST_BINS,), 0, torch.int32),
        play_counts=full((_HIST_BINS,), 0, torch.int32),
    )


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (at most 1,024 wide) in kernel K7's order: pad
    with +0.0 to 1,024, view as [32, 32], add halves (x[:k] + x[k:2k], k =
    16 ... 1) inside each group of 32 (a warp's shuffles), then across the
    32 groups the same way."""
    n = x.shape[-1]
    if n > TREE_WIDTH:
        raise ValueError(f"tree_sum: at most {TREE_WIDTH} values, got {n}")
    x = torch.nn.functional.pad(x, (0, TREE_WIDTH - n))
    x = x.reshape(x.shape[:-1] + (TREE_WIDTH // _GROUP, _GROUP))
    for _ in range(2):
        k = _GROUP // 2
        while k:
            x = x[..., :k] + x[..., k:2 * k]
            k //= 2
        x = x[..., 0]
    return x


def _max_eps(x: torch.Tensor) -> torch.Tensor:
    """jnp.maximum(x, 1e-9): NaN stays NaN."""
    return torch.maximum(x, x.new_full((), _EPS))


def _lin_to_db(x: torch.Tensor) -> torch.Tensor:
    return torch.log(_max_eps(x)) * DB_PER_LOG


def _db_to_lin(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, db * _TWENTIETH)


def _bucket_of(rms_linear: torch.Tensor) -> torch.Tensor:
    """The histogram bucket of an rms: the float -> int conversion
    saturates and takes NaN to 0, as XLA's and the card's do."""
    b = fma32(torch.log(_max_eps(rms_linear)), DB_PER_LOG,
              -_HIST_LO_DB) * BUCKETS_PER_DB
    return torch.nan_to_num(b, nan=0.0).clamp(0, _HIST_BINS - 1).to(
        torch.int64)


def _bucket_value(bucket: torch.Tensor) -> torch.Tensor:
    """Linear rms at the bucket's center."""
    return _db_to_lin((bucket.to(torch.float32) + 0.5) * DB_PER_BUCKET
                      + _HIST_LO_DB)


def _hist_kth(counts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Value of the k-th (0-based) smallest entry via cumulative counts:
    the first bucket whose count so far exceeds k (0 if none does)."""
    hit = torch.cumsum(counts, -1) > k[..., None]
    return _bucket_value(hit.to(torch.int32).argmax(-1))


def _sorted_kth(hist: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """hist's k-th smallest entry (+inf padding and NaN sort last)."""
    return torch.gather(torch.sort(hist, -1).values, -1,
                        k.to(torch.int64)[..., None])[..., 0]


def _ring_push(hist, pos, filled, counts, push, value, length: int,
               mode: str):
    """Write `value` at `pos` where `push`; the histogram follows in "hist"
    mode.  → (hist, pos, filled, counts)."""
    idx = pos.to(torch.int64)[..., None]
    old = torch.gather(hist, -1, idx)[..., 0]
    hist = hist.scatter(-1, idx, torch.where(push, value, old)[..., None])
    if mode == "hist":
        dec = (push & torch.isfinite(old)).to(torch.int32)
        counts = counts.scatter_add(-1, _bucket_of(old)[..., None],
                                    -dec[..., None])
        counts = counts.scatter_add(-1, _bucket_of(value)[..., None],
                                    push.to(torch.int32)[..., None])
    pos = torch.where(push, (pos + 1) % length, pos)
    return hist, pos, filled | (push & (pos == 0)), counts


def smoothing_alphas(sample_rate: float, slot_len: int) -> tuple:
    """The gain's smoothing coefficients a slot, while playing and while
    silent, as float32 values."""
    slot_rate = sample_rate / slot_len
    return tuple(float(_F32(1.0 - np.exp(-1.0 / (secs * slot_rate))))
                 for secs in (SMOOTH_SECS, SILENCE_DECAY_SECS))


def _step(state: DynamicsState, slot: torch.Tensor, sample_rate: float,
          slot_len: int, mode: str):
    """One slot of every stream: slot [B, L] → (state, DynamicsOut [B],
    gained [B, L]).  Kernel K7's plain version, in its rounding."""
    smooth_alpha, silence_alpha = smoothing_alphas(sample_rate, slot_len)
    inv_len = float(_F32(1.0 / slot.shape[-1]))

    # 1. Pre-gain RMS (ref dynamics.rs:195-200).
    sq = slot * slot
    rms_linear = torch.sqrt(tree_sum(sq) * inv_len)
    rms_db = _lin_to_db(rms_linear)

    # 2. Noise floor = p10 of the long history (ref dynamics.rs:202-220).
    long_n = torch.where(state.long_filled, LONG_LEN,
                         state.long_pos.clamp(min=1))
    p10_idx = ((long_n - 1).to(torch.float32) * 0.1).to(torch.int32)
    if mode == "exact":
        p10 = _sorted_kth(state.long_hist, p10_idx)
    else:
        p10 = _hist_kth(state.long_counts, p10_idx)
    empty = (state.long_pos == 0) & ~state.long_filled
    p10 = torch.where(empty, torch.zeros_like(p10), p10)
    noise_floor_db = _lin_to_db(p10)

    # 3. Active gate and the kurtosis broadband detector (ref
    # dynamics.rs:222-256).
    long_count = torch.where(state.long_filled, LONG_LEN, state.long_pos)
    floor_db = torch.where(long_count >= 32, noise_floor_db,
                           BOOTSTRAP_FLOOR_DB)
    is_active = rms_db > floor_db + ACTIVE_SNR_DB
    mean_sq = rms_linear * rms_linear
    mean_quad = tree_sum(sq * sq) * inv_len
    kurtosis = torch.where(mean_sq > 1e-18, mean_quad / (mean_sq * mean_sq),
                           torch.full_like(mean_sq, 3.0))
    is_broadband = (is_active & (kurtosis >= 2.75) & (kurtosis <= 3.8)
                    & (rms_db < -45.0))
    is_playing = is_active & ~is_broadband

    # 4. The histories (dynamics.rs:263-281).
    long_hist, long_pos, long_filled, long_counts = _ring_push(
        state.long_hist, state.long_pos, state.long_filled,
        state.long_counts, ~is_active | is_broadband, rms_linear, LONG_LEN,
        mode)
    play_hist, play_pos, play_filled, play_counts = _ring_push(
        state.play_hist, state.play_pos, state.play_filled,
        state.play_counts, is_playing, rms_linear, PLAY_LEN, mode)

    # 5. Session stats: p50 + p95 (dynamics.rs:283-307).
    play_n = torch.where(play_filled, PLAY_LEN, play_pos)
    p50_idx = torch.div(play_n - 1, 2, rounding_mode="floor").clamp(min=0)
    p95_idx = ((play_n - 1).to(torch.float32) * 0.95).to(
        torch.int32).clamp(min=0)
    if mode == "exact":
        p50 = _sorted_kth(play_hist, p50_idx)
        p95 = _sorted_kth(play_hist, p95_idx)
    else:
        p50 = _hist_kth(play_counts, p50_idx)
        p95 = _hist_kth(play_counts, p95_idx)
    has_play = play_n > 0
    median_db = torch.where(has_play, _lin_to_db(p50), rms_db)
    zero = torch.zeros_like(rms_db)
    raw_gain_db = torch.where(has_play, torch.minimum(torch.maximum(
        fma32(-torch.log(_max_eps(p95)), DB_PER_LOG, TARGET_DB), zero),
        zero + MAX_BOOST_DB), zero)

    # 6. Smooth gain (dynamics.rs:309-316).
    gain = state.gain_linear
    gain = torch.where(is_playing,
                       gain + smooth_alpha * (_db_to_lin(raw_gain_db) - gain),
                       gain + silence_alpha * (1.0 - gain))

    # 7. Peak-headroom clamp (dynamics.rs:318-332).
    peak = _max_eps(slot.abs().amax(-1))
    effective_gain = torch.minimum(
        gain, torch.full_like(peak, PEAK_HEADROOM) / peak)

    # 8. Classification (dynamics.rs:334-349).
    rel = rms_db - median_db
    level = torch.full_like(long_pos, 7)
    for bound, lv in ((9.0, 6), (4.5, 5), (1.5, 4), (-1.5, 3), (-4.5, 2),
                      (-9.0, 1), (-15.0, 0)):
        level = torch.where(rel < bound, lv, level)
    level = torch.where(is_playing, level, -1).to(torch.int32)

    new_state = DynamicsState(long_hist, long_pos, long_filled, play_hist,
                              play_pos, play_filled, gain, long_counts,
                              play_counts)
    out = DynamicsOut(level, rms_db, _lin_to_db(effective_gain), median_db,
                      noise_floor_db, effective_gain)
    return new_state, out, slot * effective_gain[..., None]


def dynamics_scan_plain(state: DynamicsState, slots: torch.Tensor,
                        sample_rate: float, slot_len: int = 1024,
                        mode: str = "hist"):
    """Kernel K7's plain version, a loop over `_step`: state leaves [B, ...],
    slots [B, S, L] → (state, DynamicsOut of [B, S], gained [B, S, L])."""
    outs, gained = [], []
    for s in range(slots.shape[1]):
        state, out, g = _step(state, slots[:, s], sample_rate, slot_len,
                              mode)
        outs.append(out)
        gained.append(g)
    if not outs:
        b, dev = slots.shape[0], slots.device
        zf = torch.zeros((b, 0), dtype=torch.float32, device=dev)
        return state, DynamicsOut(zf.to(torch.int32), *(zf.clone()
                                                       for _ in range(5))), \
            slots.clone()
    return (state, DynamicsOut(*(torch.stack(x, 1) for x in zip(*outs))),
            torch.stack(gained, 1))


def _flat(state: DynamicsState, lead: tuple) -> DynamicsState:
    return DynamicsState(*(t.reshape((-1,) + t.shape[len(lead):])
                           for t in state))


def dynamics_scan(state: DynamicsState, slots: torch.Tensor,
                  sample_rate: float, slot_len: int = 1024,
                  mode: str = "hist"):
    """slots [..., S, L] float32 (L = slot_len <= 1,024) with state leaves
    [..., ...] → (state, DynamicsOut of [..., S], gained [..., S, L]).
    Kernel K7 on CUDA tensors, `dynamics_scan_plain` on CPU tensors.

    * ``exact`` — the percentiles are sorted-order picks of the rings;
    * ``hist``  — the 1,024-bucket dB histograms' percentiles (0.18 dB
      quantization)."""
    if mode not in ("hist", "exact"):
        raise ValueError(f"mode={mode!r}: expected 'hist' or 'exact'")
    if slots.shape[-1] != slot_len:
        raise ValueError(f"slots must be [..., S, {slot_len}], got "
                         f"{tuple(slots.shape)}")
    lead = tuple(slots.shape[:-2])
    st, out, gained = hopper_dynamics.dynamics_scan(
        _flat(state, lead), slots.reshape((-1,) + slots.shape[-2:]),
        sample_rate, slot_len, mode)
    return (DynamicsState(*(t.reshape(lead + t.shape[1:]) for t in st)),
            DynamicsOut(*(t.reshape(lead + t.shape[1:]) for t in out)),
            gained.reshape(slots.shape))


# ── NumPy oracle: transcription of DynamicsTracker::process_slot ─────────

class DynamicsTrackerNp:
    """ref dynamics.rs:140-360 (float32, sort-based)."""

    def __init__(self, sample_rate, slot_len, target_db=TARGET_DB,
                 max_boost_db=MAX_BOOST_DB, smooth_secs=SMOOTH_SECS):
        slot_rate = sample_rate / slot_len
        self.long = np.zeros(LONG_LEN, np.float32)
        self.long_pos = 0
        self.long_filled = False
        self.play = np.zeros(PLAY_LEN, np.float32)
        self.play_pos = 0
        self.play_filled = False
        self.gain = np.float32(1.0)
        self.target_db = np.float32(target_db)
        self.max_boost = np.float32(max_boost_db)
        self.smooth_alpha = np.float32(1.0 - np.exp(-1.0 / (smooth_secs * slot_rate)))
        self.silence_alpha = np.float32(
            1.0 - np.exp(-1.0 / (SILENCE_DECAY_SECS * slot_rate)))

    def process_slot(self, slot: np.ndarray):
        f32 = np.float32
        slot = slot.astype(np.float32).copy()
        rms_linear = f32(np.sqrt(np.sum(slot * slot, dtype=np.float32) / len(slot)))
        rms_db = f32(20.0 * np.log10(max(rms_linear, 1e-9)))

        long_n = LONG_LEN if self.long_filled else max(self.long_pos, 1)
        buf = np.sort(self.long[:long_n])
        p10_idx = int((long_n - 1) * 0.10)
        noise_floor_db = (f32(20.0 * np.log10(max(buf[p10_idx], 1e-9)))
                          if long_n >= 1 else f32(BOOTSTRAP_FLOOR_DB))
        floor_db = noise_floor_db if long_n >= 32 else f32(BOOTSTRAP_FLOOR_DB)
        is_active = rms_db > floor_db + ACTIVE_SNR_DB

        if is_active:
            mean_sq = rms_linear * rms_linear
            mean_quad = f32(np.sum(slot ** 4, dtype=np.float32) / len(slot))
            kurtosis = (mean_quad / (mean_sq * mean_sq)
                        if mean_sq > 1e-18 else f32(3.0))
            is_broadband = bool(2.75 <= kurtosis <= 3.8 and rms_db < -45.0)
        else:
            is_broadband = False
        is_playing = is_active and not is_broadband

        if not is_active or is_broadband:
            self.long[self.long_pos] = rms_linear
            self.long_pos = (self.long_pos + 1) % LONG_LEN
            if self.long_pos == 0:
                self.long_filled = True
        if is_playing:
            self.play[self.play_pos] = rms_linear
            self.play_pos = (self.play_pos + 1) % PLAY_LEN
            if self.play_pos == 0:
                self.play_filled = True

        play_n = PLAY_LEN if self.play_filled else self.play_pos
        if play_n > 0:
            pbuf = np.sort(self.play[:play_n])
            p50_idx = (play_n - 1) // 2
            p95_idx = int((play_n - 1) * 0.95)
            median_db = f32(20.0 * np.log10(max(pbuf[p50_idx], 1e-9)))
            p95_db = f32(20.0 * np.log10(max(pbuf[p95_idx], 1e-9)))
            raw_gain_db = f32(np.clip(self.target_db - p95_db, 0.0, self.max_boost))
        else:
            raw_gain_db, median_db = f32(0.0), rms_db

        if is_playing:
            target_linear = f32(10.0 ** (raw_gain_db / 20.0))
            self.gain = f32(self.gain + self.smooth_alpha * (target_linear - self.gain))
        else:
            self.gain = f32(self.gain + self.silence_alpha * (1.0 - self.gain))

        peak = max(np.max(np.abs(slot)), 1e-9)
        effective = f32(min(self.gain, PEAK_HEADROOM / peak))
        slot *= effective
        applied_db = f32(20.0 * np.log10(max(effective, 1e-9)))

        if not is_playing:
            level = -1
        else:
            rel = rms_db - median_db
            level = (0 if rel < -15 else 1 if rel < -9 else 2 if rel < -4.5
                     else 3 if rel < -1.5 else 4 if rel < 1.5 else 5 if rel < 4.5
                     else 6 if rel < 9 else 7)
        return {"level": level, "rms_db": float(rms_db),
                "gain_db": float(applied_db),
                "session_median_db": float(median_db),
                "noise_floor_db": float(noise_floor_db),
                "slot": slot}
