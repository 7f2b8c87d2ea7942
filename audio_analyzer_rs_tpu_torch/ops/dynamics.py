"""The host (numpy) half of automatic gain control and musical dynamics
classification (port of the host pieces of audio_analyzer_rs_tpu/ops/
dynamics.py; ref src/audio_io/dynamics.rs:1-374).

`DynamicsTrackerNp` is the per-slot DynamicsTracker the live engine runs on
the host: per-slot RMS → p10 of a 256-slot quiet-frame history (noise
floor), kurtosis broadband detector, 5000-slot play history → p50 session
median + p95 AGC target, smoothed gain with peak-headroom clamp 0.97,
ppp…fff classification.  The code below `LEVEL_NAMES` is the JAX module's,
line for line (tests/test_torch_host_copies.py holds it so).  The device
scan `dynamics_scan` is not ported yet.

Dynamic levels: Silence=-1, Ppp=0 … Fff=7 (ref dynamics.rs:49-77,672-686).
"""

from __future__ import annotations

import numpy as np

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
