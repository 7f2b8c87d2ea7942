"""The plain full chain of one stream over one chunk, in float64 NumPy:
the reducer (two biquads and the noise gate), the AGC with its
histogram percentiles, the causal floors, the pitch chain and the onset
detector, every state carried in and out.

The arithmetic of the port's float64 oracles and of the upstream Rust
analyser it transcribes (`src/audio_io/mod.rs:336-511`,
`dynamics.rs:140-360`, `stft.rs`, `onset.rs:244-543`), frozen here and
computed in float64.  The AGC takes its percentiles as the "hist" mode
defines them: the centre of the 0.18 dB bucket (1,024 buckets over -180
to +6 dB) that holds the ring's k-th smallest entry.  It imports nothing
of the program.

`precision` other than "float64" rounds each array passed between two
stages (the conditioned audio, the gained audio, both magnitude arrays)
to that format: the checks' control.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter, lfiltic

from .pitch import floor_state, lower, magnitudes, noise_floor, pitch_frames

PITCH_WINDOW, ONSET_WINDOW = 2048, 256
# The reducer (mod.rs:336-511).
GATE_THRESHOLD_DB, GATE_RELEASE_S, GATE_HOLD_S = -60.0, 0.040, 0.020
HPF_FREQ, LPF_FREQ = 40.0, 14000.0
# The AGC (dynamics.rs).
LONG_LEN, PLAY_LEN = 256, 5000
TARGET_DB, MAX_BOOST_DB = -18.0, 100.0
SMOOTH_S, SILENCE_DECAY_S = 240.0, 10.0
ACTIVE_SNR_DB, BOOTSTRAP_FLOOR_DB, PEAK_HEADROOM = 20.0, -55.0, 0.97
HIST_BINS, HIST_LO_DB, HIST_HI_DB = 1024, -180.0, 6.0
LEVELS = ((-15.0, 0), (-9.0, 1), (-4.5, 2), (-1.5, 3), (1.5, 4), (4.5, 5),
          (9.0, 6))
# The onset detector (onset.rs).
FLUX_MULTIPLIER, FLUX_RISE_MEMORY, FLUX_DECAY_MEMORY = 1.5, 0.84, 0.89
FLUX_THRESHOLD_FLOOR = 0.9
ENERGY_EMA_RISE, ENERGY_EMA_DECAY, ENERGY_RISING_RATIO = 0.84, 0.95, 1.5
BIN_BURST_RATIO, FLOOR_OVERCOMPENSATE = 2.5, 1.3
FLOOR_RISE, FLOOR_DECAY, REFRACTORY_FRAMES = 0.1, 0.04, 3


def biquad(freq: float, sample_rate: float, lowpass: bool):
    """RBJ biquad, Q = 0.707 (mod.rs:351-377), its coefficients rounded to
    float32 as the reference stores them; the cutoff clamped to 0.45 fs
    → (b, a)."""
    f32 = np.float32
    freq = min(float(freq), 0.45 * float(sample_rate))
    w0 = f32(2.0) * f32(np.pi) * f32(freq) / f32(sample_rate)
    c, s = f32(np.cos(w0)), f32(np.sin(w0))
    alpha = f32(s / (2.0 * 0.707))
    if lowpass:
        b0, b1 = f32((1.0 - c) / 2.0), f32(1.0 - c)
    else:
        b0, b1 = f32((1.0 + c) / 2.0), f32(-(1.0 + c))
    a0, a1, a2 = f32(1.0 + alpha), f32(-2.0 * c), f32(1.0 - alpha)
    b = [float(f32(v / a0)) for v in (b0, b1, b0)]
    return b, [1.0, float(f32(a1 / a0)), float(f32(a2 / a0))]


def fresh_state() -> dict:
    return {
        "hp": [0.0] * 4, "lp": [0.0] * 4, "envelope": 0.0, "hold": 0,
        "long": np.zeros(LONG_LEN), "long_pos": 0, "long_filled": False,
        "play": np.zeros(PLAY_LEN), "play_pos": 0, "play_filled": False,
        "gain": 1.0,
        "nf": floor_state(0), "tracks": [],
        "on_prev": np.zeros(ONSET_WINDOW // 2 + 1),
        "on_floor": np.zeros(ONSET_WINDOW // 2 + 1), "on_init": False,
        "threshold": 0.0, "energy_ema": 0.0, "frames_since": 4,
    }


def _filter(b, a, x, st):
    """A biquad over x from (x1, x2, y1, y2) → (y, new state)."""
    zi = lfiltic(b, a, y=[st[2], st[3]], x=[st[0], st[1]])
    y, _ = lfilter(b, a, x, zi=zi)
    return y, [x[-1], x[-2], y[-1], y[-2]]


def reduce(x: np.ndarray, st: dict, sample_rate: float):
    """HPF 40 Hz → LPF 14 kHz → the envelope gate (40 ms release, 20 ms
    hold, gain (env / threshold)^4 below -60 dB)."""
    h, hp = _filter(*biquad(HPF_FREQ, sample_rate, False), x, st["hp"])
    lo, lp = _filter(*biquad(LPF_FREQ, sample_rate, True), h, st["lp"])
    thresh = float(np.float32(10.0 ** (GATE_THRESHOLD_DB / 20.0)))
    release = float(np.float32(np.exp(np.float32(-1.0) / np.float32(
        GATE_RELEASE_S * sample_rate))))
    keep = 1.0 - release
    hold_n = int(GATE_HOLD_S * sample_rate)
    env, hold = float(st["envelope"]), int(st["hold"])
    gains = []
    append = gains.append
    for v in np.abs(lo).tolist():
        if v > env:
            env, hold = v, hold_n
        else:
            env = release * env + keep * v
        if env >= thresh:
            append(1.0)
        elif hold > 0:
            hold -= 1
            append(1.0)
        else:
            r = env / thresh
            append(r * r * r * r)
    return lo * np.asarray(gains), {"hp": hp, "lp": lp, "envelope": env,
                                    "hold": hold}


def _db(x: float) -> float:
    return 20.0 * math.log10(max(x, 1e-9))


def _bucket_centre(x: float) -> float:
    """The "hist" percentile: the centre of x's 0.18 dB bucket."""
    width = (HIST_HI_DB - HIST_LO_DB) / HIST_BINS
    b = min(max(math.floor((_db(x) - HIST_LO_DB) / width), 0), HIST_BINS - 1)
    return 10.0 ** (((b + 0.5) * width + HIST_LO_DB) / 20.0)


def agc(y: np.ndarray, st: dict, sample_rate: float, slot: int):
    """The AGC over whole slots → (gained [S * slot], per slot: level,
    noise floor dB; state)."""
    rate = sample_rate / slot
    smooth = 1.0 - math.exp(-1.0 / (SMOOTH_S * rate))
    silence = 1.0 - math.exp(-1.0 / (SILENCE_DECAY_S * rate))
    long, play = st["long"].copy(), st["play"].copy()
    lp, lf = int(st["long_pos"]), bool(st["long_filled"])
    pp, pf = int(st["play_pos"]), bool(st["play_filled"])
    gain = float(st["gain"])
    n_slots = len(y) // slot
    slots = y[:n_slots * slot].reshape(n_slots, slot)
    ms = np.mean(slots * slots, 1)
    mq = np.mean(slots ** 4, 1)
    peaks = np.abs(slots).max(1)
    level = np.empty(n_slots, np.int64)
    floor_db = np.empty(n_slots)
    eff = np.empty(n_slots)
    for s in range(n_slots):
        rms = math.sqrt(ms[s])
        rms_db = _db(rms)
        count = LONG_LEN if lf else lp
        if count == 0:
            p10 = 0.0
        else:
            k = int((max(count, 1) - 1) * 0.1)
            p10 = _bucket_centre(np.partition(long[:count], k)[k])
        nf_db = _db(p10)
        gate = nf_db if count >= 32 else BOOTSTRAP_FLOOR_DB
        active = rms_db > gate + ACTIVE_SNR_DB
        kurt = mq[s] / (ms[s] * ms[s]) if ms[s] > 1e-18 else 3.0
        broadband = active and 2.75 <= kurt <= 3.8 and rms_db < -45.0
        playing = active and not broadband
        if not active or broadband:
            long[lp] = rms
            lp = (lp + 1) % LONG_LEN
            lf = lf or lp == 0
        if playing:
            play[pp] = rms
            pp = (pp + 1) % PLAY_LEN
            pf = pf or pp == 0
        n = PLAY_LEN if pf else pp
        if n > 0:
            srt = np.sort(play[:n])
            median_db = _db(_bucket_centre(srt[(n - 1) // 2]))
            p95 = _bucket_centre(srt[int((n - 1) * 0.95)])
            raw_db = min(max(TARGET_DB - _db(p95), 0.0), MAX_BOOST_DB)
        else:
            raw_db, median_db = 0.0, rms_db
        if playing:
            gain += smooth * (10.0 ** (raw_db / 20.0) - gain)
        else:
            gain += silence * (1.0 - gain)
        eff[s] = min(gain, PEAK_HEADROOM / max(peaks[s], 1e-9))
        lv = -1
        if playing:
            rel = rms_db - median_db
            lv = 7
            for bound, v in LEVELS:
                if rel < bound:
                    lv = v
                    break
        level[s], floor_db[s] = lv, nf_db
    gained = (slots * eff[:, None]).reshape(-1)
    return gained, level, floor_db, {
        "long": long, "long_pos": lp, "long_filled": lf, "play": play,
        "play_pos": pp, "play_filled": pf, "gain": gain}


def causal_floor(floor_db: np.ndarray, n_frames: int, window: int,
                 hop: int, slot: int, half: int) -> np.ndarray:
    """Each frame's linear global floor: the AGC floor of the slot holding
    its last sample, 10^(dB/20) * half/2 (stft.rs:322-324)."""
    last = np.arange(n_frames) * hop + window - 1
    idx = np.minimum(last // slot, len(floor_db) - 1)
    return 10.0 ** (floor_db[idx] / 20.0) * (half / 2.0)


def onsets(mags: np.ndarray, gf: np.ndarray, st: dict):
    """The onset detector over frames, no tick suppression → (fired [N],
    velocity [N], state)."""
    n, half = mags.shape
    w = 1.0 - np.arange(half) / half
    prev, floor = st["on_prev"].copy(), st["on_floor"].copy()
    init = bool(st["on_init"])
    thr, ema = float(st["threshold"]), float(st["energy_ema"])
    since = int(st["frames_since"])
    fired = np.zeros(n, bool)
    vel = np.zeros(n)
    sm = np.empty(half)
    for i in range(n):
        m, g = mags[i], gf[i]
        sm[:] = m
        sm[1:-1] = (m[:-2] + m[1:-1] + m[2:]) / 3.0
        energy = float(m.sum())
        d = sm - prev
        flux = float((np.where(d > 0.0, d, 0.0) * w).sum())
        prev = m.copy()
        if not init:
            floor = np.maximum(m, g)
            init = True
        r = m / np.maximum(floor, max(g, 0.01))
        burst = r > BIN_BURST_RATIO
        bursts = int(burst.sum())
        floor = np.where(burst, m * FLOOR_OVERCOMPENSATE, floor + np.where(
            m > floor, FLOOR_RISE, FLOOR_DECAY) * (m - floor))
        excess = max(float(r.max()), 0.0)
        if bursts < 2:
            flux = 0.0
        mem = ENERGY_EMA_RISE if energy > ema else ENERGY_EMA_DECAY
        ema = ema * mem + energy * (1.0 - mem)
        is_onset = flux > thr
        mem = FLUX_RISE_MEMORY if is_onset else FLUX_DECAY_MEMORY
        thr = max(thr * mem + flux * (1.0 - mem), FLUX_THRESHOLD_FLOOR)
        detected = (is_onset and flux > thr * FLUX_MULTIPLIER
                    and excess > 3.0 and bursts >= 3)
        vel[i] = min(max(max(flux, excess * 5.0) / 50.0, 0.0), 1.0)
        fired[i] = (detected and energy > ema * ENERGY_RISING_RATIO
                    and since >= REFRACTORY_FRAMES)
        since = 0 if (fired[i] or (detected and since < REFRACTORY_FRAMES)) \
            else since + 1
    return fired, vel, {"on_prev": prev, "on_floor": floor, "on_init": init,
                        "threshold": thr, "energy_ema": ema,
                        "frames_since": since}


def step(audio: np.ndarray, st: dict, sample_rate: float, slot: int = 1024,
         pitch_hop: int = 512, onset_hop: int = 64,
         precision: str = "float64"):
    """One chunk of one stream → (outputs, state).  Outputs: "freqs",
    "valid" [Np, 8] (the first 8 displayed tracks), "fired", "velocity"
    [No], "level" [S]."""
    x = np.asarray(audio, np.float64)
    y, red = reduce(x, st, sample_rate)
    y = lower(y, precision)
    gained, level, floor_db, dyn = agc(y, st, sample_rate, slot)
    gained = lower(gained, precision)
    half = PITCH_WINDOW // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(PITCH_WINDOW))
    kc = min(half - 1, max(min(int(math.floor(10_000.0 / bin_width)),
                               half - 2), 32))
    pm = magnitudes(gained, PITCH_WINDOW, pitch_hop, kc + 1, precision)
    gfp = causal_floor(floor_db, len(pm), PITCH_WINDOW, pitch_hop, slot,
                       half)
    nf = st["nf"] if len(st["nf"]["floor"]) else floor_state(kc)
    eff, nf = noise_floor(pm[:, :kc], gfp, nf)
    tracks = [list(t) for t in st["tracks"]]
    freqs, _, valid = pitch_frames(pm, eff, bin_width, half, tracks)
    ohalf = ONSET_WINDOW // 2 + 1
    om = magnitudes(gained, ONSET_WINDOW, onset_hop, ohalf, precision)
    gfo = causal_floor(floor_db, len(om), ONSET_WINDOW, onset_hop, slot,
                       ohalf)
    fired, vel, on = onsets(om, gfo, st)
    new = {**red, **dyn, **on, "nf": nf, "tracks": tracks}
    return {"freqs": freqs, "valid": valid, "fired": fired,
            "velocity": vel, "level": level}, new


def follow(chunks: list, sample_rate: float, precision: str = "float64",
           **geometry):
    """One stream from a fresh state through its chunks → (each chunk's
    outputs, the state after the last)."""
    st, outs = fresh_state(), []
    for audio in chunks:
        out, st = step(audio, st, sample_rate, precision=precision,
                       **geometry)
        outs.append(out)
    return outs, st
