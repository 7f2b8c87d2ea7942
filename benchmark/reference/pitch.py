"""The plain pitch chain in float64 NumPy: windowed magnitudes, the
adaptive noise floor, the harmonic-comb extraction and the tracker.

A frozen copy of the arithmetic of the port's float64 oracles (the loop
transcriptions of the upstream Rust analyser, `src/audio_io/stft.rs`),
computed in float64 throughout, vectorised over bins where a frame's
bins do not depend on each other, and carrying every recurrence's state
in and out so that a stream can be followed from any state.  It imports
nothing of the program.

`lower(x, precision)` rounds an array to a narrower float format, for
the checks' control runs: "float64" leaves it, "float32", "tf32" (10
mantissa bits) and "bfloat16" (7) round to nearest even.
"""

from __future__ import annotations

import numpy as np

MAX_HARMONICS = 14
MAX_NOTES = 8
MIN_FREQ, MAX_FREQ = 24.0, 10_000.0
# The noise floor (stft.rs).
FLOOR_BASE_ALPHA, FLOOR_FAST_ALPHA, FLOOR_RELEASE = 0.04, 0.35, 0.02
VOL_MEMORY, NOTE_RATIO, NOTE_VOL_MAX = 0.75, 1.5, 0.15
# The tracker (stft.rs:20-117).
DISPLAY_THRESHOLD, MAX_LIFE, TOLERANCE = 2, 3, 0.03
EMA_OLD, EMA_NEW = 0.6, 0.4

_DROP = {"float32": 0, "tf32": 13, "bfloat16": 16}


def lower(x: np.ndarray, precision: str) -> np.ndarray:
    if precision == "float64":
        return x
    bits = np.asarray(x, np.float64).astype(np.float32).view(np.uint32)
    drop = _DROP[precision]
    if drop:
        half = np.uint32((1 << (drop - 1)) - 1)
        odd = (bits >> np.uint32(drop)) & np.uint32(1)
        keep = np.uint32((0xFFFFFFFF >> drop) << drop)
        bits = (bits + half + odd) & keep
    return bits.view(np.float32).astype(np.float64)


def hann(n: int) -> np.ndarray:
    """The periodic Hann window as the reference writes it (stft.rs:641),
    in float32."""
    x = np.arange(n, dtype=np.float32) / np.float32(n)
    return (np.float32(0.5) - np.float32(0.5)
            * np.cos(np.float32(2.0) * np.float32(np.pi) * x)
            ).astype(np.float32)


def num_frames(samples: int, window: int, hop: int) -> int:
    return 0 if samples < window else (samples - window) // hop + 1


def frames_of(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    n = num_frames(len(x), window, hop)
    return np.lib.stride_tricks.sliding_window_view(x, window)[::hop][:n]


def magnitudes(x: np.ndarray, window: int, hop: int, bins: int,
               precision: str = "float64") -> np.ndarray:
    """|rfft(frame x hann)| of every frame, bins [0, bins), float64; in
    "tf32" the product's inputs are rounded to tf32 and it is summed in
    float64, as a tensor core would take them."""
    f = frames_of(np.asarray(x, np.float64), window, hop)
    w = hann(window).astype(np.float64)
    out = np.empty((len(f), bins))
    if precision == "tf32":
        k = np.arange(bins)[None, :]
        t = np.arange(window)[:, None]
        ang = 2.0 * np.pi * ((t * k) % window) / window
        cos, sin = lower(np.cos(ang), "tf32"), lower(-np.sin(ang), "tf32")
        for a in range(0, len(f), 2048):
            fw = lower(f[a:a + 2048] * w, "tf32")
            out[a:a + 2048] = np.hypot(fw @ cos, fw @ sin)
        return out
    for a in range(0, len(f), 4096):
        out[a:a + 4096] = np.abs(np.fft.rfft(f[a:a + 4096] * w, axis=1)
                                 )[:, :bins]
    return lower(out, precision)


def floor_state(bins: int) -> dict:
    z = np.zeros(bins)
    return {"floor": z, "prev": z.copy(), "vol": z.copy(), "init": False}


def noise_floor(mags: np.ndarray, gf: np.ndarray, st: dict):
    """The adaptive per-bin floor over frames → (effective floors [N, H],
    state).  mags [N, H]; gf [N], the linear global floor a frame."""
    floor, prev, vol = st["floor"].copy(), st["prev"].copy(), st["vol"].copy()
    init = bool(st["init"])
    out = np.empty_like(mags)
    for i in range(len(mags)):
        m, g = mags[i], gf[i]
        if not init:
            floor = np.maximum(m, g * 5.0)
            prev = m.copy()
            init = True
        else:
            vol = vol * VOL_MEMORY + np.abs(m - prev) * (1.0 - VOL_MEMORY)
            prev = m.copy()
            above = m / np.maximum(floor, 0.01)
            vn = np.clip(vol / np.maximum(m, 0.05), 0.0, 1.0)
            sustained = (above > NOTE_RATIO) & (vn < NOTE_VOL_MAX)
            alpha = np.where(m > floor, FLOOR_BASE_ALPHA + (
                FLOOR_FAST_ALPHA - FLOOR_BASE_ALPHA) * vn, FLOOR_RELEASE)
            floor = np.where(sustained, floor, floor + alpha * (m - floor))
        out[i] = np.minimum(floor, g * 2.5)
    return out, {"floor": floor, "prev": prev, "vol": vol, "init": init}


def extract(m: np.ndarray, nf: np.ndarray, bin_width: float, half: int):
    """One frame's pitches (stft.rs:443-620) → [(freq, score), ...] by
    score.  m holds bins [0, max_bin + 1] at least, nf [0, max_bin)."""
    min_bin = max(int(np.ceil(MIN_FREQ / bin_width)), 1)
    max_bin = min(int(np.floor(MAX_FREQ / bin_width)), half - 2)
    if min_bin >= max_bin:
        return []
    k = np.arange(min_bin + 1, max_bin)
    mk = m[k]
    peak = (mk > nf[k]) & (mk >= m[k - 1]) & (mk >= m[k + 1])
    peaks = k[peak].tolist()
    if not peaks:
        return []
    is_peak = np.zeros(half + 2, bool)
    is_peak[peaks] = True
    ml = m.tolist()
    scores, frac = {}, {}
    for b in peaks:
        fund = ml[b]
        if fund < nf[b] * 5.0:
            scores[b] = 0.0
            continue
        if ml[b - 1] <= 0.0 or ml[b] <= 0.0 or ml[b + 1] <= 0.0:
            scores[b] = 0.0
            continue
        yl, yc, yr = np.log(ml[b - 1]), np.log(ml[b]), np.log(ml[b + 1])
        den = yl - 2.0 * yc + yr
        delta = 0.0 if abs(den) < 1e-30 else min(max(
            0.5 * (yl - yr) / den, -1.0), 1.0)
        fb = b + delta
        frac[b] = fb
        score, last = fund, b
        longest = run = total = 0
        for n in range(2, MAX_HARMONICS + 1):
            ef = fb * n
            if ef >= half:
                break
            lo = max(int(np.floor(ef - 1.0)) if ef >= 1.0 else 0, last + 1)
            hi = min(int(np.ceil(ef + 1.0)), half - 1)
            best_h, best_m = 0, 0.0
            for h in range(lo, hi + 1):
                if is_peak[h] and ml[h] > best_m:
                    best_m, best_h = ml[h], h
            if best_h:
                score += best_m
                last = best_h
                run += 1
                total += 1
            else:
                longest = max(longest, run)
                run = 0
        longest = max(longest, run)
        if longest < 3 and fund < 15.0 * nf[b]:
            scores[b] = 0.0
        else:
            struct = (1.0 + longest + total / 2.0) / (1.0 + MAX_HARMONICS)
            scores[b] = np.log2(0.5 + score) * struct
    top = max(max(scores[b] for b in peaks), 0.0)
    if top == 0.0:
        return []
    cands = [(b, scores[b]) for b in peaks if scores[b] >= top * 0.5]
    freq = {b: frac[b] * bin_width for b, _ in cands}
    kept = []
    for i, (bi, si) in enumerate(cands):
        sup = False
        for j, (bj, sj) in enumerate(cands):
            if i == j:
                continue
            ratio = freq[bi] / freq[bj]
            near = np.round(ratio)
            if (2.0 <= near <= 5.0 and abs(ratio / near - 1.0) < 0.03
                    and si < sj * 1.05):
                sup = True
                break
        if not sup:
            kept.append((bi, si))
    kept.sort(key=lambda c: (-c[1], c[0]))
    deduped = []
    for b, s in kept:
        if not any(abs(frac[b] - frac[d]) < 2.0 for d, _ in deduped):
            deduped.append((b, s))
    return [(freq[b], s) for b, s in deduped[:MAX_NOTES]
            if MIN_FREQ <= freq[b] <= MAX_FREQ]


def track(tracks: list, raw: list, onset: bool = False) -> list:
    """One frame of the tracker (stft.rs:20-117); `tracks` ([freq, score,
    life] in creation order) is updated in place → the displayed
    [(freq, score), ...] in creation order."""
    matched = [False] * len(tracks)
    for rf, rs in raw:
        found = False
        for i, tr in enumerate(tracks):
            if matched[i]:
                continue
            if abs(tr[0] - rf) / tr[0] < TOLERANCE:
                tr[0] = rf if onset else tr[0] * EMA_OLD + rf * EMA_NEW
                tr[1] = rs
                tr[2] = min(tr[2] + 1, MAX_LIFE)
                matched[i] = True
                found = True
                break
        if not found:
            tracks.append([rf, rs, 1])
            matched.append(True)
    active, i = [], 0
    while i < len(tracks):
        if not matched[i]:
            tracks[i][2] = 0 if onset else tracks[i][2] - 1
        if tracks[i][2] <= 0:
            tracks.pop(i)
            matched.pop(i)
        else:
            if tracks[i][2] >= DISPLAY_THRESHOLD:
                active.append((tracks[i][0], tracks[i][1]))
            i += 1
    return active


def pitch_frames(mags: np.ndarray, eff: np.ndarray, bin_width: float,
                 half: int, tracks: list):
    """Extraction and tracker over frames → (freqs [N, 8], scores [N, 8],
    valid [N, 8]): each frame's first 8 displayed tracks."""
    n = len(mags)
    freqs, scores = np.zeros((n, MAX_NOTES)), np.zeros((n, MAX_NOTES))
    valid = np.zeros((n, MAX_NOTES), bool)
    for i in range(n):
        shown = track(tracks, extract(mags[i], eff[i], bin_width, half))
        for j, (f, s) in enumerate(shown[:MAX_NOTES]):
            freqs[i, j], scores[i, j], valid[i, j] = f, s, True
    return freqs, scores, valid
