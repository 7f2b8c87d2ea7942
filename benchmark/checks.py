"""The numbers that decide `correct`: what the timed path produced against
the plain reference, on the sampled streams.

Pitch frames compare as sets of stable notes in whole deci-hertz (the
repo's agreement measure); notes shown on both sides within 3% (the
tracker's tolerance) compare by the median of their relative gaps (a
mean swung 100x from seed to seed with the few pairs that are two
tracks' notes after a flip).  Onset velocities
compare frame by frame, by the median of their relative gaps over the
frames where either side's is above 0 (a velocity on one side alone is
a gap of 1): the reducer's hard gate closes a sample apart in float32
and float64 where a decay crosses -60 dB, which moves a few percent of
frames by 0.3-3%, so a sum or a high percentile swings from seed to
seed.  Fired onsets compare as sets: the frames fired on one side alone
over the frames fired on either.  Carried states compare by the median of their
leaves' gaps (the worst leaf, a few bins of the pitch floor whose
sustained-note test flips, swung 8x from seed to seed).
"""

from __future__ import annotations

import numpy as np


def note_sets(freqs: np.ndarray, valid: np.ndarray) -> list:
    return [sorted(int(round(float(f) * 10.0)) for f in freqs[i][valid[i]])
            for i in range(len(freqs))]


def pitch(pf, pv, rf, rv, ps=None, rs=None) -> dict:
    """→ frames, frames whose note sets differ, the relative frequency
    (and score) gaps of the notes both sides show."""
    sp, sr = note_sets(pf, pv), note_sets(rf, rv)
    differ = sum(a != b for a, b in zip(sp, sr))
    gaps, sgaps = [], []
    for i in range(len(pf)):
        a = pf[i][pv[i]]
        b = rf[i][rv[i]]
        for j, f in enumerate(b):
            if not len(a):
                break
            k = int(np.argmin(np.abs(a - f)))
            if abs(a[k] - f) < 0.03 * f:
                gaps.append(abs(float(a[k]) - f) / f)
                if ps is not None:
                    p_s = ps[i][pv[i]][k]
                    r_s = rs[i][rv[i]][j]
                    sgaps.append(abs(float(p_s) - r_s) / max(abs(r_s), 1e-30))
    return {"frames": len(pf), "differ": differ, "gaps": gaps,
            "score_gaps": sgaps}


def velocity(p: np.ndarray, r: np.ndarray) -> list:
    """Relative gaps of the frames whose velocity is above 0 on either
    side, over the larger of the two."""
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    on = (p > 0) | (r > 0)
    return (np.abs(p[on] - r[on]) / np.maximum(p[on], r[on])).tolist()


def onsets(p: np.ndarray, r: np.ndarray) -> dict:
    """→ frames fired on one side alone, frames fired on either."""
    p, r = np.asarray(p, bool), np.asarray(r, bool)
    return {"differ": int((p ^ r).sum()), "fired": int((p | r).sum())}


def leaf_gap(p: np.ndarray, r: np.ndarray) -> float:
    p = np.asarray(p, np.float64).ravel()
    r = np.asarray(r, np.float64).ravel()
    den = max(np.linalg.norm(p), np.linalg.norm(r), 1e-30)
    return float(np.linalg.norm(p - r) / den)


def summarise(parts: list[dict]) -> dict:
    """Pooled over the sampled streams and steps."""
    out = {}
    frames = sum(p["pitch"]["frames"] for p in parts)
    out["pitch_frames_differ"] = sum(p["pitch"]["differ"]
                                     for p in parts) / max(frames, 1)
    gaps = [g for p in parts for g in p["pitch"]["gaps"]]
    out["pitch_freq_gap"] = float(np.median(gaps)) if gaps else 0.0
    vel = [g for p in parts for g in p.get("velocity", [])]
    if vel:
        out["onset_velocity_gap"] = float(np.median(vel))
    fired = [p["onsets"] for p in parts if "onsets" in p]
    if fired:
        out["onset_flags_differ"] = sum(f["differ"] for f in fired) / max(
            sum(f["fired"] for f in fired), 1)
    sg = [g for p in parts for g in p["pitch"]["score_gaps"]]
    if sg:
        out["pitch_score_gap"] = float(np.median(sg))
    states = [p["state"] for p in parts if "state" in p]
    if states:
        leaves = {k for s in states for k in s}
        out["state_gap"] = float(np.median([
            leaf_gap(np.concatenate([np.ravel(s[k][0]) for s in states]),
                     np.concatenate([np.ravel(s[k][1]) for s in states]))
            for k in leaves]))
    return out
