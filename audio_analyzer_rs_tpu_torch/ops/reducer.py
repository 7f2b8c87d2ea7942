"""The host (numpy) input conditioning: biquad HPF/LPF + envelope-follower
noise gate (port of the host pieces of audio_analyzer_rs_tpu/ops/
reducer.py; ref src/audio_io/mod.rs:336-511).

RBJ biquads (HPF 40 Hz, LPF 14 kHz, Q=0.707), instantaneous-attack envelope
follower with 40 ms release and 20 ms hold, gate gain ratio^4 below the
-60 dB threshold.  `HostReducer` is the live engine's per-slot reducer when
the C++ runtime (runtime/) is not built; `reduce_signal_np` is the one-shot
transcription.  The code below the constants is the JAX module's, line for
line (tests/test_torch_host_copies.py holds it so).  The device scan
`reduce_signal` is not ported yet.
"""

from __future__ import annotations

import numpy as np

GATE_THRESHOLD_DB = -60.0
GATE_RELEASE_S = 0.040
GATE_HOLD_S = 0.020
HPF_FREQ = 40.0
LPF_FREQ = 14000.0


def biquad_coeffs(freq: float, sample_rate: float, is_lpf: bool):
    """RBJ biquad with Q=0.707, normalized (ref mod.rs:351-377), float32.

    Divergence: the reference computes coefficients for any cutoff, so at
    device rates below 2*LPF_FREQ=28 kHz (e.g. 22.05 kHz) its 14 kHz lowpass
    has poles outside the unit circle and the whole pipeline NaNs out.  We
    clamp the cutoff to 0.45*fs — a no-op at every standard rate >= 32 kHz.
    """
    f32 = np.float32
    freq = min(float(freq), 0.45 * float(sample_rate))
    w0 = f32(2.0) * f32(np.pi) * f32(freq) / f32(sample_rate)
    cos_w0, sin_w0 = f32(np.cos(w0)), f32(np.sin(w0))
    alpha = f32(sin_w0 / (2.0 * 0.707))
    if is_lpf:
        b0 = f32((1.0 - cos_w0) / 2.0)
        b1 = f32(1.0 - cos_w0)
        b2 = b0
    else:
        b0 = f32((1.0 + cos_w0) / 2.0)
        b1 = f32(-(1.0 + cos_w0))
        b2 = b0
    a0 = f32(1.0 + alpha)
    a1 = f32(-2.0 * cos_w0)
    a2 = f32(1.0 - alpha)
    return (f32(b0 / a0), f32(b1 / a0), f32(b2 / a0), f32(a1 / a0), f32(a2 / a0))


# ── NumPy oracle: per-sample transcription (float32) ─────────────────────

class HostReducer:
    """Stateful streaming host-side reducer (float32 per-sample loop).

    This is the architectural twin of the reference's reducer thread — light
    sequential conditioning belongs on the host CPU (the reference runs it on
    a dedicated thread, ref mod.rs:336-511); the GPU takes the batched FFT
    work.  Superseded by the C++ runtime reducer when built (runtime/)."""

    def __init__(self, sample_rate: float):
        f32 = np.float32
        self.sample_rate = sample_rate
        self.hp = biquad_coeffs(HPF_FREQ, sample_rate, is_lpf=False)
        self.lp = biquad_coeffs(LPF_FREQ, sample_rate, is_lpf=True)
        self.hp_state = [f32(0.0)] * 4   # x1 x2 y1 y2
        self.lp_state = [f32(0.0)] * 4
        self.threshold = f32(10.0 ** (GATE_THRESHOLD_DB / 20.0))
        self.envelope = f32(0.0)
        self.release = f32(np.exp(f32(-1.0) / f32(GATE_RELEASE_S * sample_rate)))
        self.hold_samples = int(GATE_HOLD_S * sample_rate)
        self.hold = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        f32 = np.float32
        hb0, hb1, hb2, ha1, ha2 = self.hp
        lb0, lb1, lb2, la1, la2 = self.lp
        hx1, hx2, hy1, hy2 = self.hp_state
        lx1, lx2, ly1, ly2 = self.lp_state
        env, hold = self.envelope, self.hold
        out = np.empty(len(x), dtype=np.float32)
        for i, xi in enumerate(np.asarray(x, dtype=np.float32)):
            h = f32(hb0 * xi + hb1 * hx1 + hb2 * hx2 - ha1 * hy1 - ha2 * hy2)
            hx2, hx1, hy2, hy1 = hx1, xi, hy1, h
            l = f32(lb0 * h + lb1 * lx1 + lb2 * lx2 - la1 * ly1 - la2 * ly2)
            lx2, lx1, ly2, ly1 = lx1, h, ly1, l
            a = abs(l)
            if a > env:
                env = a
                hold = self.hold_samples
            else:
                env = f32(self.release * env + (f32(1.0) - self.release) * a)
            if env >= self.threshold:
                gain = f32(1.0)
            elif hold > 0:
                hold -= 1
                gain = f32(1.0)
            else:
                r = f32(env / self.threshold)
                gain = f32(r * r * r * r)
            out[i] = f32(l * gain)
        self.hp_state = [hx1, hx2, hy1, hy2]
        self.lp_state = [lx1, lx2, ly1, ly2]
        self.envelope, self.hold = env, hold
        return out


def reduce_signal_np(x: np.ndarray, sample_rate: float) -> np.ndarray:
    """Direct transcription of the reducer loop (ref mod.rs:408-472)."""
    f32 = np.float32
    hp = biquad_coeffs(HPF_FREQ, sample_rate, is_lpf=False)
    lp = biquad_coeffs(LPF_FREQ, sample_rate, is_lpf=True)
    hp_b0, hp_b1, hp_b2, hp_a1, hp_a2 = hp
    lp_b0, lp_b1, lp_b2, lp_a1, lp_a2 = lp
    hp_x1 = hp_x2 = hp_y1 = hp_y2 = f32(0.0)
    lp_x1 = lp_x2 = lp_y1 = lp_y2 = f32(0.0)
    thresh = f32(10.0 ** (GATE_THRESHOLD_DB / 20.0))
    envelope = f32(0.0)
    release = f32(np.exp(f32(-1.0) / f32(GATE_RELEASE_S * sample_rate)))
    hold_samples = int(GATE_HOLD_S * sample_rate)
    hold = 0
    out = np.empty(len(x), dtype=np.float32)
    for i, xi in enumerate(x.astype(np.float32)):
        h = f32(hp_b0 * xi + hp_b1 * hp_x1 + hp_b2 * hp_x2
                - hp_a1 * hp_y1 - hp_a2 * hp_y2)
        hp_x2, hp_x1, hp_y2, hp_y1 = hp_x1, xi, hp_y1, h
        l = f32(lp_b0 * h + lp_b1 * lp_x1 + lp_b2 * lp_x2
                - lp_a1 * lp_y1 - lp_a2 * lp_y2)
        lp_x2, lp_x1, lp_y2, lp_y1 = lp_x1, h, lp_y1, l
        abs_in = abs(l)
        if abs_in > envelope:
            envelope = abs_in
            hold = hold_samples
        else:
            envelope = f32(release * envelope + (f32(1.0) - release) * abs_in)
        if envelope >= thresh:
            gain = f32(1.0)
        elif hold > 0:
            hold -= 1
            gain = f32(1.0)
        else:
            ratio = f32(envelope / thresh)
            gain = f32(ratio * ratio * ratio * ratio)
        out[i] = f32(l * gain)
    return out
