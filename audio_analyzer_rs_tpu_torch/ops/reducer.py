"""Input conditioning: biquad HPF/LPF + envelope-follower noise gate (port of
audio_analyzer_rs_tpu/ops/reducer.py; ref src/audio_io/mod.rs:336-511).

RBJ biquads (HPF 40 Hz, LPF 14 kHz, Q=0.707), instantaneous-attack envelope
follower with 40 ms release and 20 ms hold, gate gain ratio^4 below the
-60 dB threshold.

The device scan `reduce_signal` takes audio [..., T] with state leaves
[...] (one stream per leading index; a batched call equals per-stream
calls bit for bit):
- mode "exact" runs HPF -> LPF -> gate per sample: kernel K6
  (ops/hopper_reducer.py, csrc/reducer.cu) on CUDA tensors, its plain
  version `reduce_exact_plain` on CPU tensors;
- mode "fast" runs each biquad as `biquad_apply`, a prefix of 2x2 affine
  maps inside 256-sample blocks (plain torch, as the JAX package leaves it
  to XLA outside any kernel), then the gate alone (K6's gate-only entry,
  `noise_gate`).

Rounding, found from the JAX scan's bits on XLA:CPU (tests/
test_torch_reducer.py holds it): each biquad is fma(-a2, y2, fma(-a1, y1,
fma(b2, x2, fma(b0, x, b1*x1)))); the envelope's release blend is fma(rel,
env, (1 - rel)*|l|); XLA turns (env / threshold)^4 into
(((env*env)*env)*env) * (1/threshold)^4, with the constant folded in
float32 (`GAIN_SCALE`).  The plain versions compute the fused forms with
one rounding (`rounding.fma32`, or a float64 sum checked for the one case
where rounding it to float32 would round twice), and the kernel with
`fmaf`, so the three are bitwise equal.

`HostReducer` is the live engine's per-slot reducer when the C++ runtime
(runtime/) is not built; `reduce_signal_np` is the one-shot transcription.
The host pieces below the device half are the JAX module's, line for line
(tests/test_torch_host_copies.py holds them so).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hopper_reducer
from .rounding import fma32

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


_F32 = np.float32
# The gate's threshold, and the float32 constant XLA folds (1/threshold)^4
# into (the kernel spells both as hex floats).
THRESHOLD = float(_F32(10.0 ** (GATE_THRESHOLD_DB / 20.0)))
_INV_THRESHOLD = _F32(_F32(1.0) / _F32(THRESHOLD))
GAIN_SCALE = float(_F32(_F32(_F32(_INV_THRESHOLD * _INV_THRESHOLD)
                                 * _INV_THRESHOLD) * _INV_THRESHOLD))
_BIQUAD_BLOCK = 256


class BiquadState(NamedTuple):
    x1: torch.Tensor   # [...] float32
    x2: torch.Tensor
    y1: torch.Tensor
    y2: torch.Tensor


class GateState(NamedTuple):
    envelope: torch.Tensor         # [...] float32
    hold_remaining: torch.Tensor   # [...] int32


class ReducerState(NamedTuple):
    hp: BiquadState
    lp: BiquadState
    gate: GateState


def biquad_init(device="cuda", batch: tuple = ()) -> BiquadState:
    return BiquadState(*(torch.zeros(batch, dtype=torch.float32,
                                     device=device) for _ in range(4)))


def gate_init(device="cuda", batch: tuple = ()) -> GateState:
    return GateState(torch.zeros(batch, dtype=torch.float32, device=device),
                     torch.zeros(batch, dtype=torch.int32, device=device))


def reducer_init(device="cuda", batch: tuple = ()) -> ReducerState:
    return ReducerState(biquad_init(device, batch),
                        biquad_init(device, batch), gate_init(device, batch))


def gate_params(sample_rate: float) -> tuple[float, float, int]:
    """(release coefficient, 1 - release, hold samples) at `sample_rate`,
    the floats as float32 values."""
    rel = _F32(np.exp(_F32(-1.0) / _F32(GATE_RELEASE_S * sample_rate)))
    return float(rel), float(_F32(1.0) - rel), int(GATE_HOLD_S * sample_rate)


# ── The plain versions of kernel K6 ──────────────────────────────────────

_MID32 = 1 << 28                 # a float32 midpoint's low 29 float64 bits
_LOW29 = (1 << 29) - 1
_MAG = (1 << 63) - 1
_MIN_NORMAL32 = 0x3810000000000000   # float64 bits of 2**-126
_HALF_SUB = 2.0 ** 150           # 1 / half of float32's subnormal spacing


_CHUNK = 2048        # samples a checked stretch
_EXACT_RUN = 64      # samples redone with fma32 from a hazard on


def _rounds_twice(sums: torch.Tensor) -> torch.Tensor:
    """Where rounding these float64 sums to float32 could differ from
    rounding the exact sum once: where a sum lands on a float32 midpoint
    (rounding is monotone, so anywhere else the exact sum lies between the
    same two midpoints).  In float32's normal range a midpoint's low 29
    float64 bits are 1 << 28; below it, a midpoint is an odd multiple of
    2**-150, half the subnormal spacing (a product below 2**24 in float64,
    exact).  → bool, reduced over the last axis."""
    bits = sums.view(torch.int64)
    sub = (bits & _MAG) < _MIN_NORMAL32
    sub_mid = sub & (torch.remainder(sums.abs() * _HALF_SUB, 2.0) == 1.0)
    return ((~sub & ((bits & _LOW29) == _MID32)) | sub_mid).any(-1)


def _first_hazard(sums: list, per_sample: int):
    """The first sample whose float64 sums could round twice, or None."""
    if not sums:
        return None
    hit = torch.nonzero(_rounds_twice(torch.stack(sums)))
    return None if len(hit) == 0 else int(hit[0, 0]) // per_sample


def _feedforward(x: torch.Tensor, st: BiquadState, b0: float, b1: float,
                 b2: float) -> torch.Tensor:
    """fma(b2, x[t-2], fma(b0, x[t], b1*x[t-1])) for every t: x [B, T]."""
    x1 = torch.cat([st.x1[:, None], x[:, :-1]], 1)
    x2 = torch.cat([st.x2[:, None], st.x1[:, None], x[:, :-2]], 1)[:, :x.shape[1]]
    return fma32(b2, x2, fma32(b0, x, x1 * b1))


def _feedback(ff: torch.Tensor, y1: torch.Tensor, y2: torch.Tensor,
              na1: float, na2: float) -> torch.Tensor:
    """y[t] = fma(na2, y[t-2], fma(na1, y[t-1], ff[t])), each fma rounded
    once to float32: ff [B, T], y1 = y[-1] and y2 = y[-2] [B] → y [B, T].

    A product of two float32 values is exact in float64, so each fma is the
    float64 sum rounded to float32; that rounds twice only where the sum
    lands on a float32 midpoint.  Each stretch
    of samples is checked for that (`_rounds_twice`); from the first such
    sample on, _EXACT_RUN samples are redone with `fma32`, then the checked
    stretches go on."""
    cols, exact = ff.double().unbind(1), ff.unbind(1)
    a, b = y1.double(), y2.double()
    ys, t, n = [], 0, len(cols)
    while t < n:
        a0, b0 = a, b
        sums, part = [], []
        for f in cols[t:min(t + _CHUNK, n)]:
            s1 = torch.add(f, a, alpha=na1)
            s2 = torch.add(s1.float().double(), b, alpha=na2)
            b, a = a, s2.float().double()
            sums += (s1, s2)
            part.append(a)
        h = _first_hazard(sums, 2)
        if h is None:
            ys += part
            t += len(part)
            continue
        ys += part[:h]
        a = part[h - 1] if h >= 1 else a0
        b = part[h - 2] if h >= 2 else (a0 if h == 1 else b0)
        t += h
        for f in exact[t:min(t + _EXACT_RUN, n)]:
            b, a = a, fma32(na2, b, fma32(na1, a, f)).double()
            ys.append(a)
        t = min(t + _EXACT_RUN, n)
    if not ys:
        return ff.clone()
    return torch.stack(ys, 1).float()


def _envelope(a: torch.Tensor, q: torch.Tensor, env0: torch.Tensor,
              rel: float) -> torch.Tensor:
    """The envelope after each sample: a > env ? a : fma(rel, env, q), with
    a = |l| and q = (1 - rel)*|l| [B, T], env0 [B] → [B, T] (checked for
    double rounding as `_feedback` is)."""
    ac, qc = a.double().unbind(1), q.double().unbind(1)
    env = env0.double()
    envs, t, n = [], 0, len(ac)
    while t < n:
        e0, sums, part = env, [], []
        for at, qt in zip(ac[t:min(t + _CHUNK, n)], qc[t:min(t + _CHUNK, n)]):
            s = torch.add(qt, env, alpha=rel)
            env = torch.where(at > env, at, s.float().double())
            sums.append(s)
            part.append(env)
        h = _first_hazard(sums, 1)
        if h is None:
            envs += part
            t += len(part)
            continue
        envs += part[:h]
        env = part[h - 1] if h >= 1 else e0
        t += h
        for j in range(t, min(t + _EXACT_RUN, n)):
            env = torch.where(ac[j] > env, ac[j],
                              fma32(rel, env, q[:, j]).double())
            envs.append(env)
        t = min(t + _EXACT_RUN, n)
    return torch.stack(envs, 1).float()


def gate_plain(state: GateState, x: torch.Tensor, sample_rate: float):
    """The noise gate over x [B, T] float32 with state leaves [B] →
    (state, gated [B, T]).  The envelope is the one sequential recurrence;
    the hold counter follows from it in closed form: after the last attack
    (or from the carried count) it loses one for each sample below the
    threshold while it is positive."""
    rel, c1, hold_samples = gate_params(sample_rate)
    if x.shape[1] == 0:
        return state, x.clone()
    a = x.abs()
    env = _envelope(a, a * c1, state.envelope, rel)
    attack = a > torch.cat([state.envelope[:, None], env[:, :-1]], 1)
    above = env >= THRESHOLD
    below = (~above).to(torch.int64)
    t = torch.arange(x.shape[1], device=x.device)
    start = torch.where(attack, t, -1).cummax(1).values
    before = torch.cumsum(below, 1) - below          # below in [0, t)
    since = before - torch.gather(before, 1, start.clamp(min=0))
    held = torch.where(start >= 0, hold_samples,
                       state.hold_remaining[:, None].to(torch.int64))
    hold = (held - torch.where(start >= 0, since, before)).clamp(min=0)
    in_hold = ~above & (hold > 0)
    e4 = env * env * env * env * GAIN_SCALE
    gain = torch.where(above | in_hold, torch.ones_like(env), e4)
    hold_out = (hold[:, -1] - in_hold[:, -1].to(torch.int64)).to(torch.int32)
    return GateState(env[:, -1].clone(), hold_out), x * gain


def _biquad_plain(st: BiquadState, x: torch.Tensor, coeffs):
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    y = _feedback(_feedforward(x, st, b0, b1, b2), st.y1, st.y2, -a1, -a2)
    n = x.shape[1]
    if n == 0:
        return st, y
    x1 = x[:, -2] if n > 1 else st.x1
    y2 = y[:, -2] if n > 1 else st.y1
    return BiquadState(x[:, -1].clone(), x1.clone(), y[:, -1].clone(),
                       y2.clone()), y


def reduce_exact_plain(state: ReducerState, x: torch.Tensor,
                       sample_rate: float):
    """Kernel K6's plain version: HPF -> LPF -> gate, sample by sample in
    the kernel's rounding, over x [B, T] float32 with state leaves [B] →
    (state, conditioned [B, T])."""
    hp, h = _biquad_plain(state.hp, x,
                          biquad_coeffs(HPF_FREQ, sample_rate, False))
    lp, lo = _biquad_plain(state.lp, h,
                           biquad_coeffs(LPF_FREQ, sample_rate, True))
    gate, y = gate_plain(state.gate, lo, sample_rate)
    return ReducerState(hp, lp, gate), y


# ── The device entry points ──────────────────────────────────────────────

def _flat(tree, lead: tuple):
    return type(tree)(*(_flat(t, lead) if isinstance(t, tuple)
                        else t.reshape(-1) for t in tree))


def _unflat(tree, lead: tuple):
    return type(tree)(*(_unflat(t, lead) if isinstance(t, tuple)
                        else t.reshape(lead) for t in tree))


def noise_gate(state: GateState, x: torch.Tensor, sample_rate: float):
    """The envelope-follower gate (ref mod.rs:392-471) over x [..., T]
    float32 with state leaves [...] → (state, gated [..., T]): K6's
    gate-only entry on CUDA tensors, `gate_plain` on CPU tensors."""
    lead = tuple(x.shape[:-1])
    st = ReducerState(biquad_init(x.device, lead), biquad_init(x.device, lead),
                      state)
    st, y = hopper_reducer.reduce_scan(
        _flat(st, lead), x.reshape(-1, x.shape[-1]), sample_rate, True)
    return _unflat(st.gate, lead), y.reshape(x.shape)


def biquad_apply(state: BiquadState, x: torch.Tensor, coeffs):
    """Direct-form-I biquad as a blocked prefix (the JAX package's `fast`
    biquad): inside each 256-sample block the per-sample affine maps of
    y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2] are
    composed by doubling (log2(256) steps), and a loop across blocks
    carries the state.  x [..., T] float32, state leaves [...] →
    (state, y [..., T]).  The maps compose in float64: in float32 the
    prefix of the 40 Hz HPF's near-unit-circle maps loses ~-22 dB against
    the sequential filter (JAX's float32 tree ~-28 dB); in float64 it
    stays within ~1e-4 of the peak of the exact mode
    (tests/test_torch_reducer.py)."""
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    n = x.shape[-1]
    if n == 0:
        return state, x.clone()
    x1 = torch.cat([state.x1[..., None], x[..., :-1]], -1)
    x2 = torch.cat([state.x2[..., None], state.x1[..., None],
                    x[..., :-2]], -1)[..., :n]
    f = (b0 * x + b1 * x1 + b2 * x2).double()
    blk = _BIQUAD_BLOCK
    f = torch.nn.functional.pad(f, (0, (-n) % blk))
    f = f.reshape(f.shape[:-1] + (-1, blk))
    mat = torch.tensor([[-a1, -a2], [1.0, 0.0]], dtype=torch.float64,
                       device=x.device)
    m = mat.expand(f.shape + (2, 2)).clone()
    c = torch.stack([f, torch.zeros_like(f)], -1)
    d = 1
    while d < blk:          # element i composes samples (i - 2d, i]
        m_prev, c_prev = m[..., :-d, :, :], c[..., :-d, :]
        m_new = m.clone()
        c_new = c.clone()
        m_new[..., d:, :, :] = m[..., d:, :, :] @ m_prev
        c_new[..., d:, :] = (m[..., d:, :, :] @ c_prev[..., None])[..., 0] \
            + c[..., d:, :]
        m, c = m_new, c_new
        d *= 2
    v0 = torch.stack([state.y1, state.y2], -1).double()
    ys = []
    for k in range(f.shape[-2]):
        v = (m[..., k, :, :, :] @ v0[..., None, :, None])[..., 0] \
            + c[..., k, :, :]
        v0 = v[..., -1, :]
        ys.append(v[..., 0])
    y = torch.cat(ys, -1)[..., :n].float()
    y2 = y[..., -2] if n > 1 else state.y1
    return BiquadState(x[..., -1], x1[..., -1], y[..., -1], y2), y


def reduce_signal(state: ReducerState, x: torch.Tensor, sample_rate: float,
                  mode: str = "exact"):
    """HPF 40 Hz -> LPF 14 kHz -> noise gate over x [..., T] (cast to
    float32) with state leaves [...] → (state, conditioned [..., T]).

    * ``exact`` — one per-sample pass (kernel K6 on CUDA tensors), bitwise
      equal to the JAX scan on XLA:CPU.
    * ``fast`` — the blocked-prefix biquads, then the gate alone.

    AGC (`dynamics.dynamics_scan`) runs per slot afterwards."""
    x = x.to(torch.float32)
    if mode == "fast":
        hp, y = biquad_apply(state.hp, x,
                             biquad_coeffs(HPF_FREQ, sample_rate, False))
        lp, y = biquad_apply(state.lp, y,
                             biquad_coeffs(LPF_FREQ, sample_rate, True))
        gate, y = noise_gate(state.gate, y, sample_rate)
        return ReducerState(hp, lp, gate), y
    if mode != "exact":
        raise ValueError(f"mode={mode!r}: expected 'exact' or 'fast'")
    lead = tuple(x.shape[:-1])
    st, y = hopper_reducer.reduce_scan(
        _flat(state, lead), x.reshape(-1, x.shape[-1]), sample_rate, False)
    return _unflat(st, lead), y.reshape(x.shape)


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
