"""The test signals the port's smoke run and tests render: numpy, float32.

A copy of the generators of `audio_analyzer_rs_tpu.models.generators` that
drive the ported paths and the CLI (`mixed_scene`, the canonical agreement
scene; `tone_with_harmonics`, the spectral-gate probe; `tick` and
`calibration_click`, the onset probes; `sine`, `sweep`, `silence` and
`adsr_envelope`), with the helpers they call, so that the port renders its
inputs without importing the JAX package.  Same formulas, same order of
operations, same numpy RNG stream: tests/test_torch_generators.py holds them
bit-equal to the originals.
"""

from __future__ import annotations

import numpy as np

TWO_PI = float(np.float32(2.0 * np.float32(np.pi)))  # ref generators/mod.rs:15
MIN_ENVELOPE = 0.001

_LCG_A = 1103515245
_LCG_C = 12345
_LCG_MASK = 0x7FFFFFFF


def sine(freq: float, duration_s: float, sample_rate: float,
         amplitude: float = 1.0, phase: float = 0.0) -> np.ndarray:
    """Pure sine, float32."""
    n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64)
    return (amplitude * np.sin(2.0 * np.pi * freq * t / sample_rate + phase)
            ).astype(np.float32)


def sweep(f0: float, f1: float, duration_s: float, sample_rate: float,
          amplitude: float = 1.0) -> np.ndarray:
    """Linear chirp f0→f1, float32."""
    n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64) / sample_rate
    k = (f1 - f0) / duration_s
    phase = 2.0 * np.pi * (f0 * t + 0.5 * k * t * t)
    return (amplitude * np.sin(phase)).astype(np.float32)


def lcg_states(n: int, seed: int) -> np.ndarray:
    """The LCG state sequence s = (s*1103515245 + 12345) & 0x7FFFFFFF by
    jump-doubling: a block of m states extends to 2m with the m-step jump
    s -> (A*s + C) mod 2^31 (products of two 31-bit values fit uint64)."""
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    a, c, mask = np.uint64(_LCG_A), np.uint64(_LCG_C), np.uint64(_LCG_MASK)
    states = np.empty(n, dtype=np.uint64)
    states[0] = (np.uint64(seed) * a + c) & mask
    m, A, C = 1, a, c
    while m < n:
        take = min(m, n - m)
        states[m:m + take] = (A * states[:take] + C) & mask
        C = (A * C + C) & mask
        A = (A * A) & mask
        m *= 2
    return states


def lcg_noise(n: int, seed: int = 12345) -> np.ndarray:
    """LCG noise in [-1, 1): state/2^31 - 1."""
    states = lcg_states(n, seed)
    return (states.astype(np.float32) / np.float32(2147483648.0)
            - np.float32(1.0)).astype(np.float32)


def exp_envelope(n: int, decay_samples: float,
                 min_envelope: float = MIN_ENVELOPE) -> np.ndarray:
    """envelope[t] = decay_rate**t with decay_rate = min_env**(1/decay_samples)."""
    decay_rate = np.float64(min_envelope) ** (1.0 / np.float64(decay_samples))
    return np.power(decay_rate, np.arange(n, dtype=np.float64)).astype(np.float32)


def tick(freq: float, volume: float, decay_ms: float, sample_rate: float,
         duration_s: float | None = None) -> np.ndarray:
    """One metronome tick: sin(2π f t / sr) with an exponential decay
    (ref metronome.rs:43-69)."""
    decay_samples = sample_rate * (decay_ms / 1000.0)
    if duration_s is None:
        n = int(np.ceil(decay_samples)) + 1
    else:
        n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64)
    phase_inc = freq * TWO_PI / sample_rate
    env = exp_envelope(n, decay_samples)
    return (np.sin(t * phase_inc).astype(np.float32) * np.float32(volume) * env
            ).astype(np.float32)


def noise_burst(volume: float, decay_ms: float, sample_rate: float,
                n: int | None = None, seed: int = 12345) -> np.ndarray:
    """White-noise click transient with an exponential decay."""
    decay_samples = sample_rate * (decay_ms / 1000.0)
    if n is None:
        n = int(np.ceil(decay_samples)) + 1
    env = exp_envelope(n, decay_samples)
    return (lcg_noise(n, seed) * np.float32(volume) * env).astype(np.float32)


def calibration_click(sample_rate: float, volume: float = 0.8,
                      n: int | None = None) -> np.ndarray:
    """2500 Hz click + 15 ms noise burst, 50 ms sine decay (ref
    generators/calibration.rs:77-133)."""
    sine_decay = sample_rate * 0.05
    if n is None:
        n = int(np.ceil(sine_decay)) + 1
    click = tick(2500.0, volume, 50.0, sample_rate, duration_s=n / sample_rate)
    noise = noise_burst(volume * 0.5, 15.0, sample_rate, n=n)
    return (click + noise).astype(np.float32)


def silence(duration_s: float, sample_rate: float) -> np.ndarray:
    return np.zeros(int(round(duration_s * sample_rate)), dtype=np.float32)


def tone_with_harmonics(freq: float, duration_s: float, sample_rate: float,
                        harmonics: int = 6, decay: float = 0.7,
                        amplitude: float = 0.5) -> np.ndarray:
    """Harmonically rich tone, peak-normalised to `amplitude`."""
    n = int(round(duration_s * sample_rate))
    t = np.arange(n, dtype=np.float64) / sample_rate
    out = np.zeros(n, dtype=np.float64)
    for h in range(1, harmonics + 1):
        if freq * h >= sample_rate / 2:
            break
        out += (decay ** (h - 1)) * np.sin(2.0 * np.pi * freq * h * t)
    out *= amplitude / np.max(np.abs(out))
    return out.astype(np.float32)


def adsr_envelope(n: int, sample_rate: float, attack_sec: float,
                  decay_sec: float, sustain_level: float, release_sec: float,
                  sustain_samples: int) -> np.ndarray:
    """Closed-form ADSR matching the per-sample Voice envelope recurrences
    (ref synth.rs:150-198): linear attack to 1, linear decay to sustain,
    hold, linear release to 0."""
    t = np.arange(n, dtype=np.float64)
    a = max(attack_sec, 0.001) * sample_rate
    d_rate = (1.0 - sustain_level) / (max(decay_sec, 0.001) * sample_rate)
    r_rate = sustain_level / (max(release_sec, 0.001) * sample_rate)
    attack_end = a
    decay_end = attack_end + (1.0 - sustain_level) / max(d_rate, 1e-12)
    sustain_end = decay_end + sustain_samples
    env = np.where(
        t < attack_end, t / a,
        np.where(
            t < decay_end, 1.0 - (t - attack_end) * d_rate,
            np.where(
                t < sustain_end, sustain_level,
                np.maximum(sustain_level - (t - sustain_end) * r_rate, 0.0))))
    return env.astype(np.float32)


def mixed_scene(duration_s: float, sample_rate: float,
                seed: int = 0) -> np.ndarray:
    """Deterministic test scene in 10 s sections, each one of: melody notes
    with harmonics over a quiet bed, percussion bursts, a noise bed of random
    level, or silence."""
    rng = np.random.default_rng(seed)
    n = int(round(duration_s * sample_rate))
    x = np.zeros(n, dtype=np.float32)
    scale = [220.0, 246.94, 261.63, 293.66, 329.63, 349.23, 392.0, 440.0,
             493.88, 523.25]
    section = int(10.0 * sample_rate)
    for s0 in range(0, n, section):
        s1 = min(s0 + section, n)
        kind = rng.integers(0, 4)
        if kind == 0:              # melody over a quiet bed
            x[s0:s1] += (rng.standard_normal(s1 - s0) * 1e-4).astype(np.float32)
            t = 0.0
            while (s0 + int((t + 0.5) * sample_rate)) < s1:
                f = scale[int(rng.integers(0, len(scale)))]
                tone = tone_with_harmonics(f, 0.45, sample_rate, harmonics=6,
                                           amplitude=0.3 + 0.1 * rng.random())
                lo = s0 + int(t * sample_rate)
                m = min(len(tone), s1 - lo)
                x[lo:lo + m] += tone[:m]
                t += 0.5
        elif kind == 1:            # percussion
            x[s0:s1] += (rng.standard_normal(s1 - s0) * 3e-4).astype(np.float32)
            t = 0.1
            while (s0 + int(t * sample_rate)) < s1 - section // 20:
                burst = noise_burst(0.5 + 0.2 * rng.random(), 20.0,
                                    sample_rate, seed=int(seed + t * 997))
                lo = s0 + int(t * sample_rate)
                m = min(len(burst), s1 - lo)
                x[lo:lo + m] += burst[:m]
                t += 0.4 + 0.2 * rng.random()
        elif kind == 2:            # noise bed (room noise level shifts)
            level = 10.0 ** (-rng.uniform(35.0, 60.0) / 20.0)
            x[s0:s1] += (rng.standard_normal(s1 - s0) * level
                         ).astype(np.float32)
        # kind == 3: silence
    return x
