"""Practice-audio scenes made on the card from a seed.

The semantics of the port's `models/generators.py` `mixed_scene`, frozen
here so that the yardstick does not move with the program: audio in 10-s
sections, each one of five kinds,

- melody: notes of 0.45 s every 0.5 s, each a scale tone with 6
  harmonics (decay 0.7) peak-normalised to 0.3-0.4, over a Gaussian bed
  of 1e-4;
- chords: as the melody, but each 0.45 s note is a chord of 2 to 8
  distinct scale tones, each tone at 0.2-0.3 over the square root of the
  chord's size (so a chord's peak stays under 0.85), over the same bed;
- percussion: white-noise clicks (volume 0.5-0.7, a 20 ms decay to
  0.001) every 0.4-0.6 s from 0.1 s, over a Gaussian bed of 3e-4;
- a noise bed: Gaussian noise at -35 to -60 dBFS;
- silence.

The chords are this copy's addition: `mixed_scene` sounds one note at a
time, and the pitch chain tracks up to 8.  Every draw is made on the card by one `torch.Generator` seeded from the
run's seed, in a few large calls.  The kinds come in equal shares in
every block of sections (the seed orders them), so every seed gives the
card the same mix of work in another order.  A section is a row of the
filled tensor; a recording is its rows laid end to end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KINDS = ("melody", "chords", "percussion", "noise_bed", "silence")
SCALE = (220.0, 246.94, 261.63, 293.66, 329.63, 349.23, 392.0, 440.0,
         493.88, 523.25)
NOTE_S, NOTE_EVERY_S = 0.45, 0.5
HARMONICS, HARMONIC_DECAY = 6, 0.7
CHORD_SIZES, CHORD_AMP = (2, 8), (0.2, 0.3)
MELODY_BED, PERCUSSION_BED = 1e-4, 3e-4
CLICK_DECAY_S, CLICK_FLOOR = 0.020, 0.001
CLICK_FIRST_S, CLICK_GAP_S, CLICK_GAP_JITTER_S = 0.1, 0.4, 0.2
BED_DB = (35.0, 60.0)
MAX_CLICKS = 32


def tone_table(sample_rate: float) -> np.ndarray:
    """[len(SCALE), note samples] float32: each scale tone with its
    harmonics, peak-normalised to 1 (float64, then rounded)."""
    n = int(round(NOTE_S * sample_rate))
    t = np.arange(n, dtype=np.float64) / sample_rate
    rows = []
    for f in SCALE:
        out = np.zeros(n)
        for h in range(1, HARMONICS + 1):
            if f * h >= sample_rate / 2:
                break
            out += HARMONIC_DECAY ** (h - 1) * np.sin(2.0 * np.pi * f * h * t)
        rows.append(out / np.max(np.abs(out)))
    return np.stack(rows).astype(np.float32)


def click_envelope(sample_rate: float) -> np.ndarray:
    decay = sample_rate * CLICK_DECAY_S
    n = int(math.ceil(decay)) + 1
    rate = CLICK_FLOOR ** (1.0 / decay)
    return np.power(rate, np.arange(n, dtype=np.float64)).astype(np.float32)


def kinds(n: int, gen: torch.Generator) -> torch.Tensor:
    """[n] kind indices in equal shares (the first n % 5 kinds one more),
    in an order drawn from `gen`."""
    base = torch.arange(n, device=gen.device) % len(KINDS)
    return base[torch.randperm(n, generator=gen, device=gen.device)]


def render(n: int, length: int, sample_rate: float, gen: torch.Generator,
           out: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Fills `out` ([n, length] float32 on `gen`'s device) with n sections
    of `length` samples, their kinds in equal shares → the kinds [n]."""
    dev = gen.device
    kind = kinds(n, gen)
    table = torch.from_numpy(tone_table(sample_rate)).to(dev)
    env = torch.from_numpy(click_envelope(sample_rate)).to(dev)
    spacing = int(NOTE_EVERY_S * sample_rate)
    n_notes = max(0, -(-(length - spacing) // spacing))
    section = int(10.0 * sample_rate)
    click_stop = length - section // 20
    idx = torch.arange(length, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        k = kind[r0:r1]
        rows = r1 - r0
        x = torch.randn((rows, length), generator=gen, device=dev)
        bed = torch.zeros(rows, device=dev)
        bed[k <= 1] = MELODY_BED
        bed[k == 2] = PERCUSSION_BED
        level = torch.pow(10.0, -(BED_DB[0] + (BED_DB[1] - BED_DB[0])
                                  * torch.rand(rows, generator=gen,
                                               device=dev)) / 20.0)
        bed = torch.where(k == 3, level, bed)
        x *= bed[:, None]
        # Melody: note j starts at j * spacing and lasts len(table[0]).
        m = max(n_notes, 1)
        note = torch.randint(0, len(SCALE), (rows, m), generator=gen,
                             device=dev)
        amp = 0.3 + 0.1 * torch.rand((rows, m), generator=gen, device=dev)
        # Chords: note j sounds the first `size` tones of a random order
        # of the scale, each at `chord_amp / sqrt(size)`.
        size = torch.randint(CHORD_SIZES[0], CHORD_SIZES[1] + 1, (rows, m),
                             generator=gen, device=dev)
        rank = torch.rand((rows, m, len(SCALE)), generator=gen,
                          device=dev).argsort(-1).argsort(-1)
        chord_amp = CHORD_AMP[0] + (CHORD_AMP[1] - CHORD_AMP[0]) * torch.rand(
            (rows, m), generator=gen, device=dev)
        weight = torch.where(rank < size[..., None],
                             (chord_amp / size.sqrt())[..., None], 0.0)
        j = (idx // spacing).clamp(max=max(n_notes - 1, 0))
        u = idx - j * spacing
        sounding = (u < table.shape[1]) & (idx < n_notes * spacing)
        uc = u.clamp(max=table.shape[1] - 1)
        mel = (k == 0).nonzero().flatten()
        if len(mel) and n_notes:
            f = note[mel][:, j]
            tone = table[f, uc[None, :]]
            x[mel] += torch.where(sounding, tone * amp[mel][:, j], 0.0)
        ch = (k == 1).nonzero().flatten()
        if len(ch) and n_notes:
            acc = torch.zeros((len(ch), length), device=dev)
            for t in range(len(SCALE)):
                acc += weight[ch, :, t][:, j] * table[t, uc][None, :]
            x[ch] += torch.where(sounding, acc, 0.0)
            del acc
        # Percussion: clicks from 0.1 s, 0.4-0.6 s apart, of white noise
        # in [-1, 1) under a 20 ms decay.
        gaps = CLICK_GAP_S + CLICK_GAP_JITTER_S * torch.rand(
            (rows, MAX_CLICKS - 1), generator=gen, device=dev,
            dtype=torch.float64)
        times = torch.cat([torch.full((rows, 1), CLICK_FIRST_S,
                                      dtype=torch.float64, device=dev),
                           CLICK_FIRST_S + torch.cumsum(gaps, 1)], 1)
        starts = (times * sample_rate).to(torch.int64)
        vol = 0.5 + 0.2 * torch.rand((rows, MAX_CLICKS), generator=gen,
                                     device=dev)
        noise = 2.0 * torch.rand((rows, length), generator=gen,
                                 device=dev) - 1.0
        per = (k == 2).nonzero().flatten()
        if len(per):
            st = starts[per]
            live = st < click_stop
            at = idx.expand(len(per), -1).contiguous()
            last = torch.searchsorted(st, at, right=True) - 1
            c = last.clamp(min=0)
            off = idx[None, :] - torch.gather(st, 1, c)
            on = ((last >= 0) & (off < len(env))
                  & torch.gather(live, 1, c))
            click = (noise[per] * torch.gather(vol[per], 1, c)
                     * env[off.clamp(0, len(env) - 1)])
            x[per] += torch.where(on, click, 0.0)
        x[k == 4] = 0.0
        out[r0:r1] = x
        del x, noise
    return kind
