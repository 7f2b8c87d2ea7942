"""PitchTracker — hysteresis over consecutive frames (port of
audio_analyzer_rs_tpu/ops/tracker.py; ref src/audio_io/stft.rs:20-117).

Display after 2 hits, max life 3, 3% frequency tolerance, EMA 0.6/0.4 (snap
on onset), onset reaps unmatched tracks immediately.  MAX_TRACKS fixed
slots per stream; creation order is a per-track sequence number.

`tracker_scan_batched` runs S streams and their stable top-8: kernel K3
(ops/hopper_tracker.py), scan and `select_stable` in one launch, for CUDA
tensors; the plain loop over `_step` and then `select_stable` for CPU
tensors.  The plain EMA is `freq*0.6 + raw*0.4` as separate rounded ops,
which the kernel reproduces with __fmul_rn/__fadd_rn.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import hopper_tracker
from .pitch import MAX_NOTES

# 8 live raw pitches + up to 8 coasting tracks + headroom (see the JAX
# module).
MAX_TRACKS = 24
DISPLAY_THRESHOLD = 2
MAX_LIFE = 3
TOLERANCE = 0.03
EMA_OLD, EMA_NEW = 0.6, 0.4
INT_MAX = 2 ** 31 - 1   # the seq of an empty slot


class TrackerState(NamedTuple):
    freq: torch.Tensor      # [..., T] float32
    score: torch.Tensor     # [..., T] float32
    life: torch.Tensor      # [..., T] int32
    valid: torch.Tensor     # [..., T] bool
    seq: torch.Tensor       # [..., T] int32 creation order
    next_seq: torch.Tensor  # [...] int32


def init_state(device="cuda", batch: tuple = ()) -> TrackerState:
    shape = batch + (MAX_TRACKS,)
    return TrackerState(
        freq=torch.zeros(shape, dtype=torch.float32, device=device),
        score=torch.zeros(shape, dtype=torch.float32, device=device),
        life=torch.zeros(shape, dtype=torch.int32, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        seq=torch.full(shape, INT_MAX, dtype=torch.int32, device=device),
        next_seq=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _step(state: TrackerState, raw_freq, raw_score, raw_valid, onset):
    """One frame for S streams: state leaves [S, T] / [S]; raw_* [S, 8];
    onset [S] → (state, (freq, score, stable, seq) each [S, T])."""
    freq, score, life = state.freq, state.score, state.life
    valid, seq, next_seq = state.valid, state.seq, state.next_seq
    dev = freq.device
    matched = torch.zeros_like(valid)
    iota = torch.arange(MAX_TRACKS, device=dev)

    # Entry-state values: tracks updated this frame are excluded from later
    # rounds by `matched`, so precomputing them is exact.
    rf = raw_freq[:, :, None]                                  # [S, 8, 1]
    rel_ok = ((freq[:, None, :] - rf).abs()
              / freq.abs().clamp_min(1e-30)[:, None, :]) < TOLERANCE
    new_f_all = torch.where(onset[:, None, None], rf,
                            freq[:, None, :] * EMA_OLD + rf * EMA_NEW)
    life_inc = (life + 1).clamp_max(MAX_LIFE)

    # Phase 1: greedy matching in raw order, to the first track by seq.
    any_flags = []
    for i in range(MAX_NOTES):
        cand = valid & ~matched & rel_ok[:, i]
        any_match = cand.any(-1) & raw_valid[:, i]
        first = torch.where(cand, seq, INT_MAX).argmin(-1)
        oh = (iota == first[:, None]) & any_match[:, None]
        freq = torch.where(oh, new_f_all[:, i], freq)
        score = torch.where(oh, raw_score[:, i:i + 1], score)
        life = torch.where(oh, life_inc, life)
        matched = matched | oh
        any_flags.append(any_match)

    # Phase 2: unmatched raws spawn into free slots by rank.
    unmatched_raw = raw_valid & ~torch.stack(any_flags, -1)     # [S, 8]
    free = ~valid
    slot_rank = torch.where(free, free.to(torch.int32).cumsum(-1) - 1, -1)
    raw_rank = torch.where(unmatched_raw,
                           unmatched_raw.to(torch.int32).cumsum(-1) - 1, -2)
    assign = slot_rank[:, None, :] == raw_rank[:, :, None]      # [S, 8, T]
    oh_s = assign.any(1)
    freq = torch.where(oh_s, torch.where(assign, rf, 0.0).sum(1), freq)
    score = torch.where(
        oh_s, torch.where(assign, raw_score[:, :, None], 0.0).sum(1), score)
    life = torch.where(oh_s, 1, life)
    spawn_rank = torch.where(assign, raw_rank[:, :, None], 0).sum(1)
    seq = torch.where(oh_s, (next_seq[:, None] + spawn_rank).to(torch.int32),
                      seq)
    matched = matched | oh_s
    valid = valid | oh_s
    next_seq = (next_seq + oh_s.sum(-1)).to(torch.int32)

    # Misses: decay, or reap on an onset (ref stft.rs:86-113).
    unmatched = valid & ~matched
    life = torch.where(unmatched, torch.where(onset[:, None], 0, life - 1),
                       life)
    valid = valid & (life > 0)
    seq = torch.where(valid, seq, INT_MAX)
    stable = valid & (life >= DISPLAY_THRESHOLD)
    return (TrackerState(freq, score, life, valid, seq, next_seq),
            (freq, score, stable, seq))


def tracker_scan_plain(state: TrackerState, raw_freqs, raw_scores, raw_valid,
                       onsets):
    """The plain batched scan: state leaves [S, T] / [S]; raw_* [S, N, 8];
    onsets [S, N] → (state, (freq, score, stable, seq) each [S, N, T])."""
    emits = []
    for i in range(raw_freqs.shape[1]):
        state, out = _step(state, raw_freqs[:, i], raw_scores[:, i],
                           raw_valid[:, i], onsets[:, i])
        emits.append(out)
    if not emits:
        s = raw_freqs.shape[0]
        empty = state.freq.new_zeros((s, 0, MAX_TRACKS))
        return state, (empty, empty.clone(), empty.bool(), empty.int())
    return state, tuple(torch.stack(x, 1) for x in zip(*emits))


def select_stable(freq, score, stable, seq):
    """Stable-by-seq top-8, parallel over frames: rank each slot by (key,
    slot) with key = seq for stable slots and INT_MAX otherwise, emit the
    first MAX_NOTES in rank order; unfilled outputs are 0.  Inputs
    [..., T]; outputs [..., MAX_NOTES]."""
    keys = torch.where(stable, seq, INT_MAX)
    iota = torch.arange(MAX_TRACKS, device=freq.device)
    kj, ki = keys[..., None, :], keys[..., :, None]
    less = (kj < ki) | ((kj == ki) & (iota[None, :] < iota[:, None]))
    rank = less.sum(-1)
    sel = stable & (rank < MAX_NOTES)
    onehot = (torch.where(sel, rank, MAX_NOTES)[..., None]
              == torch.arange(MAX_NOTES, device=freq.device))  # [..., T, 8]
    # One contributor per output: the masked sums pick values exactly.
    out_freq = torch.where(onehot, freq[..., None], 0.0).sum(-2)
    out_score = torch.where(onehot, score[..., None], 0.0).sum(-2)
    out_valid = onehot.any(-2)
    return out_freq, out_score, out_valid


def tracker_scan_batched(state: TrackerState, raw_freqs, raw_scores,
                         raw_valid, onsets):
    """S streams: state leaves [S, T] / [S]; raw_* [S, N, 8], onsets [S, N]
    → (state, (freqs, scores, valid) each [S, N, 8]).  Kernel K3 (scan and
    stable top-8 in one launch) on CUDA tensors; `tracker_scan_plain` and
    `select_stable` on CPU tensors."""
    return hopper_tracker.tracker_scan(state, raw_freqs, raw_scores,
                                       raw_valid, onsets)


def tracker_scan(state: TrackerState, raw_freqs, raw_scores, raw_valid,
                 onsets):
    """One stream: state leaves [T] / []; raw_* [N, 8], onsets [N] →
    (state, (freqs, scores, valid) [N, 8]) — `tracker_scan_batched` at
    S = 1."""
    batched = TrackerState(*(a[None] for a in state))
    batched, outs = tracker_scan_batched(batched, raw_freqs[None],
                                         raw_scores[None], raw_valid[None],
                                         onsets[None])
    return (TrackerState(*(a[0] for a in batched)),
            tuple(o[0] for o in outs))


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

class PitchTrackerNp:
    """ref stft.rs:20-117, list-based."""

    def __init__(self):
        self.tracks = []  # [freq, score, life]

    def process(self, raw_pitches, onset: bool):
        matched = [False] * len(self.tracks)
        for raw_freq, raw_score in raw_pitches:
            found = False
            for i, tr in enumerate(self.tracks):
                if matched[i]:
                    continue
                if abs(tr[0] - raw_freq) / tr[0] < TOLERANCE:
                    tr[0] = raw_freq if onset else tr[0] * EMA_OLD + raw_freq * EMA_NEW
                    tr[1] = raw_score
                    tr[2] = min(tr[2] + 1, MAX_LIFE)
                    matched[i] = True
                    found = True
                    break
            if not found:
                self.tracks.append([raw_freq, raw_score, 1])
                matched.append(True)
        active = []
        i = 0
        while i < len(self.tracks):
            if not matched[i]:
                self.tracks[i][2] = 0 if onset else self.tracks[i][2] - 1
            if self.tracks[i][2] <= 0:
                self.tracks.pop(i)
                if len(matched) > i:
                    matched.pop(i)
            else:
                if self.tracks[i][2] >= DISPLAY_THRESHOLD:
                    active.append((self.tracks[i][0], self.tracks[i][1]))
                i += 1
        return active
