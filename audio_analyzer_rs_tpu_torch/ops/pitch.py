"""Polyphonic pitch extraction: peaks → parabolic interp → harmonic comb
(port of audio_analyzer_rs_tpu/ops/pitch.py; ref src/audio_io/stft.rs:443-620).

Batched over frames: every stage works on [N, kc] candidate-band tensors.
`extract_pitches` runs the whole extraction as kernel K10 on CUDA tensors
(ops/hopper_extract.py) and the plain `_extract` below on CPU tensors.
`_extract` is plain torch on every device, its comb the plain `_comb`, so
on the card K10 is held against a reference that shares no code with it
(K2, ops/hopper_comb.py, keeps its own entry).  Top-K is a stable
descending sort, which breaks score ties toward the lower bin as
`lax.top_k` does.

Constants (ref stft.rs:452-453,536-543,594,606): MAX_HARMONICS=14,
MAX_NOTES=8, fund gate 5x floor, structure gate (longest_run<3 &&
fund<15x floor), cutoff 50% of max score, ghost ratios 2..5 at 3% tol / 5%
score margin, dedup separation 2.0 bins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hopper_extract

MAX_HARMONICS = 14
MAX_NOTES = 8
TOP_K = 32  # static candidate cap (see the JAX module)

MIN_FREQ = 24.0      # ref stft.rs:173
MAX_FREQ = 10_000.0  # ref stft.rs:174

_FRONT = MAX_HARMONICS + 2
# XLA folds JAX's divisions by constants into products with the float32
# reciprocal: `/ (1 + MAX_HARMONICS)` is `* float32(1/15)`, and jnp.log2(x)
# is `log(x) * float32(1/ln 2)`.  The port spells both the same way, so the
# CPU, the card and JAX round alike.  (PyTorch's CPU divides by a Python
# scalar in IEEE, its CUDA kernels multiply by the reciprocal.)
RECIP_HARMONICS = float(np.float32(1) / np.float32(1 + MAX_HARMONICS))
LOG2_E = float(np.float32(1) / np.log(np.float32(2)))


class PitchFrame(NamedTuple):
    freqs: torch.Tensor   # [N, MAX_NOTES] float32
    scores: torch.Tensor  # [N, MAX_NOTES] float32
    valid: torch.Tensor   # [N, MAX_NOTES] bool


def candidate_band(bin_width: float, half: int,
                   max_freq: float = MAX_FREQ) -> int:
    """Static width kc of the fundamental-candidate band."""
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    return min(half - 1, max(max_bin, TOP_K))


def _bins(bin_width: float, half: int, min_freq: float, max_freq: float):
    min_bin = max(int(np.ceil(min_freq / bin_width)), 1)
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    return min_bin, max_bin


def _pre_comb(mags: torch.Tensor, nf_c: torch.Tensor, min_bin: int,
              max_bin: int, kc: int):
    """Local peaks above the floor (ref stft.rs:461-469) + parabolic sub-bin
    interpolation in log magnitude (ref stft.rs:484-497), on [N, kc].
    Returns (pm, frac_c, m_c, is_peak, degenerate), each [N, kc]."""
    k_c = torch.arange(kc, dtype=torch.int32, device=mags.device)
    m_c = mags[:, :kc]
    m_l = torch.cat([m_c[:, :1], m_c[:, :-1]], 1)
    m_r = mags[:, 1:kc + 1]
    in_range = (k_c >= min_bin + 1) & (k_c < max_bin)
    is_peak = in_range & (m_c > nf_c) & (m_c >= m_l) & (m_c >= m_r)

    y = torch.log(m_c)
    y_l = torch.cat([y[:, :1], y[:, :-1]], 1)
    y_r = torch.log(m_r)
    denom = y_l - 2.0 * y + y_r
    delta = torch.where(denom.abs() < 1e-30, 0.0,
                        (0.5 * (y_l - y_r) / denom).clamp(-1.0, 1.0))
    # A peak beside an exactly-zero bin makes ln() give NaN; its score is
    # zeroed up front (see the JAX module).
    degenerate = ~torch.isfinite(delta)
    delta = torch.where(degenerate, 0.0, delta)
    frac_c = k_c.float() + delta
    pm = torch.where(is_peak, m_c, 0.0)
    return pm, frac_c, m_c, is_peak, degenerate


def _comb(pm: torch.Tensor, frac_c: torch.Tensor, fund_mag: torch.Tensor,
          half: int, max_bin: int | None = None):
    """The plain harmonic comb (ref stft.rs:499-545): a transcription of the
    JAX `_comb_xla`, batched over frames.  pm/frac_c/fund_mag [N, kc] →
    (score [N, kc] f32, longest_run [N, kc] i32, total_harms [N, kc] i32).

    Per harmonic n, only the matchable prefix kcn of candidates is computed
    (bounds (a) and (b) of the JAX module); candidates past it whose
    harmonic still exists take the miss branch (run reset).  Scores add in
    the reference's order; the offset scan is ascending with a strict `>`,
    so the first maximum wins."""
    n_frames, kc = pm.shape
    dev = pm.device
    if max_bin is None:
        max_bin = kc
    k_c = torch.arange(kc, dtype=torch.int32, device=dev)
    kcn_of = {n: min(kc, half // n + 2, max_bin // n + 3)
              for n in range(2, MAX_HARMONICS + 1)}
    pad_len = _FRONT + max(max(kcn_of[n] * n + n + 2
                               for n in range(2, MAX_HARMONICS + 1)), kc + 1)
    pm_pad = torch.zeros((n_frames, pad_len), dtype=torch.float32, device=dev)
    pm_pad[:, _FRONT:_FRONT + kc] = pm

    # Updated in place on fresh tensors, prefix by prefix.
    score = fund_mag.clone()
    last = k_c.expand(n_frames, kc).clone()
    longest_run = torch.zeros((n_frames, kc), dtype=torch.int32, device=dev)
    current_run = torch.zeros_like(longest_run)
    total_harms = torch.zeros_like(longest_run)
    for n in range(2, MAX_HARMONICS + 1):
        kcn = kcn_of[n]
        expected_f = frac_c[:, :kcn] * n
        valid_n = expected_f < half
        search_start = torch.maximum(
            torch.floor(expected_f - 1.0).to(torch.int32), last[:, :kcn] + 1)
        search_end = torch.clamp_max(
            torch.ceil(expected_f + 1.0).to(torch.int32), half - 1)
        nk = n * k_c[:kcn]
        best_mag = torch.zeros((n_frames, kcn), dtype=torch.float32,
                               device=dev)
        best_pos = torch.zeros((n_frames, kcn), dtype=torch.int32, device=dev)
        for c in range(-n - 1, n + 2):
            vals = pm_pad[:, _FRONT + c:_FRONT + c + kcn * n:n]
            pos = nk + c
            in_band = (pos >= search_start) & (pos <= search_end)
            v = torch.where(in_band, vals, 0.0)
            better = v > best_mag                       # strict: first wins
            best_mag = torch.where(better, v, best_mag)
            best_pos = torch.where(better, pos, best_pos)
        found = best_mag > 0.0
        found_eff = found & valid_n
        miss = ~found & valid_n

        cur = current_run[:, :kcn]
        score[:, :kcn] = score[:, :kcn] + torch.where(found_eff, best_mag, 0.0)
        last[:, :kcn] = torch.where(found_eff, best_pos, last[:, :kcn])
        longest_run[:, :kcn] = torch.where(
            miss, torch.maximum(longest_run[:, :kcn], cur),
            longest_run[:, :kcn])
        current_run[:, :kcn] = torch.where(
            found_eff, cur + 1, torch.where(miss, 0, cur))
        total_harms[:, :kcn] += found_eff.to(torch.int32)
        if kcn < kc:
            tail_miss = (k_c >= kcn) & (frac_c * n < half)
            longest_run = torch.where(
                tail_miss, torch.maximum(longest_run, current_run),
                longest_run)
            current_run = torch.where(tail_miss, 0, current_run)
    longest_run = torch.maximum(longest_run, current_run)
    return score, longest_run, total_harms


def _log2(x: torch.Tensor) -> torch.Tensor:
    """jnp.log2 as XLA computes it: log(x) times float32(1/ln 2)."""
    return torch.log(x) * LOG2_E


def _struct_mult(longest_run: torch.Tensor,
                 total_harms: torch.Tensor) -> torch.Tensor:
    """(1 + run + total/2) / 15 as XLA computes it: times float32(1/15)."""
    return ((1.0 + longest_run.float() + total_harms.float() / 2.0)
            * RECIP_HARMONICS)


def _extract(mags: torch.Tensor, noise_floor: torch.Tensor, bin_width: float,
             min_bin: int, max_bin: int, min_freq: float, max_freq: float,
             half: int) -> PitchFrame:
    """Frames [N, >=kc+1] mags and [N, >=kc] floors → up to 8 pitches each."""
    kc = min(half - 1, max(max_bin, TOP_K))
    nf_c = noise_floor[:, :kc]
    pm, frac_c, m_c, is_peak, degenerate = _pre_comb(mags, nf_c, min_bin,
                                                     max_bin, kc)
    fund_mag = m_c.contiguous()
    score, longest_run, total_harms = _comb(pm, frac_c, fund_mag, half,
                                            max_bin)

    # Gates (stft.rs:479-481,536-544).
    low_fund = fund_mag < nf_c * 5.0
    struct_fail = (longest_run < 3) & (fund_mag < 15.0 * nf_c)
    log_score = _log2(0.5 + score)
    struct_mult = _struct_mult(longest_run, total_harms)
    scores = torch.where(is_peak & ~low_fund & ~struct_fail & ~degenerate,
                         log_score * struct_mult, 0.0)

    # Cutoff at 50% of max (stft.rs:547-562).
    peak_scores = torch.where(is_peak, scores, 0.0)
    max_score = peak_scores.clamp_min(0.0).amax(-1, keepdim=True)
    cutoff = max_score * 0.5
    cand_mask = is_peak & (scores >= cutoff) & (max_score > 0.0)

    # Top-K by score, ties to the lower bin: a stable descending sort.
    ranked = torch.where(cand_mask, scores, float("-inf"))
    top_vals, top_idx = torch.sort(ranked, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :TOP_K], top_idx[:, :TOP_K]
    cvalid = top_vals > float("-inf")
    cfrac = torch.gather(frac_c, 1, top_idx)
    cfreq = cfrac * bin_width

    # Harmonic-ghost suppression (stft.rs:564-589).
    ratio = cfreq[:, :, None] / cfreq[:, None, :].clamp_min(1e-30)
    nearest = torch.round(ratio)
    eye = torch.eye(TOP_K, dtype=torch.bool, device=mags.device)
    ghost = (cvalid[:, :, None] & cvalid[:, None, :] & ~eye
             & (nearest >= 2.0) & (nearest <= 5.0)
             & ((ratio / nearest.clamp_min(1e-30) - 1.0).abs() < 0.03)
             & (top_vals[:, :, None] < top_vals[:, None, :] * 1.05))
    cvalid = cvalid & ~ghost.any(-1)

    # Greedy dedup by 2-bin separation, in score order (stft.rs:594-605).
    kept = torch.zeros_like(cvalid)
    for i in range(TOP_K):
        conflict = (kept & ((cfrac - cfrac[:, i:i + 1]).abs() < 2.0)).any(-1)
        kept[:, i] = cvalid[:, i] & ~conflict

    # The first MAX_NOTES kept, in score order (stft.rs:606-619).
    rank = torch.cumsum(kept.to(torch.int32), -1) - 1
    slot = torch.where(kept & (rank < MAX_NOTES), rank, MAX_NOTES).long()
    n_frames = mags.shape[0]

    def scatter(values, dtype):
        out = torch.zeros((n_frames, MAX_NOTES + 1), dtype=dtype,
                          device=mags.device)
        return out.scatter_(1, slot, values.to(dtype))[:, :MAX_NOTES] \
            .contiguous()
    out_freq = scatter(cfreq, torch.float32)
    out_score = scatter(top_vals, torch.float32)
    out_valid = scatter(kept, torch.bool)
    # Final frequency-range filter.
    out_valid = out_valid & (out_freq >= min_freq) & (out_freq <= max_freq)
    return PitchFrame(out_freq, out_score, out_valid)


def extract_pitches(mags: torch.Tensor, noise_floor: torch.Tensor,
                    bin_width: float, min_freq: float = MIN_FREQ,
                    max_freq: float = MAX_FREQ,
                    true_half: int | None = None) -> PitchFrame:
    """Batched pitch extraction: mags [N, H] (or [N, kc+1] banded, with
    `true_half` = the real W//2+1), floor [N, H] or [N, kc] →
    PitchFrame [N, 8]."""
    half = true_half if true_half is not None else mags.shape[-1]
    min_bin, max_bin = _bins(bin_width, half, min_freq, max_freq)
    return hopper_extract.extract(mags, noise_floor, bin_width, min_bin,
                                  max_bin, min_freq, max_freq, half)


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.

def extract_pitches_np(magnitudes: np.ndarray, noise_floor: np.ndarray,
                       bin_width: float, min_freq: float = MIN_FREQ,
                       max_freq: float = MAX_FREQ):
    """Loop-for-loop float32 transcription of stft.rs:443-620 for parity tests.

    Returns a list of (freq, score) like the Rust Vec.
    """
    half = len(magnitudes)
    magnitudes = magnitudes.astype(np.float32)
    noise_floor = noise_floor.astype(np.float32)
    min_bin = max(int(np.ceil(min_freq / bin_width)), 1)
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    if min_bin >= max_bin:
        return []

    is_peak = np.zeros(half, dtype=bool)
    peak_bins = []
    for k in range(min_bin + 1, max_bin):
        m = magnitudes[k]
        if m > noise_floor[k] and m >= magnitudes[k - 1] and m >= magnitudes[k + 1]:
            is_peak[k] = True
            peak_bins.append(k)
    if not peak_bins:
        return []

    scores = np.zeros(half, dtype=np.float32)
    frac_bins = np.zeros(half, dtype=np.float32)
    for k in peak_bins:
        fund_mag = magnitudes[k]
        if fund_mag < noise_floor[k] * 5.0:
            scores[k] = 0.0
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            y_l = np.log(magnitudes[k - 1])
            y_c = np.log(magnitudes[k])
            y_r = np.log(magnitudes[k + 1])
            denom = y_l - 2.0 * y_c + y_r
            delta = 0.0 if abs(denom) < 1e-30 else float(
                np.clip(0.5 * (y_l - y_r) / denom, -1.0, 1.0))
        if not np.isfinite(delta):
            # Zero-magnitude neighbor: the reference's NaN candidate is
            # dropped by the final freq filter; drop it here directly.
            scores[k] = 0.0
            continue
        frac_bin = np.float32(k + delta)
        frac_bins[k] = frac_bin
        score = np.float32(fund_mag)
        last = k
        longest_run = current_run = total_harms = 0
        for n in range(2, MAX_HARMONICS + 1):
            expected_f = frac_bin * n
            if expected_f >= half:
                break
            search_start = max(int(np.floor(expected_f - 1.0)) if expected_f >= 1.0 else 0,
                               last + 1)
            search_end = min(int(np.ceil(expected_f + 1.0)), half - 1)
            best_hbin, best_mag = 0, np.float32(0.0)
            for h in range(search_start, search_end + 1):
                if is_peak[h] and magnitudes[h] > best_mag:
                    best_mag = magnitudes[h]
                    best_hbin = h
            if best_hbin != 0:
                score = np.float32(score + best_mag)
                last = best_hbin
                current_run += 1
                total_harms += 1
            else:
                longest_run = max(longest_run, current_run)
                current_run = 0
        longest_run = max(longest_run, current_run)
        if longest_run < 3 and fund_mag < 15.0 * noise_floor[k]:
            scores[k] = 0.0
        else:
            log_score = np.float32(np.log2(np.float32(0.5) + score))
            struct_mult = np.float32(
                (1.0 + longest_run + total_harms / 2.0) / (1.0 + MAX_HARMONICS))
            scores[k] = np.float32(log_score * struct_mult)

    max_score = max((scores[kk] for kk in peak_bins), default=0.0)
    max_score = np.float32(max(max_score, 0.0))
    if max_score == 0.0:
        return []
    cutoff = np.float32(max_score * np.float32(0.5))
    candidates = [(kk, scores[kk]) for kk in peak_bins if scores[kk] >= cutoff]

    def freq_of(b):
        return np.float32(frac_bins[b] * np.float32(bin_width))

    suppressed = []
    for i, (bin_i, score_i) in enumerate(candidates):
        fi = freq_of(bin_i)
        sup = False
        for j, (bin_j, score_j) in enumerate(candidates):
            if i == j:
                continue
            fj = freq_of(bin_j)
            ratio = fi / fj
            nearest = np.round(ratio)
            if (2.0 <= nearest <= 5.0
                    and abs(ratio / nearest - 1.0) < 0.03
                    and score_i < score_j * np.float32(1.05)):
                sup = True
                break
        suppressed.append(sup)
    candidates = [c for c, s in zip(candidates, suppressed) if not s]
    # Stable sort desc by (score, then lower bin — to match top_k tie order).
    candidates.sort(key=lambda c: (-c[1], c[0]))

    deduped = []
    for cand in candidates:
        fi = frac_bins[cand[0]]
        if not any(abs(fi - frac_bins[b]) < 2.0 for b, _ in deduped):
            deduped.append(cand)
    deduped = deduped[:MAX_NOTES]

    out = []
    for b, s in deduped:
        f = freq_of(b)
        if min_freq <= f <= max_freq:
            out.append((float(f), float(s)))
    return out
