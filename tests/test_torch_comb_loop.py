"""Kernel K2's per-candidate loop (csrc/comb.cu), transcribed to numpy,
against the plain comb `pitch._comb`: bitwise in score, longest_run and
total_harms, for every candidate.

The transcription runs the kernel's loop for all candidates in lockstep
(numpy arrays over [frames, kc] in place of lanes).  For harmonic n it
scans only the window clipped to
  [max(floor(e-1), last+1, n*k-n-1, 0), min(ceil(e+1), n*k+n+1, max_bin-1)]
ascending with a strict `>` in a fixed 4-step scan (the window holds at
most 4 bins, which the test checks); an empty window is a miss with no
read; a candidate stops at its first harmonic with e >= half or with
n*(k-1) > max_bin (a window past max_bin).  Equality on real spectra and
on edge rows shows the restructure is output-identical.

`edge_rows` is shared with the card test (tests/test_torch_kernels_cuda.py),
which holds the kernel to the plain comb on the same rows.
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import noisefloor, pitch
from audio_analyzer_rs_tpu_torch.ops.stft import stft_mags_np

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
BIN_W = float(np.float32(SR) / np.float32(2048))
KC = pitch.candidate_band(BIN_W, HALF)
MIN_BIN, MAX_BIN = pitch._bins(BIN_W, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)


def comb_loop_np(pm, frac, fund, half, max_bin):
    """K2's loop on float32 [N, kc] arrays → (score, longest_run,
    total_harms, widest window read).  Arithmetic is float32 as in the
    kernel (numpy rounds each product and sum to nearest)."""
    nf, kc = pm.shape
    k = np.broadcast_to(np.arange(kc, dtype=np.int64), (nf, kc))
    frame = np.arange(nf)[:, None]
    score = fund.astype(np.float32).copy()
    last = k.copy()
    longest = np.zeros((nf, kc), np.int32)
    current = np.zeros((nf, kc), np.int32)
    total = np.zeros((nf, kc), np.int32)
    live = np.ones((nf, kc), bool)
    widest = 0
    for h in range(2, pitch.MAX_HARMONICS + 1):
        e = frac * np.float32(h)
        live &= (e < half) & (h * (k - 1) <= max_bin)   # the kernel's break
        e = np.where(live, e, np.float32(0))
        lo = np.maximum.reduce([
            np.floor(e - np.float32(1)).astype(np.int64), last + 1,
            h * k - h - 1, np.zeros_like(k)])
        hi = np.minimum.reduce([
            np.ceil(e + np.float32(1)).astype(np.int64), h * k + h + 1,
            np.full_like(k, max_bin - 1)])
        hi = np.where(live, hi, lo - 1)   # a stopped candidate reads nothing
        widest = max(widest, int((hi - lo + 1).max()))
        best = np.zeros((nf, kc), np.float32)
        best_pos = np.zeros((nf, kc), np.int64)
        for j in range(4):                # the kernel's fixed 4-step scan
            p = lo + j
            reading = p <= hi
            v = pm[frame, np.clip(p, 0, kc - 1)]
            better = reading & (v > best)     # strict: the first max wins
            best = np.where(better, v, best)
            best_pos = np.where(better, p, best_pos)
        found = live & (best > 0)
        miss = live & ~(best > 0)
        score = np.where(found, score + best, score)
        last = np.where(found, best_pos, last)
        longest = np.where(miss, np.maximum(longest, current), longest)
        current = np.where(found, current + 1, np.where(miss, 0, current))
        total = total + found
    return score, np.maximum(longest, current), total, widest


def edge_rows(kc=KC, max_bin=MAX_BIN, min_bin=MIN_BIN, seed=5):
    """pm, frac_c, fund_mag [6, kc] float32 rows at the comb's edges: an
    all-zero frame; a peak at max_bin - 1 with integer e; random peaks with
    integer e; random peaks with fractional e and frac <= 0 at k = 0; equal
    neighbouring peaks; peaks at the band's ends.  Every row has candidates
    whose harmonics cross half (k >= 74 at 44.1 kHz / 2048)."""
    rng = np.random.default_rng(seed)
    k = np.arange(kc, dtype=np.float32)
    pm = np.zeros((6, kc), np.float32)
    frac = np.tile(k, (6, 1))
    fund = rng.uniform(0.0, 1.0, (6, kc)).astype(np.float32)
    fund[0] = 0.0
    pm[1, max_bin - 1] = 2.0
    pm[1, (max_bin - 1) // 2] = 1.5
    for r in (2, 3, 4):
        at = rng.choice(np.arange(min_bin + 1, max_bin), 40, replace=False)
        pm[r, at] = rng.uniform(0.1, 3.0, 40).astype(np.float32)
    frac[3] += rng.uniform(-1.0, 1.0, kc).astype(np.float32)
    frac[3, 0] = -0.75
    frac[4] += rng.uniform(-0.5, 0.5, kc).astype(np.float32)
    ties = rng.choice(np.arange(min_bin + 1, max_bin - 1), 20, replace=False)
    pm[4, ties] = pm[4, ties + 1] = 1.25
    # A tie inside one window: candidate 1's harmonic 2 sees bins 2 and 3;
    # taking bin 3 (the last maximum) would leave harmonic 3 only bin 4.
    pm[4, 2:5] = [1.25, 1.25, 0.0]
    frac[4, 1] = 1.0
    pm[5, [min_bin + 1, max_bin - 2, max_bin - 1]] = [0.5, 0.75, 0.75]
    frac[5, 0] = 0.0
    frac[5, 1:] += np.float32(0.5)
    return pm, frac, fund


@pytest.fixture(scope="module")
def spectra_pre():
    """pm, frac_c, fund_mag of real spectra (harmonic tones and a mixed
    scene, the signals of test_torch_pitch.py's fixture) through the port's
    floor scan and `_pre_comb`."""
    x = np.concatenate([
        gen.tone_with_harmonics(220.0, 0.4, SR, harmonics=10, amplitude=0.4),
        gen.tone_with_harmonics(523.25, 0.4, SR, harmonics=6, amplitude=0.3),
        gen.mixed_scene(3.0, SR, seed=7),
    ])
    mags = torch.from_numpy(stft_mags_np(x).astype(np.float32)[:, :KC + 1])
    gf = torch.full((1, mags.shape[0]),
                    float(noisefloor.global_floor_linear(-70.0, HALF)))
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, "cpu", (1,)), mags[None], gf, KC)
    pm, frac, m_c, _, _ = pitch._pre_comb(mags, eff[0], MIN_BIN, MAX_BIN, KC)
    return pm.numpy(), frac.numpy(), m_c.contiguous().numpy()


def _assert_loop_matches_plain(pm, frac, fund):
    *got, widest = comb_loop_np(pm, frac, fund, HALF, MAX_BIN)
    ref = pitch._comb(torch.from_numpy(pm), torch.from_numpy(frac),
                      torch.from_numpy(fund), HALF, MAX_BIN)
    for name, g, r in zip(("score", "longest_run", "total_harms"), got, ref):
        np.testing.assert_array_equal(g, r.numpy(), err_msg=name)
    assert widest <= 4    # a window [floor(e-1), ceil(e+1)] holds <= 4 bins
    return got


def test_comb_loop_matches_plain_on_spectra(spectra_pre):
    _, _, total = _assert_loop_matches_plain(*spectra_pre)
    assert int(total.sum()) > 0            # harmonics were found


@pytest.mark.parametrize("row", range(6))
def test_comb_loop_matches_plain_on_edge_rows(row):
    pm, frac, fund = (a[row:row + 1] for a in edge_rows())
    score, run, total = _assert_loop_matches_plain(pm, frac, fund)
    if row == 0:
        assert not total.any() and not run.any()
        np.testing.assert_array_equal(score, fund)
