"""PyTorch port, the pitch extraction (kernel K10's module) against the JAX
package, on the CPU.

- The rounding forms: XLA folds JAX's `/ (1 + MAX_HARMONICS)` into a
  product with float32(1/15) and `jnp.log2(x)` into `log(x)` times
  float32(1/ln 2); `ops/pitch.py` spells both so (`_struct_mult`, `_log2`),
  and `csrc/extract.cu` uses the same constants.  struct_mult is bitwise
  JAX's on the whole (longest_run 0..14, total_harms 0..13) grid.
- `extract_pitches` against JAX's on scenes and edge frames (ties, more
  than 32 candidates, fewer than 8, silence, NaN and +inf magnitudes, the
  full-width debug layout): valid flags equal; frequencies within 8 ulp
  (torch's CPU log and XLA's differ in the last bit on ~2% of inputs and
  the parabola's interpolation can amplify that); scores within 2 ulp and
  bitwise on >= 90% of valid notes (the same log differences, through
  log2(0.5 + score)).
- K10's algorithm, transcribed to numpy step for step (one-warp blocks
  taking every grid-th frame through one frame buffer, the peak scan's pm row
  and bin-ordered list, a lane a peak for the comb, scores over the
  floors, candidates compacted in place, ranks counted instead of a sort,
  the ghost test's pre-check, the dedup as 32 any-steps), bitwise to the
  plain `_extract` on a scene, NaN/+inf, a plateau at kc (every in-band
  bin a peak), noise, silence and NaN frames by turns, a ragged N and rows
  at an odd stride.
- The wrapper's checks, and K1's split rule (`hopper_stft.split_count`).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu.ops import pitch as jpitch
from audio_analyzer_rs_tpu.ops.stft import stft_mags_np
from audio_analyzer_rs_tpu_torch import _build
from audio_analyzer_rs_tpu_torch.ops import hopper_extract, hopper_stft
from audio_analyzer_rs_tpu_torch.ops import pitch as tpitch

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
BIN_W = float(np.float32(SR) / np.float32(2048))
KC = tpitch.candidate_band(BIN_W, HALF)
MIN_BIN, MAX_BIN = tpitch._bins(BIN_W, HALF, tpitch.MIN_FREQ, tpitch.MAX_FREQ)
FREQ_ULP = 8
SCORE_ULP = 2
CSRC = Path(_build.__file__).resolve().parent / "csrc"


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _compare(mags, floor, true_half=HALF, min_valid=0):
    """The port's extract_pitches against JAX's on the same frames."""
    ref = jpitch.extract_pitches(jnp.asarray(mags), jnp.asarray(floor), BIN_W,
                                 true_half=true_half)
    got = tpitch.extract_pitches(torch.from_numpy(mags),
                                 torch.from_numpy(floor), BIN_W,
                                 true_half=true_half)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert int(valid.sum()) >= min_valid
    assert _ulps(got.freqs.numpy()[valid],
                 np.asarray(ref.freqs)[valid]).max(initial=0) <= FREQ_ULP
    du = _ulps(got.scores.numpy()[valid], np.asarray(ref.scores)[valid])
    assert du.max(initial=0) <= SCORE_ULP
    if du.size:
        assert float((du == 0).mean()) >= 0.9, float((du == 0).mean())
    return got, valid


def _band(x, floor_db=-70.0):
    mags = stft_mags_np(x).astype(np.float32)
    gf = np.full(mags.shape[0], jnf.global_floor_linear(floor_db, HALF),
                 np.float32)
    _, eff = jnf.noise_floor_scan(jnf.init_state(HALF), jnp.asarray(mags),
                                  jnp.asarray(gf), KC)
    return np.ascontiguousarray(mags[:, :KC + 1]), np.array(eff)


@pytest.fixture(scope="module")
def scene():
    return _band(np.concatenate([
        gen.tone_with_harmonics(196.0, 0.3, SR, harmonics=10, amplitude=0.4),
        gen.mixed_scene(1.5, SR, seed=5)]))


def _random_frames(seed, n=48):
    rng = np.random.default_rng(seed)
    mags = rng.exponential(1.0, (n, KC + 1)).astype(np.float32)
    return mags, np.full((n, KC), 0.3, np.float32)


# ── The rounding forms ───────────────────────────────────────────────────

def test_struct_mult_is_bitwise_jax_on_the_grid():
    run = np.repeat(np.arange(15), 14).astype(np.int32)
    tot = np.tile(np.arange(14), 15).astype(np.int32)
    ref = np.asarray(jax.jit(lambda r, t: (
        1.0 + r.astype(jnp.float32) + t.astype(jnp.float32) / 2.0)
        / (1.0 + jpitch.MAX_HARMONICS))(run, tot))
    got = tpitch._struct_mult(torch.from_numpy(run),
                              torch.from_numpy(tot)).numpy()
    assert got.dtype == np.float32 and got.shape == (210,)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # The IEEE quotient, which torch's CPU gave before, is not JAX's.
    ieee = ((1.0 + torch.from_numpy(run).float()
             + torch.from_numpy(tot).float() / 2.0) / 15.0).numpy()
    assert int((ieee.view(np.int32) != ref.view(np.int32)).sum()) == 123


def test_log2_is_xlas_log_times_a_constant():
    hlo = jax.jit(jnp.log2).lower(jnp.ones(8, jnp.float32)).compile() \
        .as_text()
    consts = [float(np.float32(c))
              for c in re.findall(r"constant\(([0-9.e+-]+)\)", hlo)]
    assert tpitch.LOG2_E in consts
    x = np.random.default_rng(1).uniform(0.5, 60.0, 4096).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log2)(x))
    form = np.asarray(jax.jit(lambda v: jnp.log(v) * np.float32(
        tpitch.LOG2_E))(x))
    np.testing.assert_array_equal(form.view(np.int32), ref.view(np.int32))
    # What is left is torch's CPU log against XLA's (~4% of inputs a last
    # bit apart, 2 ulp after the product); torch.log2 was further off.
    du = _ulps(tpitch._log2(torch.from_numpy(x)).numpy(), ref)
    assert du.max() <= 2 and float((du == 0).mean()) >= 0.95
    old = _ulps(torch.log2(torch.from_numpy(x)).numpy(), ref)
    assert float((old == 0).mean()) < 0.8


def test_kernel_constants_are_the_plain_versions():
    src = (CSRC / "extract.cu").read_text()
    lits = dict(re.findall(r"constexpr float (\w+) = (0x[0-9a-fp.+-]+)f;",
                           src))
    assert float.fromhex(lits["LOG2_E"]) == tpitch.LOG2_E
    assert float.fromhex(lits["RECIP_15"]) == tpitch.RECIP_HARMONICS
    assert tpitch.RECIP_HARMONICS == float(np.float32(1) / np.float32(15))
    assert re.search(r"constexpr int TOP_K = (\d+);", src).group(1) == \
        str(tpitch.TOP_K)
    assert '#include "comb.cuh"' in src
    assert '#include "comb.cuh"' in (CSRC / "comb.cu").read_text()


# ── extract_pitches against JAX ──────────────────────────────────────────

def test_scene_scores_match_jax(scene):
    _compare(*scene, min_valid=20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_frames_with_many_candidates_match_jax(seed):
    mags, floor = _random_frames(seed)
    got, valid = _compare(mags, floor, min_valid=100)
    assert (valid.sum(1) >= 2).all() and (valid.sum(1) == 8).any()
    # More than 32 peaks a frame: the top-32 cut is exercised.
    m, f = torch.from_numpy(mags), torch.from_numpy(floor)
    pm, frac, m_c, peak, _ = tpitch._pre_comb(m, f, MIN_BIN, MAX_BIN, KC)
    assert int(peak.sum(1).min()) > 32


def test_tie_heavy_frames_match_jax():
    mags = np.full((8, KC + 1), 1e-3, np.float32)
    for k in range(30, 460, 7):          # 62 equal isolated peaks
        mags[:, k] = 1.0
    mags[1::2, 100] = 1.0                # pairs of equal neighbours
    mags[1::2, 101] = 1.0
    floor = np.full((8, KC), 1e-4, np.float32)
    got, valid = _compare(mags, floor, min_valid=8)
    assert (valid.sum(1) == tpitch.MAX_NOTES).all()


def test_fewer_than_eight_notes_match_jax():
    x = gen.tone_with_harmonics(330.0, 0.2, SR, harmonics=4, amplitude=0.4)
    mags, floor = _band(x)
    got, valid = _compare(mags, floor, min_valid=1)
    assert (valid.sum(1) < tpitch.MAX_NOTES).all()


def test_silent_and_zero_frames_match_jax():
    mags, floor = _random_frames(3, 8)
    mags[:4] = 0.0                                  # digital silence
    mags[4:] = 1e-6                                 # flat, under the floor
    got, valid = _compare(mags, floor)
    assert not valid.any()
    assert not got.freqs.numpy().any() and not got.scores.numpy().any()


def test_nan_and_inf_magnitudes_match_jax():
    mags, floor = _random_frames(4, 24)
    mags[::4, 100] = np.nan
    mags[1::4, 200] = np.inf
    mags[2::4, 50:60] = 0.0                         # zero neighbours
    mags[3::4, 300] = np.inf
    mags[3::4, 150] = np.nan
    _compare(mags, floor, min_valid=50)


def test_full_width_debug_layout_matches_jax():
    x = np.concatenate([gen.mixed_scene(0.5, SR, seed=9),
                        gen.tone_with_harmonics(440.0, 0.2, SR, harmonics=6,
                                                amplitude=0.3)])
    mags = stft_mags_np(x).astype(np.float32)       # [N, 1025]
    gf = np.full(mags.shape[0], jnf.global_floor_linear(-70.0, HALF),
                 np.float32)
    _, eff = jnf.noise_floor_scan(jnf.init_state(HALF), jnp.asarray(mags),
                                  jnp.asarray(gf), None)
    _compare(mags, np.array(eff), true_half=None, min_valid=5)


# ── K10's algorithm against the plain extraction ─────────────────────────

def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def _interpolate(m, y, k, staged):
    """csrc/extract.cu `interpolate`: peak k's fractional bin and whether
    it is degenerate.  `y` holds the staged row's logs (torch.log over the
    row, as the plain version takes them); the three magnitudes it reads
    must still be the staged ones."""
    f32 = np.float32
    assert _bits_equal(m[k - 1:k + 2], staged[k - 1:k + 2]), k
    denom = (y[k - 1] - f32(2) * y[k]) + y[k + 1]
    q = (f32(0.5) * (y[k - 1] - y[k + 1])) / denom
    q = q if np.isnan(q) else min(max(q, f32(-1)), f32(1))
    delta = f32(0) if abs(denom) < f32(1e-30) else q
    degenerate = not np.isfinite(delta)
    return f32(k) + (f32(0) if degenerate else delta), degenerate


def _comb_row(pm, fr, fund, k, half, max_bin):
    """comb.cuh `comb_candidate` in float32 numpy: the clipped window of at
    most 4 bins, scanned ascending with a strict `>`."""
    f32 = np.float32
    score, last, longest, current, total = fund, k, 0, 0, 0
    for h in range(2, tpitch.MAX_HARMONICS + 1):
        e = fr * f32(h)
        if not e < f32(half) or h * (k - 1) > max_bin:
            break
        lo = max(int(np.floor(e + f32(-1))), last + 1, h * k - h - 1, 0)
        hi = min(int(np.ceil(e + f32(1))), h * k + h + 1, max_bin - 1)
        best, best_pos = f32(0), 0
        for p in range(lo, lo + 4):
            if p <= hi and pm[p] > best:
                best, best_pos = pm[p], p
        if best > 0:
            score, last = score + best, best_pos
            current, total = current + 1, total + 1
        else:
            longest, current = max(longest, current), 0
    return score, max(longest, current), total


def _k10_numpy(mags, floor, bin_width=BIN_W, half=HALF,
               min_freq=tpitch.MIN_FREQ, max_freq=tpitch.MAX_FREQ, grid=3):
    """csrc/extract.cu step for step in float32 numpy: `grid` persistent
    one-warp blocks, block b taking frames b, b + grid, ..., each through
    one frame buffer; a frame's pm row and bin-ordered peak list (a lane a
    bin, a ballot a word), then a lane a peak (peak p on lane p % 32) for
    the gates, the logs and the comb over pm, the score written over the
    peak's floor; then the max, the candidates compacted in place (scores
    over the floors, fractional bins over the magnitudes, 32 at a time,
    each chunk read before it is written), the counted ranks, the next
    frame's rows copied over the buffer, and the ghosts, the dedup and the
    outputs from the top 32 alone."""
    f32 = np.float32
    min_bin, max_bin = tpitch._bins(bin_width, half, min_freq, max_freq)
    kc = min(half - 1, max(max_bin, tpitch.TOP_K))
    n = mags.shape[0]
    out_f = np.zeros((n, 8), f32)
    out_s = np.zeros((n, 8), f32)
    out_v = np.zeros((n, 8), bool)

    def stage(f, m, fl):
        m[:] = mags[f, :kc + 1]
        fl[:] = floor[f, :kc]

    def work(f, m, fl, stage_next):
        staged = m.copy()
        logs = torch.log(torch.from_numpy(staged)).numpy()
        # Peaks: a lane a bin, a ballot a word; pm and the list.
        pm = np.zeros(kc, f32)
        pk = []
        for base in range(0, kc, 32):
            for lane in range(32):
                k = base + lane
                if (min_bin + 1 <= k < max_bin and m[k] > fl[k]
                        and m[k] >= m[max(k - 1, 0)] and m[k] >= m[k + 1]):
                    pm[k] = m[k]
                    pk.append(k)
        # A lane a peak: lane l takes peaks l, l + 32, ...
        for lane in range(32):
            for p in range(lane, len(pk), 32):
                k = pk[p]
                fund, nf = m[k], fl[k]
                s = f32(0)
                # Under 5x its floor a peak scores 0: no logs.
                fr, degenerate = (
                    (f32(0), True) if fund < nf * f32(5)
                    else _interpolate(m, logs, k, staged))
                if not degenerate:
                    sc, run, tot = _comb_row(pm, fr, fund, k, half, max_bin)
                    if not (run < 3 and fund < f32(15) * nf):
                        log_score = (torch.log(torch.from_numpy(
                            np.array([f32(0.5) + sc]))).numpy()[0]
                            * f32(tpitch.LOG2_E))
                        sm = ((f32(1) + f32(run)) + f32(tot) * f32(0.5)) \
                            * f32(tpitch.RECIP_HARMONICS)
                        s = log_score * sm
                fl[k] = s
        # The max, the candidates and the ranks.
        ps = np.array([fl[k] for k in pk], f32)
        mx = f32(0) if not len(ps) else (
            f32(np.nan) if np.isnan(ps).any() else max(f32(0), ps.max()))
        cutoff = mx * f32(0.5)
        nc = 0
        for base in range(0, len(pk), 32):
            chunk = []
            for p in range(base, min(base + 32, len(pk))):
                k = pk[p]
                s = fl[k]
                if mx > 0 and s >= cutoff:
                    chunk.append((s, _interpolate(m, logs, k, staged)[0]))
            for s, fr in chunk:                 # written after the reads
                fl[nc], m[nc] = s, fr
                nc += 1
        cs, cf = fl[:nc].copy(), m[:nc].copy()
        idx = np.arange(nc)
        rank = ((cs[None, :] > cs[:, None]).sum(1)
                + ((cs[None, :] == cs[:, None])
                   & (idx[None, :] < idx[:, None])).sum(1))
        top_s = np.zeros(32, f32)
        top_f = np.zeros(32, f32)
        for c in range(nc):
            if rank[c] < 32:
                top_s[rank[c]], top_f[rank[c]] = cs[c], cf[c]
        # The buffer is read no more: the next frame's rows over it, then
        # the ghosts, the dedup and the outputs from the top 32.
        stage_next()
        ntop = min(nc, 32)
        cfreq = top_f * f32(bin_width)
        cvalid = np.zeros(32, bool)
        for a in range(ntop):
            ghost = False
            for b in range(ntop):
                den = max(cfreq[b], f32(1e-30))
                # The kernel's pre-check: outside (1.9, 5.2) x den the
                # ratio cannot pass, and the divisions are skipped.
                if (a == b or not top_s[a] < top_s[b] * f32(1.05)
                        or not den * f32(1.9) < cfreq[a] < den * f32(5.2)):
                    continue
                ratio = cfreq[a] / den
                near = np.rint(ratio)
                if (2 <= near <= 5
                        and abs(ratio / max(near, f32(1e-30)) - f32(1))
                        < f32(0.03)):
                    ghost = True
            cvalid[a] = not ghost
        kept = np.zeros(32, bool)
        for a in range(ntop):
            kept[a] = cvalid[a] and not any(
                kept[b] and abs(top_f[b] - top_f[a]) < f32(2)
                for b in range(32))
        slots = np.flatnonzero(kept)[:8]
        out_f[f, :len(slots)] = cfreq[slots]
        out_s[f, :len(slots)] = top_s[slots]
        out_v[f, :len(slots)] = ((cfreq[slots] >= f32(min_freq))
                                 & (cfreq[slots] <= f32(max_freq)))

    g = min(n, grid)
    seen = []
    with np.errstate(all="ignore"):
        for b in range(g):
            m, fl = np.empty(kc + 1, f32), np.empty(kc, f32)
            stage(b, m, fl)
            for f in range(b, n, g):
                nxt = f + g

                def stage_next():
                    if nxt < n:
                        stage(nxt, m, fl)
                work(f, m, fl, stage_next)
                seen.append(f)
    assert sorted(seen) == list(range(n))
    return out_f, out_s, out_v


def _k10_case(scene, case):
    """(mags, floors, grid) of a case the streamed design could get
    wrong."""
    mags, floor = _random_frames(6, 12)
    if case == "scene":
        return scene[0][::5], scene[1][::5], 3
    if case == "nan and inf":
        mags[0, 100] = np.nan
        mags[1, 200] = np.inf
        return mags, floor, 4
    if case == "plateau at kc":                    # every in-band bin a peak
        return (np.ones((2, KC + 1), np.float32),
                np.full((2, KC), 0.1, np.float32), 2)
    if case == "mixed frames":     # noise, silence, NaN and voiced frames
        m = np.concatenate([mags[:3], np.zeros((2, KC + 1), np.float32),
                            mags[3:5], scene[0][40:41], mags[5:8]])
        f = np.concatenate([floor[:3], floor[:2], floor[3:5],
                            scene[1][40:41], floor[5:8]])
        m[5, 77] = np.nan
        m[6, 300:302] = np.nan
        return m, f, 2
    if case == "more blocks than frames":      # a live slot's two frames
        return scene[0][10:12], scene[1][10:12], 3
    if case == "ragged n":     # 19 frames over 2 warps
        m = np.concatenate([scene[0][::9][:16], mags[:3]])
        f = np.concatenate([scene[1][::9][:16], floor[:3]])
        return m, f, 2
    if case == "odd stride":   # rows 2 kc + 3 floats apart, 4 bytes in
        wide = np.random.default_rng(6).exponential(
            0.01, (9, 2 * KC + 3)).astype(np.float32)
        wide[:, 1:KC + 2] = scene[0][20:29]
        return wide[:, 1:KC + 2], scene[1][20:29], 3
    raise ValueError(case)


@pytest.mark.parametrize("case", ["scene", "nan and inf", "plateau at kc",
                                  "mixed frames", "more blocks than frames",
                                  "ragged n", "odd stride"])
def test_k10_algorithm_is_bitwise_the_plain_extraction(scene, case):
    m, f, grid = _k10_case(scene, case)
    ref = hopper_extract.extract(
        torch.from_numpy(m), torch.from_numpy(f), BIN_W, MIN_BIN, MAX_BIN,
        tpitch.MIN_FREQ, tpitch.MAX_FREQ, HALF)
    got = _k10_numpy(m, f, grid=grid)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.view(np.uint8),
                                      r.numpy().view(np.uint8))
    assert ref.valid.any()
    if case == "plateau at kc":
        peak = tpitch._pre_comb(torch.from_numpy(m), torch.from_numpy(f),
                                MIN_BIN, MAX_BIN, KC)[3]
        assert int(peak.sum(1).min()) == MAX_BIN - MIN_BIN - 1
    if case == "odd stride":
        assert m.strides[0] == 4 * (2 * KC + 3)
        assert m.__array_interface__["data"][0] % 8 == 4


# ── The wrapper ──────────────────────────────────────────────────────────

def test_wrapper_takes_the_plain_version_on_cpu(scene):
    mags, floor = (torch.from_numpy(a[:16]) for a in scene)
    before = hopper_extract.LAUNCHES
    got = tpitch.extract_pitches(mags, floor, BIN_W, true_half=HALF)
    assert hopper_extract.LAUNCHES == before
    ref = tpitch._extract(mags, floor, BIN_W, MIN_BIN, MAX_BIN,
                          tpitch.MIN_FREQ, tpitch.MAX_FREQ, HALF)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    empty = tpitch.extract_pitches(mags[:0], floor[:0], BIN_W,
                                   true_half=HALF)
    assert all(a.shape == (0, 8) for a in empty)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    args = (BIN_W, MIN_BIN, MAX_BIN, tpitch.MIN_FREQ, tpitch.MAX_FREQ, HALF)
    mags = torch.ones((4, KC + 1))
    floor = torch.ones((4, KC))
    with pytest.raises(TypeError, match="float32"):
        hopper_extract.extract(mags.double(), floor, *args)
    with pytest.raises(ValueError, match=r"\[N, >= 465\]"):
        hopper_extract.extract(mags[:, :KC], floor, *args)
    with pytest.raises(ValueError, match=r"\[N, >= 464\]"):
        hopper_extract.extract(mags, floor[:3], *args)
    with pytest.raises(ValueError, match="unit stride"):
        hopper_extract.extract(torch.ones((KC + 1, 4)).T, floor, *args)
    with pytest.raises(ValueError, match="max_bin"):
        hopper_extract.extract(mags, floor, BIN_W, 1, 0, 24.0, 0.0, HALF)
    with pytest.raises(ValueError, match="unsupported device"):
        hopper_extract.extract(mags.to("meta"), floor.to("meta"), *args)
    # Rows are read through their stride: a wider tensor's band is taken.
    wide = torch.ones((4, 600))
    hopper_extract.extract(wide[:, :KC + 1], floor, *args)


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_text(src.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.headers()] == ["comb.cuh"]
    before = _build.library_path()
    (tmp_path / "comb.cuh").write_text(
        (tmp_path / "comb.cuh").read_text() + "\n// edited\n")
    assert _build.library_path() != before


# ── K1's split over the sample depth ─────────────────────────────────────

BANDED_COLS, FULL_COLS = 960, 2080      # 2 * 465 and 2 * 1025 padded to 160


@pytest.mark.parametrize("n,cols,splits", [
    (1, BANDED_COLS, 22), (2, BANDED_COLS, 22), (64, BANDED_COLS, 22),
    (66, BANDED_COLS, 22), (128, BANDED_COLS, 22), (129, BANDED_COLS, 11),
    (256, BANDED_COLS, 11), (257, BANDED_COLS, 1), (8192, BANDED_COLS, 1),
    (2, FULL_COLS, 10), (128, FULL_COLS, 10), (129, FULL_COLS, 1),
    (4096, FULL_COLS, 1)])
def test_k1_split_rule(n, cols, splits):
    """Split while the unsplit grid has at most 16 blocks (6 column tiles
    banded, 13 at full width, a tile 128 frames high)."""
    assert hopper_stft.split_count(n, cols, 2048, 132) == splits


@pytest.mark.parametrize("sms", [16, 78, 114, 132, 264])
@pytest.mark.parametrize("cols", [BANDED_COLS, FULL_COLS])
def test_k1_split_fills_the_card_once(sms, cols):
    """Every split block has a slice, and the grid is about one wave of
    the card (less than one more block a tile)."""
    slices = 2048 // hopper_stft.K_TILE
    for n in (1, 64, 65, 128):
        s = hopper_stft.split_count(n, cols, 2048, sms)
        per = -(-slices // s)
        assert 1 <= s <= slices and (s - 1) * per < slices
        tiles = cols // hopper_stft.COL_TILE       # one frame tile
        assert tiles * s < sms + tiles


def test_k1_split_is_the_plain_version_on_cpu():
    x = torch.from_numpy(gen.mixed_scene(0.3, SR, seed=2))
    frames = x[:3 * 512 + 2048].unfold(0, 2048, 512)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    trig = rdft_trig(2048, torch.device("cpu"))[:, :2 * (KC + 1)]
    win = hann(2048, torch.device("cpu"))
    before = hopper_stft.LAUNCHES
    ref = hopper_stft.dft_mag_plain(frames, trig, win)
    for splits in (None, 1, 22):
        got = hopper_stft._dft_mag(frames, trig, win, splits=splits)
        assert torch.equal(got, ref)
    assert hopper_stft.LAUNCHES == before
