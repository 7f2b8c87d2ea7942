"""The port's Hopper kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`: each test skips (inside its fixture) when no CUDA device is
present.  On a machine with a card and no JAX, run them without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Small shapes of the main path's kinds; chip_smoke.py repeats the checks at
the full main-path shapes and times them.  K10 (the pitch extraction) is
bitwise to the plain `_extract` on the card at the main (8,192 frames),
live (2), pool (66), full-width and full-step (119,424) shapes and on
ties, NaN, +inf, silence, more than 32 candidates, a plateau making every
in-band bin a peak, noise, silence, NaN and voiced frames by turns, a
prime N and rows at an odd stride; `extract_pitches`
on CUDA tensors never runs the plain extraction.  K1 split over the
sample depth (1-256 frames banded, 1-128 at full width) is bitwise the
unsplit launch for every frame.  K6 (the reducer scan) and K7
(the dynamics scan) are bitwise to their plain versions at B = 1, 33, 128
and 129, from fresh and carried states, with NaN samples and digital
silence, K6 over T shorter than a tile and not a multiple of 4 and a hold
across tiles, K7 over one slot and 480-sample slots;
the full step launches K2-K7 once each and agrees with the CPU.  K5 (the
noise-floor scan) is bitwise to its plain version on every output and
every state leaf across the full width, tail included: at bands 426, 464
and 1,025 for S = 1, 33 and 128, at the full step's call (128 x 933
frames of 1,025-float rows, band 426, fresh and carried), and on the cases
its division shortcuts could break (tests/test_torch_noisefloor_kernel.py
`edge_cases`); with banded magnitudes and each stream's first frame at
full width it is bitwise its full-width call; no torch op runs after its
launch.  K11 (the "fft" magnitude) is bitwise to `rfft_mag_fixed_np`, its
operation order in numpy, on random, scene, silence-level and NaN/inf
frames, full width and banded with each row's first frame at full width,
in both its forms at every width, and a frame's bits do not depend on the
batch or the layout (1 to 2,064 frames, [C, 16] and [B, 933]); against
cuFFT (its plain version) within 1e-5 of each frame's peak.  Tolerances: K1 max |Δ| <= 1e-5 ·
max (3xTF32 on the tensor cores against cuBLAS FP32), and bitwise across
batch geometries; K2, K3, K4 and K5 bitwise (K3's, K4's and K5's floats as
bit patterns, so -0.0 and +0.0 differ).  K4 also past one wave of
blocks (S = SMs + 1, 2 SMs + 5 and 3 SMs streams, the SM count read from
the card) and at 2 and 256 bins (its two instantiations); it keeps >= 2
blocks on a SM at 129 bins, one at 256.

The live engine's shapes (one stream at 48 kHz: 1-3 pitch frames and 15-17
onset frames a slot, every state carried from call to call) and NaN input
(live audio can hold one) have tests of their own: with a NaN, every
kernel must put its NaNs where its plain version does, and agree bit for
bit (K1 within its tolerance) everywhere else.

The debug path (the devtools recorder) runs K1 and K5 over all 1,025
bins: K1 at full width within its tolerance of its plain version and, on
bins [0, kc], bit for bit the banded launch's; K5 continuing over all
bins from a state that ran banded, bitwise; `PitchAnalyzer` and the live
engine with a recorder keep the stable outputs and polls of those
without one, bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import (hopper_comb, hopper_extract,
                                             hopper_noisefloor, hopper_onset,
                                             hopper_rfft, hopper_stft,
                                             hopper_tracker, noisefloor,
                                             onset, pitch, tracker)
from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
from test_torch_comb_loop import edge_rows
from test_torch_tracker_select import _outside_state as outside_state
from test_torch_tracker_select import _random_raws as k3_random_raws
from test_torch_tracker_select import assert_same_bits
from test_torch_tracker_select import _bits as bits

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SR = 44100.0
W, HOP, HALF = 2048, 512, 1025
BIN_W = float(np.float32(SR) / np.float32(W))
KC = pitch.candidate_band(BIN_W, HALF)
MIN_BIN, MAX_BIN = pitch._bins(BIN_W, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)
# The live engine's rate.
SR48 = 48000.0
BIN_W48 = float(np.float32(SR48) / np.float32(W))
KC48 = pitch.candidate_band(BIN_W48, HALF)
MIN48, MAX48 = pitch._bins(BIN_W48, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def frames(dev):
    """[4 streams, 37 frames, 2048]: an unfold view over audio streams of a
    harmonic tone in a mixed scene."""
    x = torch.from_numpy(
        gen.tone_with_harmonics(220.0, 4.0, SR, harmonics=8, amplitude=0.4)
        + gen.mixed_scene(4.0, SR, seed=3)).to(dev)
    streams = torch.stack([x[i * 20000:i * 20000 + 36 * HOP + W]
                           for i in range(4)])
    return frame_signal(streams, W, HOP)


def test_k1_matches_plain(dev, frames):
    trig = rdft_trig(W, dev)[:, :2 * (KC + 1)]
    win = hann(W, dev)
    got = hopper_stft.dft_mag(frames, trig, win)
    ref = hopper_stft.dft_mag_plain(frames, trig, win)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (4, 37, KC + 1)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    # Geometry-independent: one frame alone gives the same bits.
    one = hopper_stft.dft_mag(frames[2, 5:6].contiguous(), trig, win)
    assert torch.equal(one[0], got[2, 5])


def test_k1_is_geometry_independent(dev):
    """The same frames give the same bits in batches of 1 to 257 frames
    starting at other tile rows, as [N, W] views, as a contiguous copy and
    as [S, F, W] views: the batches up to 256 frames take the split over
    the sample depth, the whole scene (686 frames) and 257 the unsplit
    launch."""
    x = torch.from_numpy(
        gen.mixed_scene(8.0, SR, seed=4)
        + gen.tone_with_harmonics(330.0, 8.0, SR, harmonics=6,
                                  amplitude=0.3)).to(dev)
    trig = rdft_trig(W, dev)[:, :2 * (KC + 1)]
    win = hann(W, dev)
    full = hopper_stft.dft_mag(frame_signal(x, W, HOP), trig, win)
    assert hopper_stft.split_count(full.shape[0], 960, W, 132) == 1
    starts = (0, 37, 200)
    for b in (1, 2, 63, 64, 65, 66, 127, 128, 129, 256, 257):
        for s in starts:
            view = frame_signal(x[s * HOP:(s + b - 1) * HOP + W], W, HOP)
            for frames in (view, view.contiguous()):
                got = hopper_stft.dft_mag(frames, trig, win)
                assert torch.equal(got, full[s:s + b]), (b, s)
        streams = torch.stack([x[s * HOP:(s + b - 1) * HOP + W]
                               for s in starts])
        got = hopper_stft.dft_mag(frame_signal(streams, W, HOP), trig, win)
        for i, s in enumerate(starts):
            assert torch.equal(got[i], full[s:s + b]), (b, s)
    ref = hopper_stft.dft_mag_plain(frame_signal(x, W, HOP), trig, win)
    assert float((full - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_k1_refuses_misaligned_views(dev):
    x = torch.zeros(40 * HOP + W, device=dev)
    trig = rdft_trig(W, dev)[:, :2 * (KC + 1)]
    win = hann(W, dev)
    with pytest.raises(ValueError, match="16-byte"):
        hopper_stft.dft_mag(frame_signal(x[1:], W, HOP), trig, win)
    with pytest.raises(ValueError, match="16-byte"):
        hopper_stft.dft_mag(frame_signal(x, W, HOP - 2), trig, win)
    streams = torch.zeros((3, 10 * HOP + W + 4), device=dev)[:, :-4]
    hopper_stft.dft_mag(frame_signal(streams, W, HOP), trig, win)
    odd = torch.zeros((3, 10 * HOP + W + 1), device=dev)[:, :-1]
    with pytest.raises(ValueError, match="16-byte"):
        hopper_stft.dft_mag(frame_signal(odd, W, HOP), trig, win)


def test_k2_edge_rows_bitwise(dev):
    pm, frac, fund = (torch.from_numpy(a).to(dev) for a in edge_rows())
    got = hopper_comb.comb(pm, frac, fund, HALF, MAX_BIN)
    ref = pitch._comb(pm, frac, fund, HALF, MAX_BIN)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_k2_matches_plain_bitwise(dev, frames):
    mags = hopper_stft.dft_mag(frames, rdft_trig(W, dev)[:, :2 * (KC + 1)],
                               hann(W, dev)).reshape(-1, KC + 1)
    floor = torch.full((mags.shape[0], KC), 1e-3, device=dev)
    pm, frac, m_c, _, _ = pitch._pre_comb(mags, floor, MIN_BIN, MAX_BIN, KC)
    m_c = m_c.contiguous()
    got = hopper_comb.comb(pm, frac, m_c, HALF, MAX_BIN)
    ref = pitch._comb(pm, frac, m_c, HALF, MAX_BIN)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[2].sum()) > 0


@functools.lru_cache(maxsize=1)
def _k10_scene(dev):
    """A 96 s mixed scene's K1 magnitudes and K5 floors on the card, banded
    ([8192, 465] and [8192, 464]) and, for its first 256 frames, at full
    width ([256, 1025] each); and the frames with a note (the scene has
    stretches of digital silence)."""
    x = torch.from_numpy(gen.mixed_scene(96.0, SR, seed=0)).to(dev)
    frames = frame_signal(x, W, HOP)[:8192]
    win = hann(W, dev)
    trig = rdft_trig(W, dev)
    gf = torch.full((1, 8192), float(noisefloor.global_floor_linear(
        -96.0, HALF)), device=dev)
    mags = hopper_stft.dft_mag(frames, trig[:, :2 * (KC + 1)], win)
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, dev, (1,)), mags[None], gf, KC)
    full = hopper_stft.dft_mag(frames[:256], trig, win)
    _, eff_full = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, dev, (1,)), full[None], gf[:, :256],
        None)
    voiced = pitch._extract(mags, eff[0], BIN_W, MIN_BIN, MAX_BIN,
                            pitch.MIN_FREQ, pitch.MAX_FREQ,
                            HALF).valid.any(1).nonzero()[:, 0]
    assert voiced.numel() > 1000
    return mags, eff[0], full, eff_full[0], voiced


def _k10_case(dev, case):
    mags, eff, full, eff_full, voiced = _k10_scene(dev)
    rng = np.random.default_rng(7)
    rnd = torch.from_numpy(rng.exponential(1.0, (128, KC + 1)).astype(
        np.float32)).to(dev)
    flat = torch.full((128, KC), 0.3, device=dev)
    if case == "main":
        return mags, eff
    if case == "live":
        at = int(voiced[500])
        return mags[at:at + 2], eff[at:at + 2]
    if case == "pool":
        rows = voiced[1000:1066]
        return mags[rows], eff[rows]
    if case == "full width":
        return full, eff_full
    if case == "full step":
        return mags.repeat(15, 1)[:119424], eff.repeat(15, 1)[:119424]
    if case == "empty":
        return mags[:0], eff[:0]
    if case == "strided":
        wide = torch.zeros((64, 600), device=dev)
        wide[:, :KC + 1] = mags[100:164]
        return wide[:, :KC + 1], eff[100:164]
    if case == "more than 32 candidates":
        return rnd, flat
    if case == "ties":
        ties = torch.full((16, KC + 1), 1e-3, device=dev)
        ties[:, 30:460:7] = 1.0
        ties[1::2, 100:102] = 1.0
        return ties, torch.full((16, KC), 1e-4, device=dev)
    if case == "nan, inf and silence":
        odd = rnd[:48].clone()
        odd[::4, 100] = float("nan")
        odd[1::4, 200] = float("inf")
        odd[2::4, 50:60] = 0.0
        odd[3::4] = 0.0
        return odd, flat[:48]
    if case == "plateau at kc":     # every in-band bin a peak
        return (torch.ones((4000, KC + 1), device=dev),
                torch.full((4000, KC), 0.1, device=dev))
    if case == "mixed frames":
        # Noise, silence, NaN and voiced frames by turns, 26,000 of them:
        # each warp streams ~10 of every kind.
        n = 26000
        rows = [rnd[:3], torch.zeros((2, KC + 1), device=dev), rnd[3:5],
                mags[voiced[:1]]]
        mixed = torch.cat(rows * (n // 8 + 1))[:n]
        mixed[5::8, 77] = float("nan")
        mixed[6::8, 300:302] = float("nan")
        fl = torch.cat([flat[:7], eff[voiced[:1]]] * (n // 8 + 1))[:n]
        return mixed, fl
    if case == "ragged n":          # a prime count of frames
        return mags[:4099], eff[:4099]
    if case == "odd stride":    # rows 2 kc + 3 floats apart, 4 bytes in
        wide = torch.zeros((64, 2 * KC + 3), device=dev)
        wide[:, 1:KC + 2] = mags[voiced[:64]]
        wide_f = torch.zeros((64, KC + 7), device=dev)
        wide_f[:, 3:KC + 3] = eff[voiced[:64]]
        return wide[:, 1:KC + 2], wide_f[:, 3:KC + 3]
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "main", "live", "pool", "full width", "full step", "empty", "strided",
    "more than 32 candidates", "ties", "nan, inf and silence",
    "plateau at kc", "mixed frames", "ragged n", "odd stride"])
def test_k10_matches_plain_bitwise(dev, case):
    """K10 against the plain `_extract` on the same inputs: freqs, scores
    (as bit patterns) and valid flags, every frame."""
    mags, floor = _k10_case(dev, case)
    args = (BIN_W, MIN_BIN, MAX_BIN, pitch.MIN_FREQ, pitch.MAX_FREQ, HALF)
    before = hopper_extract.LAUNCHES
    got = hopper_extract.extract(mags, floor, *args)
    ref = pitch._extract(mags, floor, *args)
    torch.cuda.synchronize()
    assert hopper_extract.LAUNCHES == before + (mags.shape[0] > 0)
    for name, g, r in zip(("freqs", "scores", "valid"), got, ref):
        assert g.shape == r.shape == (mags.shape[0], 8), name
        assert_same_bits(g, r, f"K10 {case} {name}")
    if case in ("main", "live", "pool", "full step",
                "more than 32 candidates", "ties", "nan, inf and silence",
                "plateau at kc", "mixed frames", "ragged n",
                "odd stride"):
        assert bool(ref.valid.any())
    if case == "odd stride":
        assert mags.stride(0) % 4 == 3 and mags.data_ptr() % 16 == 4


def test_extract_pitches_on_cuda_runs_no_plain_extraction(dev, monkeypatch):
    """`extract_pitches` and the pitch front on CUDA tensors: one K10 launch
    a call, and neither the plain extraction nor K2 nor a sort runs."""
    from audio_analyzer_rs_tpu_torch.models import analyzer

    def refuse(*args, **kwargs):
        raise AssertionError("the plain extraction ran on the card")
    mags, eff, _, _, voiced = _k10_scene(dev)
    mags, eff = mags[voiced[:64]], eff[voiced[:64]]
    for mod, name in ((pitch, "_extract"), (pitch, "_pre_comb"),
                      (hopper_comb, "comb"), (torch, "sort")):
        monkeypatch.setattr(mod, name, refuse)
    before = hopper_extract.LAUNCHES
    pf = pitch.extract_pitches(mags, eff, BIN_W, true_half=HALF)
    assert hopper_extract.LAUNCHES == before + 1 and bool(pf.valid.any())
    frames = frame_signal(_live_scene(dev, 2.0), W, HOP)[None, 40:45]
    nf = noisefloor.init_state(HALF, dev, (1,))
    gf = torch.full((1, 5), 0.002, device=dev)
    analyzer.pitch_extract_frames(nf, frames, gf, SR48)
    analyzer.pitch_extract_frames(nf, frames, gf, SR48, return_floor=True)
    assert hopper_extract.LAUNCHES == before + 3


@pytest.mark.parametrize("table", ["banded", "full"])
@pytest.mark.parametrize("n", [1, 2, 66, 127, 128, 129])
def test_k1_split_is_bitwise_the_unsplit_launch(dev, table, n):
    """K1 split over the sample depth (the rule's split and the split that
    fills the card) against the unsplit launch, every frame bit for bit."""
    x = torch.from_numpy(gen.mixed_scene(4.0, SR, seed=8)).to(dev)
    frames = frame_signal(x, W, HOP)[40:40 + n]
    trig = rdft_trig(W, dev)
    if table == "banded":
        trig = trig[:, :2 * (KC + 1)]
    win = hann(W, dev)
    cols_pad = hopper_stft._cached_split(trig)[1]
    one = hopper_stft._dft_mag(frames, trig, win, splits=1)
    for splits in (None, hopper_stft.fill_splits(n, cols_pad, W, 132), 64):
        got = hopper_stft._dft_mag(frames, trig, win, splits=splits)
        torch.cuda.synchronize()
        assert_same_bits(got, one, f"splits {splits}")
    assert float(one.max()) > 0


def _assert_k3_matches_plain(st0, raws):
    """K3 (scan + stable top-8 in one launch) against tracker_scan_plain +
    select_stable: outputs and final state, bit for bit."""
    st_k, out_k = hopper_tracker.tracker_scan(st0, *raws)
    st_p, emits = tracker.tracker_scan_plain(st0, *raws)
    out_p = tracker.select_stable(*emits)
    torch.cuda.synchronize()
    s, n = raws[3].shape
    assert all(o.shape == (s, n, 8) for o in out_k)
    for a, b in zip((*out_k, *st_k), (*out_p, *st_p)):
        assert_same_bits(a, b)
    return st_k, out_k


def _k3_raws(dev, s, n, seed=11, neg_zero=False):
    return tuple(torch.from_numpy(a).to(dev) for a in
                 k3_random_raws(np.random.default_rng(seed), s, n, neg_zero))


@pytest.mark.parametrize("s,n", [(3, 40), (37, 17)])
def test_k3_matches_plain_bitwise(dev, s, n):
    _, out_k = _assert_k3_matches_plain(tracker.init_state(dev, (s,)),
                                        _k3_raws(dev, s, n))
    assert bool(out_k[2].any())


@pytest.mark.parametrize("s,n", [(1, 4096), (133, 64), (5, 0), (4, 150)])
def test_k3_shapes_bitwise(dev, s, n):
    """One long stream (64 tiles), more streams than SMs, no frames, and a
    partial last tile."""
    launches = hopper_tracker.LAUNCHES
    _assert_k3_matches_plain(tracker.init_state(dev, (s,)),
                             _k3_raws(dev, s, n, seed=s + n))
    assert hopper_tracker.LAUNCHES == launches + 1


def test_k3_state_carry(dev):
    """A state carried across two calls gives the bits of one call."""
    s, n1, n2 = 6, 70, 90
    raws = _k3_raws(dev, s, n1 + n2, seed=4)
    st0 = tracker.init_state(dev, (s,))
    st_a, out_a = hopper_tracker.tracker_scan(
        st0, *(r[:, :n1].contiguous() for r in raws))
    st_b, out_b = _assert_k3_matches_plain(
        st_a, tuple(r[:, n1:].contiguous() for r in raws))
    st_f, out_f = hopper_tracker.tracker_scan(st0, *raws)
    torch.cuda.synchronize()
    for a, b, f in zip(out_a, out_b, out_f):
        assert_same_bits(torch.cat([a, b], 1), f)
    for b, f in zip(st_b, st_f):
        assert_same_bits(b, f)


def test_k3_negative_zero_and_outside_states(dev):
    """-0.0 raws, and states handed in that take the generic rounds."""
    _assert_k3_matches_plain(tracker.init_state(dev, (3,)),
                             _k3_raws(dev, 3, 90, seed=9, neg_zero=True))
    rng = np.random.default_rng(13)
    st = outside_state(rng, 4)
    raws = k3_random_raws(rng, 4, 80)
    raws[0][:, :3, :8] = st.freq[:, None, :8]
    _assert_k3_matches_plain(
        tracker.TrackerState(*(torch.from_numpy(a).to(dev) for a in st)),
        tuple(torch.from_numpy(a).to(dev) for a in raws))


def test_k3_batched_calls_no_plain_select(dev, monkeypatch):
    """On CUDA tensors tracker_scan_batched is the one fused launch."""
    raws = _k3_raws(dev, 8, 64)
    st0 = tracker.init_state(dev, (8,))
    want = tracker.tracker_scan_batched(st0, *raws)

    def refuse(*args):
        raise AssertionError("select_stable ran on the CUDA path")

    monkeypatch.setattr(tracker, "select_stable", refuse)
    launches = hopper_tracker.LAUNCHES
    got = tracker.tracker_scan_batched(st0, *raws)
    torch.cuda.synchronize()
    assert hopper_tracker.LAUNCHES == launches + 1
    for a, b in zip((*got[1], *got[0]), (*want[1], *want[0])):
        assert_same_bits(a, b)


def _k4_inputs(dev, s, n, seed=5, h=onset.HALF):
    """Random magnitudes with bursts, global floors, and sprinkled tick and
    hold frames: mags [S, N, H] (129 bins unless h says), the rest
    [S, N]."""
    rng = np.random.default_rng(seed)
    mags = (rng.random((s, n, h)) * 2.0).astype(np.float32)
    if n:
        hits = rng.random((s, n)) < 0.06
        mags[hits] *= rng.uniform(5.0, 40.0, (int(hits.sum()), 1)).astype(
            np.float32)
    gf = rng.uniform(0.01, 0.08, (s, n)).astype(np.float32)
    ts = rng.random((s, n)) < 0.03
    hold = rng.random((s, n)) < 0.03
    return tuple(torch.from_numpy(a).to(dev) for a in (mags, gf, ts, hold))


def _assert_k4_matches_plain(st0, inputs):
    """K4 against onset_scan_plain: every output and the final state, bit
    for bit."""
    st_k, out_k = hopper_onset.onset_scan(st0, *inputs)
    st_p, out_p = onset.onset_scan_plain(st0, *inputs)
    torch.cuda.synchronize()
    for name, a, b in zip(onset.OnsetFrameOut._fields, out_k, out_p):
        assert_same_bits(a, b, name)
    for name, a, b in zip(onset.OnsetState._fields, st_k, st_p):
        assert_same_bits(a, b, name)
    return st_k, out_k


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _streams(spec, sms: int) -> int:
    """S from a case: a number, or "sms+1", "2sms+5", "3sms" (multiples of
    the card's SM count and an offset)."""
    if isinstance(spec, int):
        return spec
    times, _, extra = spec.partition("+")
    return int(times[:-3] or 1) * sms + int(extra or 0)


@pytest.mark.parametrize("s,n", [(133, 150), (5, 0), (1, 4096), (3, 31),
                                 ("sms+1", 150), ("2sms+5", 150),
                                 ("3sms", 33)])
def test_k4_matches_plain_bitwise(dev, s, n):
    """More streams than SMs with a partial tile, no frames, one long
    stream, and less than one tile; then past one wave of blocks (one
    stream more than the SMs, two waves and more, three full waves of
    frames that are one tile and a frame)."""
    s = _streams(s, _sms(dev))
    launches = hopper_onset.LAUNCHES
    _, out = _assert_k4_matches_plain(
        onset.init_state(onset.HALF, dev, (s,)), _k4_inputs(dev, s, n, s + n))
    assert hopper_onset.LAUNCHES == launches + 1
    if n >= 150:
        assert bool(out.detected.any())


@pytest.mark.parametrize("h", [2, 256])
def test_k4_bin_widths(dev, h):
    """The fewest bins (the two-blocks-a-SM instantiation) and the most
    (one block a SM), past one wave with a partial tile, bitwise to the
    plain scan."""
    s = _sms(dev) + 1
    launches = hopper_onset.LAUNCHES
    _assert_k4_matches_plain(onset.init_state(h, dev, (s,)),
                             _k4_inputs(dev, s, 70, seed=h, h=h))
    assert hopper_onset.LAUNCHES == launches + 1
    assert h in hopper_onset.RESIDENT


def test_k4_resident_blocks(dev):
    """At 129 bins at least two blocks stay on a SM; at 256, one."""
    assert hopper_onset.resident_blocks(onset.HALF) >= 2
    assert hopper_onset.resident_blocks(256) == 1


def test_k4_state_carry(dev):
    """A state carried across two calls gives the bits of one call."""
    s, n1, n2 = 6, 70, 90
    inputs = _k4_inputs(dev, s, n1 + n2, seed=8)
    st0 = onset.init_state(onset.HALF, dev, (s,))
    st_a, out_a = hopper_onset.onset_scan(
        st0, *(x[:, :n1].contiguous() for x in inputs))
    st_b, out_b = _assert_k4_matches_plain(
        st_a, tuple(x[:, n1:].contiguous() for x in inputs))
    st_f, out_f = hopper_onset.onset_scan(st0, *inputs)
    torch.cuda.synchronize()
    for a, b, f in zip(out_a, out_b, out_f):
        assert_same_bits(torch.cat([a, b], 1), f)
    for b, f in zip(st_b, st_f):
        assert_same_bits(b, f)


def test_k4_real_magnitudes_bitwise(dev):
    """cuFFT magnitudes of a scene with clicks, as the onset path gives
    them."""
    x = gen.mixed_scene(6.0, SR, seed=2)
    click = gen.calibration_click(SR, volume=0.7)
    for t in (0.5, 1.7, 3.1, 4.4):
        x[int(t * SR):int(t * SR) + len(click)] += click
    streams = torch.from_numpy(x).to(dev).reshape(2, -1)
    frames = frame_signal(streams, onset.WINDOW, onset.HOP)
    mags = windowed_mags(frames, onset.WINDOW, "fft")
    s, n = mags.shape[:2]
    gf = torch.full((s, n), 0.0016, device=dev)
    no = torch.zeros((s, n), dtype=torch.bool, device=dev)
    _, out = _assert_k4_matches_plain(onset.init_state(onset.HALF, dev, (s,)),
                                      (mags, gf, no, no))
    assert bool(out.fired.any())


def test_onset_scan_cuda_runs_no_plain_step(dev, monkeypatch):
    """On CUDA tensors onset_scan is the one kernel launch."""
    inputs = _k4_inputs(dev, 4, 100)
    st0 = onset.init_state(onset.HALF, dev, (4,))
    want = onset.onset_scan_plain(st0, *inputs)

    def refuse(*args):
        raise AssertionError("the plain onset step ran on the CUDA path")

    monkeypatch.setattr(onset, "_step", refuse)
    launches = hopper_onset.LAUNCHES
    got = onset.onset_scan(st0, *inputs)
    torch.cuda.synchronize()
    assert hopper_onset.LAUNCHES == launches + 1
    for a, b in zip((*got[1], *got[0]), (*want[1], *want[0])):
        assert_same_bits(a, b)


def test_noise_floor_device_matches_cpu(dev, frames):
    """K5 on K1's magnitudes gives the bits of the plain floor recurrence on
    the CPU (its fused steps rounded once on both)."""
    mags = hopper_stft.dft_mag(frames, rdft_trig(W, dev)[:, :2 * (KC + 1)],
                               hann(W, dev))
    gf = torch.full(mags.shape[:2], 0.01, device=dev)
    launches = hopper_noisefloor.LAUNCHES
    st, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, dev, (4,)), mags, gf, KC)
    torch.cuda.synchronize()
    assert hopper_noisefloor.LAUNCHES == launches + 1
    st_cpu, eff_cpu = noisefloor.noise_floor_scan_plain(
        noisefloor.init_state(HALF, "cpu", (4,)), mags.cpu(), gf.cpu(), KC)
    assert_same_bits(eff, eff_cpu)
    for a, b in zip(st, st_cpu):
        assert_same_bits(a, b)


def _k5_inputs(dev, s, n, width, seed):
    """Spectrum-like magnitudes [S, N, width]: a noise bed, sustained
    partials with small jitter (the floor's held branch) and bursts; per-
    frame global floors [S, N]."""
    rng = np.random.default_rng(seed)
    mags = rng.exponential(0.02, (s, n, width)).astype(np.float32)
    held = rng.random((s, 1, width)) < 0.05
    level = rng.uniform(0.5, 20.0, (s, 1, width))
    jitter = 1.0 + 0.02 * rng.standard_normal((s, n, width))
    mags = np.where(held, level * jitter, mags).astype(np.float32)
    hits = rng.random((s, n, width)) < 0.01
    mags[hits] *= np.float32(50.0)
    gf = rng.uniform(1e-3, 0.05, (s, n)).astype(np.float32)
    return torch.from_numpy(mags).to(dev), torch.from_numpy(gf).to(dev)


def _k5_state(dev, s, seed):
    """A mid-stream state from outside: random floors, previous magnitudes
    and volatilities, every other stream uninitialized."""
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(rng.uniform(0.0, 2.0, (s, HALF)).astype(
        np.float32)).to(dev) for _ in range(3)]
    init = torch.from_numpy(np.arange(s) % 2 == 0).to(dev)
    return noisefloor.NoiseFloorState(*leaves, init)


def _assert_k5_matches_plain(st0, mags, gf, band):
    """K5 (through noise_floor_scan) against noise_floor_scan_plain on the
    card: the effective floors and the whole final state, bit for bit."""
    launches = hopper_noisefloor.LAUNCHES
    st_k, eff_k = noisefloor.noise_floor_scan(st0, mags, gf, band)
    st_p, eff_p = noisefloor.noise_floor_scan_plain(st0, mags, gf, band)
    torch.cuda.synchronize()
    assert hopper_noisefloor.LAUNCHES == launches + (mags.shape[-2] > 0)
    assert eff_k.shape == eff_p.shape
    assert_same_bits(eff_k, eff_p, "effective")
    for name, a, b in zip(noisefloor.NoiseFloorState._fields, st_k, st_p):
        assert_same_bits(a, b, name)
    return st_k, eff_k


@pytest.mark.parametrize("width,band", [(KC + 1, KC), (HALF, None),
                                        (HALF, KC)])
@pytest.mark.parametrize("s,n", [(128, 64), (1, 4096), (3, 0), (5, 31),
                                 (133, 64)])
def test_k5_matches_plain_bitwise(dev, s, n, width, band):
    """The segmented step, the sequential analyzer's chunk, no frames, less
    than one look-ahead group, more streams than SMs; banded magnitudes at
    band 464, full width, and full-width magnitudes at band 464 (the tail
    seeded); from fresh states and from a state handed in."""
    mags, gf = _k5_inputs(dev, s, n, width, seed=s + n + width)
    _assert_k5_matches_plain(noisefloor.init_state(HALF, dev, (s,)), mags,
                             gf, band)
    _assert_k5_matches_plain(_k5_state(dev, s, seed=n), mags, gf, band)


def test_k5_state_carry_and_unbatched(dev):
    """A state carried across two calls gives the bits of one call; an
    unbatched state [H] with mags [N, H'] takes the same kernel."""
    mags, gf = _k5_inputs(dev, 6, 150, KC + 1, seed=3)
    st0 = noisefloor.init_state(HALF, dev, (6,))
    st_a, eff_a = noisefloor.noise_floor_scan(
        st0, mags[:, :70].contiguous(), gf[:, :70].contiguous(), KC)
    st_b, eff_b = _assert_k5_matches_plain(
        st_a, mags[:, 70:].contiguous(), gf[:, 70:].contiguous(), KC)
    st_f, eff_f = noisefloor.noise_floor_scan(st0, mags, gf, KC)
    torch.cuda.synchronize()
    assert_same_bits(torch.cat([eff_a, eff_b], 1), eff_f)
    for b, f in zip(st_b, st_f):
        assert_same_bits(b, f)
    _assert_k5_matches_plain(noisefloor.init_state(HALF, dev), mags[2],
                             gf[2], KC)


def test_noise_floor_scan_cuda_runs_no_plain_step(dev, monkeypatch):
    """On CUDA tensors noise_floor_scan is the one kernel launch (the
    state above the band written by the kernel)."""
    mags, gf = _k5_inputs(dev, 4, 100, HALF, seed=9)
    st0 = noisefloor.init_state(HALF, dev, (4,))
    want = noisefloor.noise_floor_scan_plain(st0, mags, gf, KC)

    def refuse(*args):
        raise AssertionError("the plain floor step ran on the CUDA path")

    monkeypatch.setattr(noisefloor, "_step", refuse)
    launches = hopper_noisefloor.LAUNCHES
    got = noisefloor.noise_floor_scan(st0, mags, gf, KC)
    torch.cuda.synchronize()
    assert hopper_noisefloor.LAUNCHES == launches + 1
    for a, b in zip((got[1], *got[0]), (want[1], *want[0])):
        assert_same_bits(a, b)


def test_noise_floor_scan_cuda_runs_no_torch_op_after_the_launch(
        dev, monkeypatch):
    """On CUDA tensors no torch op follows K5's launch: `with_tail` does
    not run, and a dispatch mode sees nothing after the library call (the
    outputs are allocated before it).  Full-width magnitudes at band 426
    on fresh and initialized streams (the tail seeded and frozen)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from audio_analyzer_rs_tpu_torch import _build
    mags, gf = _k5_inputs(dev, 4, 50, HALF, seed=41)
    st0 = _k5_state(dev, 4, seed=42)
    want = noisefloor.noise_floor_scan_plain(st0, mags, gf, KC48)
    lib = _build.lib()
    launch = lib.aat_noise_floor_scan
    seen, after = [], []

    def record(*args):
        code = launch(*args)
        after.append(True)
        return code

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if after:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def refuse(*args):
        raise AssertionError("with_tail ran on the CUDA path")

    monkeypatch.setattr(noisefloor, "with_tail", refuse)
    monkeypatch.setattr(lib, "aat_noise_floor_scan", record)
    with Ops():
        got = noisefloor.noise_floor_scan(st0, mags, gf, KC48)
    torch.cuda.synchronize()
    assert after and not seen, seen
    for a, b in zip((got[1], *got[0]), (want[1], *want[0])):
        assert_same_bits(a, b)


@pytest.mark.parametrize("band", [KC48, KC, None])
@pytest.mark.parametrize("s", [1, 33, 128])
def test_k5_matches_plain_at_band_widths(dev, s, band):
    """B = 426 (48 kHz), 464 (44.1 kHz) and 1,025 (the full width) at S =
    1, 33 and 128, full-width magnitudes, from fresh states and from a
    state handed in (every other stream fresh): the effective floors and
    every state leaf across the full width, bitwise."""
    mags, gf = _k5_inputs(dev, s, 40, HALF, seed=s + (band or 0))
    _assert_k5_matches_plain(noisefloor.init_state(HALF, dev, (s,)), mags,
                             gf, band)
    _assert_k5_matches_plain(_k5_state(dev, s, seed=s), mags, gf, band)


@pytest.mark.parametrize("s", [1, 33, 128])
def test_k5_first_frames_match_the_full_width_call(dev, s):
    """K5 over magnitudes banded to kc + 1 bins with each stream's first
    frame at full width (`first`, the full step's call) bitwise to K5 over
    the full-width magnitudes and to the plain scan with `first`: fresh,
    mixed (every other stream fresh) and initialized states, every state
    leaf across the full width."""
    mags, gf = _k5_inputs(dev, s, 40, HALF, seed=60 + s)
    banded = mags[..., :KC48 + 1].contiguous()
    first = mags[:, 0].contiguous()
    mixed = _k5_state(dev, s, seed=s)
    states = {"fresh": noisefloor.init_state(HALF, dev, (s,)),
              "mixed": mixed,
              "initialized": mixed._replace(
                  initialized=torch.ones_like(mixed.initialized))}
    for label, st0 in states.items():
        want = noisefloor.noise_floor_scan(st0, mags, gf, KC48)
        got = noisefloor.noise_floor_scan(st0, banded, gf, KC48, first)
        plain = noisefloor.noise_floor_scan_plain(st0, banded, gf, KC48,
                                                  first)
        torch.cuda.synchronize()
        for a, b, c in zip((got[1], *got[0]), (want[1], *want[0]),
                           (plain[1], *plain[0])):
            assert_same_bits(a, b, label)
            assert_same_bits(a, c, label)


@pytest.mark.parametrize("fresh", [True, False])
def test_k5_matches_plain_at_the_full_steps_call(dev, fresh):
    """The full step's call (parallel/sharding.py): 128 streams x 933
    frames of 1,025-float rows, band 426, a 1,025-wide state, fresh (its
    first step: the tail seeded) or carried (the tail frozen)."""
    mags, gf = _k5_inputs(dev, 128, 933, HALF, seed=43)
    mags[:, 300:700] = 0.0                      # digital silence
    st0 = (noisefloor.init_state(HALF, dev, (128,)) if fresh
           else _k5_state(dev, 128, seed=44)._replace(
               initialized=torch.ones(128, dtype=torch.bool, device=dev)))
    _assert_k5_matches_plain(st0, mags, gf, KC48)


def _edge_case(dev, name):
    from test_torch_noisefloor_kernel import EDGE
    st, mags, gf, band = EDGE[name]
    state = noisefloor.NoiseFloorState(
        *(torch.from_numpy(np.array(a)).to(dev) for a in st))
    return (state, torch.from_numpy(mags).to(dev),
            torch.from_numpy(gf).to(dev), band)


@pytest.mark.parametrize("name", [
    "full_width_scan", "full_width_tail", "near_one_and_a_half_floors",
    "odd_states", "rising_with_subnormal_v", "silence_after_loud"])
def test_k5_edge_cases_match_plain(dev, name):
    """The cases K5's shortcuts could break (tests/
    test_torch_noisefloor_kernel.py `edge_cases`: > 400 frames of silence
    after a loud section, magnitudes within ulps of 1.5x the floor, odd
    handed-in states with NaN, +-inf, negative and subnormal values, m
    above the floor with a subnormal v, full-width magnitudes on fresh and
    initialized streams): every output and state leaf, NaNs by position,
    bitwise elsewhere."""
    st0, mags, gf, band = _edge_case(dev, name)
    launches = hopper_noisefloor.LAUNCHES
    st_k, eff_k = noisefloor.noise_floor_scan(st0, mags, gf, band)
    st_p, eff_p = noisefloor.noise_floor_scan_plain(st0, mags, gf, band)
    torch.cuda.synchronize()
    assert hopper_noisefloor.LAUNCHES == launches + 1
    assert_same_bits_nan(eff_k, eff_p, "effective")
    for field, a, b in zip(noisefloor.NoiseFloorState._fields, st_k, st_p):
        assert_same_bits_nan(a, b, field)


# ── NaN input and the live engine's shapes ───────────────────────────────

def assert_same_bits_nan(got, want, msg=""):
    """NaN where the other has NaN (any NaN bits), equal bits elsewhere."""
    g, w = bits(got), bits(want)
    if got.dtype == torch.float32:
        gn = np.isnan(got.detach().cpu().numpy())
        wn = np.isnan(want.detach().cpu().numpy())
        np.testing.assert_array_equal(gn, wn, err_msg=f"{msg} NaN positions")
        g, w = np.where(gn, 0, g), np.where(wn, 0, w)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def assert_close_nan(got, want, msg=""):
    """K1's check with NaNs: the same NaN positions, and max |Δ| <= 1e-5 ·
    max over the rest."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=msg)
    ok = ~np.isnan(w)
    if ok.any():
        assert np.abs(g[ok] - w[ok]).max() <= 1e-5 * np.abs(w[ok]).max(), msg


def _nan_k5_inputs(dev, s, n, width, seed):
    """_k5_inputs with NaN bins, a whole NaN frame, NaN in a fresh
    stream's first frame and a NaN global floor."""
    mags, gf = _k5_inputs(dev, s, n, width, seed)
    mags[0, 3, 10:14] = float("nan")
    mags[s - 1, n // 2] = float("nan")
    mags[s // 2, 0, 100] = float("nan")
    gf[s // 3, n // 3] = float("nan")
    return mags, gf


@pytest.mark.parametrize("width,band", [(KC + 1, KC), (HALF, None)])
def test_k5_keeps_nans(dev, width, band):
    """K5 puts its NaNs where the plain scan does, from fresh states and
    from a state handed in, at the segmented step's shape."""
    mags, gf = _nan_k5_inputs(dev, 128, 64, width, seed=21)
    for st0 in (noisefloor.init_state(HALF, dev, (128,)),
                _k5_state(dev, 128, seed=22)):
        st_k, eff_k = noisefloor.noise_floor_scan(st0, mags, gf, band)
        st_p, eff_p = noisefloor.noise_floor_scan_plain(st0, mags, gf, band)
        torch.cuda.synchronize()
        assert bool(eff_p.isnan().any())
        assert_same_bits_nan(eff_k, eff_p, "effective")
        for name, a, b in zip(noisefloor.NoiseFloorState._fields, st_k,
                              st_p):
            assert_same_bits_nan(a, b, name)


def test_k4_keeps_nans(dev):
    """K4 with NaN bins, whole NaN frames and a NaN global floor: NaNs
    where the plain scan has them, every decision equal, from fresh and
    carried states."""
    mags, gf, ts, hold = _k4_inputs(dev, 6, 150, seed=23)
    mags[0, 10, 5] = float("nan")
    mags[1, 40] = float("nan")
    mags[2, 0, 64] = float("nan")
    mags[3, 149, 128] = float("nan")
    gf[4, 77] = float("nan")
    st = onset.init_state(onset.HALF, dev, (6,))
    for lo, hi in ((0, 70), (70, 150)):
        part = tuple(t[:, lo:hi].contiguous() for t in (mags, gf, ts, hold))
        st_k, out_k = hopper_onset.onset_scan(st, *part)
        st_p, out_p = onset.onset_scan_plain(st, *part)
        torch.cuda.synchronize()
        for name, a, b in zip(onset.OnsetFrameOut._fields, out_k, out_p):
            assert_same_bits_nan(a, b, name)
        for name, a, b in zip(onset.OnsetState._fields, st_k, st_p):
            assert_same_bits_nan(a, b, name)
        st = st_k
    assert bool(out_p.velocity.isnan().any())


def _live_scene(dev, seconds, nan_at=None):
    """A 48 kHz mixed scene with calibration clicks (four in its first
    0.25 s), on the card; one NaN sample at `nan_at` seconds."""
    x = gen.mixed_scene(seconds, SR48, seed=11)
    click = gen.calibration_click(SR48, volume=0.7)
    for t in (0.03, 0.09, 0.15, 0.21, 1.3):
        x[int(t * SR48):int(t * SR48) + len(click)] += click
    if nan_at is not None:
        x[int(nan_at * SR48)] = np.nan
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_live_pitch_kernels(dev, n, nan):
    """K1, K5, K2, K10 and K3 as the live engine calls them: one stream, n
    pitch frames a call, 12 calls in a row on a fresh buffer each (the ring
    tail and the slot joined), every state carried from the first, fresh,
    call.  K5, K2, K10 and K3 bitwise to their plain versions on the same
    inputs; K1 (split over the sample depth at these n) within 1e-5 · max
    of its plain version and bitwise to the same frames in one batch (the
    unsplit launch).  With a NaN sample in call 5's frames, NaNs where the
    plain versions have them."""
    calls = 12
    x = _live_scene(dev, 3.0, nan_at=(5 * n * HOP + 100) / SR48
                    if nan else None)
    trig = rdft_trig(W, dev)[:, :2 * (KC48 + 1)]
    win = hann(W, dev)
    one_batch = hopper_stft.dft_mag(
        frame_signal(x[:(calls * n - 1) * HOP + W], W, HOP), trig, win)
    nf = noisefloor.init_state(HALF, dev, (1,))
    tr = tracker.init_state(dev, (1,))
    gf = torch.full((1, n), 0.002, device=dev)
    stable = 0
    for c in range(calls):
        buf = x[c * n * HOP:(c * n + n - 1) * HOP + W].clone()
        frames = frame_signal(buf, W, HOP)[None]
        mags = hopper_stft.dft_mag(frames, trig, win)
        assert_close_nan(mags, hopper_stft.dft_mag_plain(frames, trig, win),
                         f"K1 call {c}")
        assert_same_bits_nan(mags[0], one_batch[c * n:(c + 1) * n],
                             f"K1 call {c} against one batch")
        nf_k, eff = noisefloor.noise_floor_scan(nf, mags, gf, KC48)
        nf_p, eff_p = noisefloor.noise_floor_scan_plain(nf, mags, gf, KC48)
        assert_same_bits_nan(eff, eff_p, f"K5 call {c}")
        for a, b in zip(nf_k, nf_p):
            assert_same_bits_nan(a, b, f"K5 state call {c}")
        flat, floor = mags.reshape(n, -1), eff.reshape(n, -1)
        pm, frac, m_c, _, _ = pitch._pre_comb(flat, floor, MIN48, MAX48,
                                              KC48)
        m_c = m_c.contiguous()
        got = hopper_comb.comb(pm, frac, m_c, HALF, MAX48)
        ref = pitch._comb(pm, frac, m_c, HALF, MAX48)
        for g, r in zip(got, ref):
            assert_same_bits_nan(g, r, f"K2 call {c}")
        pf = pitch.extract_pitches(flat, floor, BIN_W48, true_half=HALF)
        ref_pf = pitch._extract(flat, floor, BIN_W48, MIN48, MAX48,
                                pitch.MIN_FREQ, pitch.MAX_FREQ, HALF)
        for a, b in zip(pf, ref_pf):
            assert_same_bits_nan(a, b, f"K10 call {c}")
        onsets = torch.zeros((1, n), dtype=torch.bool, device=dev)
        onsets[0, 0] = c % 4 == 1
        raws = (pf.freqs[None], pf.scores[None], pf.valid[None], onsets)
        st_k, out_k = hopper_tracker.tracker_scan(tr, *raws)
        st_p, emits = tracker.tracker_scan_plain(tr, *raws)
        out_p = tracker.select_stable(*emits)
        torch.cuda.synchronize()
        for a, b in zip((*out_k, *st_k), (*out_p, *st_p)):
            assert_same_bits_nan(a, b, f"K3 call {c}")
        stable += int(out_k[2].sum())
        nf, tr = nf_k, st_k
    if nan:
        assert bool(nf.floor.isnan().any())
    else:
        assert stable > 0


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("n", [15, 16, 17])
def test_live_onset_kernel(dev, n, nan):
    """K4 as the live engine calls it: one stream, n onset frames a call of
    cuFFT magnitudes, with tick-suppressed and held frames, 12 calls in a
    row with the state carried from the first, fresh, call; bitwise to the
    plain scan (NaNs where it has them)."""
    calls = 12
    x = _live_scene(dev, 3.0, nan_at=(4 * n * 64 + 40) / SR48
                    if nan else None)
    frames = frame_signal(x[:(calls * n - 1) * 64 + onset.WINDOW],
                          onset.WINDOW, 64)
    mags_all = windowed_mags(frames, onset.WINDOW, "fft")
    rng = np.random.default_rng(n)
    st = onset.init_state(onset.HALF, dev, (1,))
    fired = 0
    for c in range(calls):
        mags = mags_all[c * n:(c + 1) * n][None].contiguous()
        gf = torch.full((1, n), 0.0016, device=dev)
        ts, hold = (torch.from_numpy(rng.random((1, n)) < 0.1).to(dev)
                    for _ in range(2))
        st_k, out_k = hopper_onset.onset_scan(st, mags, gf, ts, hold)
        st_p, out_p = onset.onset_scan_plain(st, mags, gf, ts, hold)
        torch.cuda.synchronize()
        for name, a, b in zip(onset.OnsetFrameOut._fields, out_k, out_p):
            assert_same_bits_nan(a, b, f"{name} call {c}")
        for name, a, b in zip(onset.OnsetState._fields, st_k, st_p):
            assert_same_bits_nan(a, b, f"{name} state call {c}")
        fired += int(out_k.fired.sum())
        st = st_k
    if not nan:
        assert fired > 0


def test_fft_mags_are_batch_independent(dev):
    """One onset frame's "fft" magnitudes (K11) in batches of 1, 16, 63,
    64, 65 and 129 frames and in an engine pool's batches of 16·C frames
    (C lanes of 16 onset frames, C up to 129), the frame at the batch's
    first, middle and last row: the same bits in every batch, and in the
    pool's [C, 16, 256] layout at each lane."""
    x = _live_scene(dev, 6.0)
    frames = frame_signal(x, onset.WINDOW, 64)               # 4,497 frames
    k = 2100
    want = windowed_mags(frames[k:k + 1], onset.WINDOW, "fft")[0]
    for b in (1, 16, 63, 64, 65, 129, 32, 528, 1024, 2064):
        for start in (k, k - b // 2, k - b + 1):
            got = windowed_mags(frames[start:start + b], onset.WINDOW, "fft")
            assert_same_bits(got[k - start], want, f"batch {b} at {start}")
            got = windowed_mags(frames[None, start:start + b],
                                onset.WINDOW, "fft")
            assert_same_bits(got[0, k - start], want,
                             f"[1, {b}] batch at {start}")
    for c in (2, 33, 64, 129):
        for lane in (0, c // 2, c - 1):
            start = k - 16 * lane - 5
            lanes = frames[start:start + 16 * c].reshape(c, 16, onset.WINDOW)
            got = windowed_mags(lanes, onset.WINDOW, "fft")
            assert_same_bits(got[lane, 5], want, f"[{c}, 16] lane {lane}")


def _pool_lanes(dev, c):
    """C lanes' inputs at the pool's shapes, from C slots of the live scene:
    pitch frames [C, 2, 2048] and onset frames [C, 16, 256]."""
    x = _live_scene(dev, 4.0)
    starts = [(7 * k) % 150 * 1024 for k in range(c)]
    p = torch.stack([x[s:s + 512 + W] for s in starts])
    o = torch.stack([x[s:s + 15 * 64 + onset.WINDOW] for s in starts])
    return frame_signal(p, W, HOP), frame_signal(o, onset.WINDOW, 64)


@pytest.mark.parametrize("c", [33, 129])
def test_kernels_are_batch_independent_at_pool_shapes(dev, c):
    """Each kernel, and the extraction (K10), on C lanes at the
    pool's shapes (48 kHz, 1,024-sample slots): every lane bit for bit
    what the same lane gives alone (S = 1).  An inert lane cannot reach a
    live one, and a pooled engine equals a solo one."""
    p_frames, o_frames = _pool_lanes(dev, c)
    trig = rdft_trig(W, dev)[:, :2 * (KC48 + 1)]
    win = hann(W, dev)
    mags = hopper_stft.dft_mag(p_frames, trig, win)               # K1
    gf = torch.full((c, 2), 0.002, device=dev)
    nf0 = noisefloor.init_state(HALF, dev, (c,))
    nf, eff = noisefloor.noise_floor_scan(nf0, mags, gf, KC48)    # K5
    pf = pitch.extract_pitches(mags.reshape(2 * c, -1),
                               eff.reshape(2 * c, -1), BIN_W48,
                               true_half=HALF)                    # K10
    raws = (pf.freqs.reshape(c, 2, 8), pf.scores.reshape(c, 2, 8),
            pf.valid.reshape(c, 2, 8),
            torch.rand((c, 2), device=dev) < 0.3)
    tr0 = tracker.init_state(dev, (c,))
    tr, stable = tracker.tracker_scan_batched(tr0, *raws)         # K3
    o_mags = windowed_mags(o_frames, onset.WINDOW, "fft")
    o_in = (o_mags, torch.full((c, 16), 0.0016, device=dev),
            torch.rand((c, 16), device=dev) < 0.1,
            torch.rand((c, 16), device=dev) < 0.2)
    on0 = onset.init_state(onset.HALF, dev, (c,))
    on, o_out = onset.onset_scan(on0, *o_in)                      # K4
    for lane in (0, 1, c // 2, c - 1):
        one = slice(lane, lane + 1)
        m1 = hopper_stft.dft_mag(p_frames[one], trig, win)
        assert_same_bits(mags[one], m1, f"K1 lane {lane}")
        nf1, eff1 = noisefloor.noise_floor_scan(
            type(nf0)(*(leaf[one] for leaf in nf0)), m1, gf[one], KC48)
        assert_same_bits(eff[one], eff1, f"K5 lane {lane}")
        for a, b in zip(nf, nf1):
            assert_same_bits(a[one], b, f"K5 state lane {lane}")
        pf1 = pitch.extract_pitches(m1[0], eff1[0], BIN_W48, true_half=HALF)
        for a, b in zip(pf, pf1):
            assert_same_bits(a[2 * lane:2 * lane + 2], b,
                             f"extraction lane {lane}")
        tr1, stable1 = tracker.tracker_scan_batched(
            type(tr0)(*(leaf[one] for leaf in tr0)),
            *(r[one] for r in raws))
        for a, b in zip((*tr, *stable), (*tr1, *stable1)):
            assert_same_bits(a[one], b, f"K3 lane {lane}")
        on1, o_out1 = onset.onset_scan(
            type(on0)(*(leaf[one] for leaf in on0)),
            *(t[one].contiguous() for t in o_in))
        for a, b in zip((*on, *o_out), (*on1, *o_out1)):
            assert_same_bits(a[one], b, f"K4 lane {lane}")


@pytest.mark.parametrize("c", [33, 129])
def test_fused_slot_lanes_match_one_lane_on_the_card(dev, c):
    """`fused_slot_step` over C lanes on the card (some lanes holding
    calibration, tick-suppressed frames) against each lane's one-lane call,
    4 slots from fresh carries: packed outputs and carries bit for bit."""
    from audio_analyzer_rs_tpu_torch.models import analyzer as A
    from audio_analyzer_rs_tpu_torch.utils.framing import num_frames

    x = _live_scene(dev, 4.0).cpu().numpy()
    rng = np.random.default_rng(c)

    def fresh():
        return A.PoolCarries(
            noisefloor.init_state(HALF, dev, (1,)),
            tracker.init_state(dev, (1,)),
            onset.init_state(onset.HALF, dev, (1,)),
            torch.zeros(1, dtype=torch.bool, device=dev),
            torch.zeros(0, device=dev), torch.zeros(0, device=dev))

    lanes = [fresh() for _ in range(c)]
    solo = [tuple(fresh()) for _ in range(c)]
    p_len = o_len = 0
    for slot in range(4):
        n_p = num_frames(p_len + 1024, W, HOP)
        n_o = num_frames(o_len + 1024, onset.WINDOW, 64)
        rows = []
        for k in range(c):
            at = ((7 * k) % 150 + slot) * 1024
            rows.append(np.concatenate([
                x[at:at + 1024], np.float32([0.004, 0.0016, k % 3 == 0]),
                (rng.random(n_o) < 0.1).astype(np.float32)]))
        hv = torch.from_numpy(np.stack(rows)).to(dev)
        *new, out = A.fused_slot_step(*A.stack_carries(lanes), hv, SR48, 1024)
        lanes = A.unstack_carries(A.PoolCarries(*new), c)
        got = out.reshape(-1)
        per = A.fused_out_len(n_p, n_o)
        for k in (0, 1, c // 2, c - 1):
            *new1, out1 = A.fused_slot_step(*solo[k], hv[k], SR48, 1024)
            solo[k] = tuple(new1)
            lane_vec = torch.cat([
                got[off * c + k * size:off * c + (k + 1) * size]
                for off, size in _leaf_spans(n_p, n_o)])
            assert lane_vec.numel() == per
            assert_same_bits(lane_vec, out1, f"slot {slot} lane {k}")
            for a, b in zip(_flat(lanes[k]), _flat(solo[k])):
                assert_same_bits(a, b, f"slot {slot} lane {k} carry")
        p_len += 1024 - n_p * HOP
        o_len += 1024 - n_o * 64


def _leaf_spans(n_p, n_o):
    """(offset a lane, size a lane) of each packed leaf of one slot."""
    spans, off = [], 0
    for size in (n_p * 8,) * 3 + (n_o,) * 8:
        spans.append((off, size))
        off += size
    return spans


def _flat(carries):
    return [leaf for part in carries
            for leaf in (part if isinstance(part, tuple) else (part,))]


def test_readback_waits_for_its_copy(dev):
    """A deferred readback of a vector the card writes after a ~20 ms spin:
    `wait()` returns the written values (the page-locked buffer is read
    only after its event), and only that entry's event is waited on."""
    from audio_analyzer_rs_tpu_torch.api.engine import Readback

    src = torch.zeros(4096, device=dev)
    torch.cuda._sleep(40_000_000)
    src.add_(3.0)
    rb = Readback(src * 2.0)
    assert not rb._event.query()
    got = rb.wait()
    assert rb._event.query()
    np.testing.assert_array_equal(got, np.full(4096, 6.0, np.float32))
    assert rb._host.is_pinned()


# ── K6 (the reducer scan) and K7 (the dynamics scan) ─────────────────────

def reducer_streams(b: int, t: int, seed: int = 0) -> np.ndarray:
    """[b, t] float32: mixed scenes over a harmonic tone's start, every
    fourth stream (from the second) with a quiet section from t/3 on (-80
    dB: the gate holds, releases and attenuates), every fourth (from the
    third) with a NaN sample at t/2 and every fourth digital silence."""
    rows = []
    for i in range(b):
        x = gen.mixed_scene(t / SR48 + 0.05, SR48, seed=seed + i)[:t].copy()
        x[:t // 10] += gen.tone_with_harmonics(
            220.0 * (1 + i % 5), t // 10 / SR48, SR48, amplitude=0.3)[:t // 10]
        kind = i % 4
        if kind == 1:
            x[t // 3:] *= np.float32(1e-4)
        elif kind == 2:
            x[t // 2] = np.nan
        elif kind == 3:
            x[:] = 0.0
        rows.append(x.astype(np.float32))
    return np.stack(rows)


def dynamics_streams(b: int, s: int, seed: int = 0) -> np.ndarray:
    """[b, s, 1024] float32 slots: mixed scenes over a swelling harmonic
    tone, a silent stretch and a -60 dB one; every third stream (from the
    third) a NaN sample in slot s/2."""
    n = s * 1024
    rows = []
    for i in range(b):
        x = gen.mixed_scene(n / SR48 + 0.05, SR48, seed=seed + i)[:n].copy()
        swell = 0.05 + 0.4 * np.abs(np.sin(np.arange(n) / SR48 * (2 + i % 7)))
        x += (swell * gen.tone_with_harmonics(
            196.0 * (1 + i % 5), n / SR48 + 0.05, SR48,
            amplitude=1.0)[:n]).astype(np.float32)
        x[n // 5:n // 5 + 9000] = 0.0
        x[n // 2 + 2000:n // 2 + 9000] *= np.float32(1e-3)
        if i % 3 == 2:
            x[(s // 2) * 1024 + 100] = np.nan
        rows.append(x.reshape(s, 1024))
    return np.stack(rows).astype(np.float32)


def carried_dynamics_state(b: int, seed: int, device="cpu"):
    """A DynamicsState as a long session leaves it: rings part filled or
    wrapped, positions anywhere, +inf where unwritten, the histograms
    matching the rings' finite entries, gains anywhere in [0.5, 20]."""
    from audio_analyzer_rs_tpu_torch.ops import dynamics
    rng = np.random.default_rng(seed)
    leaves = [t.clone() for t in dynamics.init_state("cpu", (b,))]
    for i in range(b):
        for hist, pos, filled, counts, n in (
                (0, 1, 2, 7, dynamics.LONG_LEN),
                (3, 4, 5, 8, dynamics.PLAY_LEN)):
            full = bool(rng.random() < 0.5)
            k = n if full else int(rng.integers(1, n))
            ring = np.full(n, np.inf, np.float32)
            ring[:k] = np.exp(rng.uniform(-14, -1, k)).astype(np.float32)
            leaves[hist][i] = torch.from_numpy(ring)
            leaves[pos][i] = int(rng.integers(0, n)) if full else k % n
            leaves[filled][i] = full
            buckets = dynamics._bucket_of(torch.from_numpy(ring[:k]))
            leaves[counts][i] = torch.bincount(buckets, minlength=1024).to(
                torch.int32)
        leaves[6][i] = float(np.float32(rng.uniform(0.5, 20.0)))
    return dynamics.DynamicsState(*(t.to(device) for t in leaves))


def _reducer_leaves(st):
    return [*st.hp, *st.lp, *st.gate]


def _hold_streams(b: int, t: int) -> np.ndarray:
    """[b, t]: a tone that drops 80 dB at sample 40 + 64i in stream i, so
    that the gate's hold (960 samples at 48 kHz) starts inside a 64-sample
    tile, runs across the tiles and across the two calls of the test."""
    x = np.stack([gen.tone_with_harmonics(220.0 * (1 + i), t / SR48 + 0.01,
                                          SR48, amplitude=0.3)[:t]
                  for i in range(b)]).astype(np.float32)
    for i in range(b):
        x[i, 40 + 64 * i:] *= np.float32(1e-4)
    return x


# (B, T): None is the default length (1,500 samples at B >= 128, else
# 3,000), each case run as two calls of T and T + 17 samples: T shorter
# than a 64-sample tile (40), T not a multiple of the tile or of 4 (61,
# 1001, and every T + 17), a partial block (B = 129), and "hold".
K6_CASES = [(1, None), (33, None), (128, None), (129, 700), (1, 40), (3, 61),
            (33, 1001), (4, "hold")]


@pytest.mark.parametrize("gate_only", [False, True])
@pytest.mark.parametrize("b,t", K6_CASES)
def test_k6_matches_plain_bitwise(dev, b, t, gate_only):
    """K6 against its plain version (`reduce_exact_plain`, or `gate_plain`
    for the gate-only entry), from a fresh state and then carried into a
    second chunk: outputs and state, NaNs by position, bits elsewhere.
    Each stream's bits are also its bits in a batch of one."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_reducer, reducer
    if t == "hold":
        t = 500
        x = _hold_streams(b, 2 * t + 17)
    else:
        t = t or (1500 if b >= 128 else 3000)
        x = reducer_streams(b, 2 * t + 17, seed=b)
    x = torch.from_numpy(x).to(dev)
    st = reducer.reducer_init(dev, (b,))
    launches = hopper_reducer.LAUNCHES
    for lo, hi in ((0, t), (t, 2 * t + 17)):
        xs = x[:, lo:hi].contiguous()
        st_k, y_k = hopper_reducer.reduce_scan(st, xs, SR48, gate_only)
        if gate_only:
            gate, y_p = reducer.gate_plain(st.gate, xs, SR48)
            st_p = reducer.ReducerState(st.hp, st.lp, gate)
        else:
            st_p, y_p = reducer.reduce_exact_plain(st, xs, SR48)
        torch.cuda.synchronize()
        assert_same_bits_nan(y_k, y_p, f"K6 B={b} [{lo}, {hi})")
        for a, c in zip(_reducer_leaves(st_k), _reducer_leaves(st_p)):
            assert_same_bits_nan(a, c, f"K6 B={b} state")
        one_st = reducer.ReducerState(*(type(p)(*(a[:1] for a in p))
                                        for p in st))
        _, y_one = hopper_reducer.reduce_scan(one_st, xs[:1].contiguous(),
                                              SR48, gate_only)
        assert_same_bits_nan(y_one[0], y_k[0], f"K6 B=1 vs B={b}")
        st = st_k
    assert hopper_reducer.LAUNCHES == launches + 4


# (B, S, L): None is the default (S = 12 at B = 128, else 20; L = 1,024);
# one slot (S = 1), a slot of 480 samples, a partial last block (B = 129).
K7_CASES = [(1, None, 1024), (33, None, 1024), (128, None, 1024),
            (3, 1, 1024), (5, 9, 480), (129, 6, 1024)]


@pytest.mark.parametrize("mode", ["hist", "exact"])
@pytest.mark.parametrize("b,s,length", K7_CASES)
def test_k7_matches_plain_bitwise(dev, b, s, length, mode):
    """K7 against `dynamics_scan_plain` on the card: from fresh states, and
    from carried session states (rings wrapped, histograms full); outputs,
    gained slots and every state leaf, NaNs by position.  Each stream's
    bits are also its bits in a batch of one."""
    from audio_analyzer_rs_tpu_torch.ops import dynamics, hopper_dynamics
    s = s or (12 if b == 128 else 20)
    n = max(-(-s * length // 1024), 12)
    audio = dynamics_streams(b, n, seed=b).reshape(b, -1)[:, :s * length]
    slots = torch.from_numpy(audio.reshape(b, s, length).copy()).to(dev)
    for st in (dynamics.init_state(dev, (b,)),
               carried_dynamics_state(b, seed=b, device=dev)):
        st_k, out_k, g_k = hopper_dynamics.dynamics_scan(st, slots, SR48,
                                                         length, mode)
        st_p, out_p, g_p = dynamics.dynamics_scan_plain(st, slots, SR48,
                                                        length, mode)
        torch.cuda.synchronize()
        for name, a, c in zip(dynamics.DynamicsOut._fields, out_k, out_p):
            assert_same_bits_nan(a, c, f"K7 {mode} B={b} {name}")
        assert_same_bits_nan(g_k, g_p, f"K7 {mode} B={b} gained")
        for name, a, c in zip(dynamics.DynamicsState._fields, st_k, st_p):
            assert_same_bits_nan(a, c, f"K7 {mode} B={b} state {name}")
        one = dynamics.DynamicsState(*(t[:1].contiguous() for t in st))
        _, out_one, g_one = hopper_dynamics.dynamics_scan(
            one, slots[:1].contiguous(), SR48, length, mode)
        for a, c in zip(out_one, out_k):
            assert_same_bits_nan(a[0], c[0], f"K7 B=1 vs B={b}")
        assert_same_bits_nan(g_one[0], g_k[0])
    if s > 1:
        assert int((out_k.level >= 0).sum()) > 0


def test_fft_2048_mags_across_batches(dev):
    """One pitch frame's "fft" magnitudes (K11, 2,048 points, the full
    step's pitch STFT) in batches of 1, 7, 933 and 1,866 frames and in the
    full step's [B, 933] layout at B = 4 and 128: the same bits in every
    batch (cuFFT's 2,048-point bits depended on the batch, and this test
    held them within 1e-5 of the frame's peak)."""
    x = _live_scene(dev, 24.0)
    frames = frame_signal(x, W, HOP)                          # 2,246 frames
    k = 1000
    want = windowed_mags(frames[k:k + 1], W, "fft")[0]
    for b in (1, 7, 933, 1866):
        for start in (k, k - b // 2, k - b + 1):
            if start < 0 or start + b > frames.shape[0]:
                continue
            got = windowed_mags(frames[start:start + b], W, "fft")
            assert_same_bits(got[k - start], want, f"batch {b} at {start}")
    for rows in (4, 128):
        lanes = frames[k - 400:k + 533].unsqueeze(0).repeat(rows, 1, 1)
        got = windowed_mags(lanes, W, "fft")
        for r in (0, rows - 1):
            assert_same_bits(got[r, 400], want, f"[{rows}, 933] row {r}")


@pytest.mark.parametrize("width", [256, 2048])
@pytest.mark.parametrize("data", ["random", "scene", "silence", "naninf"])
def test_k11_bitwise_to_its_transcription(dev, width, data):
    """K11 bit for bit against `rfft_mag_fixed_np` (its operation order in
    numpy; NaNs by position) on random, scene, silence-level frames (the
    Hann window's products below 2^-126) and random frames with NaN and
    inf samples, 4 streams read through unfold views with float2 loads and
    (an odd sample offset) scalar loads: the full width, the band with
    each stream's first frame at full width (`rfft_mag_first`; the full
    step's pitch band at 2,048), and through the wrapper's rectangular
    window and a band."""
    hop = width // 4
    band = KC48 + 1 if width == 2048 else 57
    if data in ("random", "naninf"):
        x = np.random.default_rng(width).standard_normal(
            width * 64).astype(np.float32)
        if data == "naninf":
            x[::997], x[5::1409], x[11::2003] = np.nan, np.inf, -np.inf
    elif data == "scene":
        x = _live_scene(dev, 3.0).cpu().numpy()
    else:
        x = (gen.mixed_scene(3.0, SR48, seed=4)
             * np.float32(2.0 ** -120)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    span = (len(x) - 1) // 4
    win = hann(width, dev)
    for off in (0, 1):
        fr = frame_signal(xd[off:off + 4 * span].reshape(4, span), width,
                          hop)
        want = hopper_rfft.rfft_mag_fixed_np(fr.cpu().numpy(), None,
                                             win.cpu().numpy())
        assert_same_bits_nan(windowed_mags(fr, width, "fft"),
                             torch.from_numpy(want), f"offset {off}")
        got, first = hopper_rfft.rfft_mag_first(fr, band, win)
        assert_same_bits_nan(got, torch.from_numpy(
            np.ascontiguousarray(want[..., :band])), f"band, offset {off}")
        assert_same_bits_nan(first, torch.from_numpy(
            np.ascontiguousarray(want[:, 0])), f"first, offset {off}")
    fr = fr[:, ::3]
    assert_same_bits_nan(hopper_rfft.rfft_mag(fr, 17), torch.from_numpy(
        hopper_rfft.rfft_mag_fixed_np(fr.cpu().numpy(), 17)))


@pytest.mark.parametrize("width", hopper_rfft.widths())
def test_k11_both_forms_bitwise(dev, width):
    """K11 takes 16 values a thread below 8 warps of 32-value groups an SM
    and 32 from there (csrc/rfft_mag.cu `launch`): frame counts on both
    sides of the switch at every width, full and banded with the first
    frames of 11-frame rows, each bitwise to `rfft_mag_fixed_np`, a
    frame's bits the same in either form."""
    tpf = width // 64                            # threads a frame at 32
    group = max(32, tpf)
    fpg = group // tpf                           # frames a group
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = (8 * sms * 32 // group - 1) * fpg    # the 16-value form's most
    n_big = -(-(small + fpg + 3) // 11) * 11
    rng = np.random.default_rng(width + 7)
    x = rng.standard_normal(n_big * width // 4 + width).astype(np.float32)
    fr = frame_signal(torch.from_numpy(x).to(dev), width, width // 4)
    fr = fr[:n_big]
    win = hann(width, dev)
    wn = win.cpu().numpy()
    band = width // 4 + 11
    want = hopper_rfft.rfft_mag_fixed_np(fr.cpu().numpy(), None, wn)
    for n in (small - small % 11, n_big):
        got = hopper_rfft.rfft_mag(fr[:n], None, win)
        assert_same_bits(got, want[:n], f"{n} frames")
        rows = fr[:n].reshape(n // 11, 11, width)
        got_b, first = hopper_rfft.rfft_mag_first(rows, band, win)
        assert_same_bits(got_b.reshape(n, band), want[:n, :band],
                         f"{n} frames, band")
        assert_same_bits(first, want[:n:11], f"{n} frames, first")


@pytest.mark.parametrize("width", [256, 2048])
def test_k11_near_cufft_and_the_spectral_gate(dev, width):
    """K11 within 1e-5 of each frame's peak of its plain version
    (torch.fft.rfft(frames x hann).abs(), cuFFT), and the float64 spectral
    gate (rel MSE < 1e-6) through `windowed_mags`."""
    from audio_analyzer_rs_tpu_torch.ops import stft
    x = _live_scene(dev, 6.0)
    fr = frame_signal(x, width, width // 4)
    win = hann(width, dev)
    got = hopper_rfft.rfft_mag(fr, None, win)
    plain = hopper_rfft.rfft_mag_plain(fr, None, win)
    peak = plain.abs().amax(-1, keepdim=True)
    assert bool(((got - plain).abs() <= 1e-5 * peak).all())
    probe = gen.tone_with_harmonics(220.0, 1.0, SR48, harmonics=8,
                                    amplitude=0.5)
    for sig in (probe, x.cpu().numpy()):
        rel = stft.spectral_rel_mse(sig, width, width // 4, "fft", dev)
        assert rel < stft.FIDELITY_MAX_REL_MSE, rel


def test_k11_refuses_and_counts(dev):
    """The wrapper on CUDA tensors: K11 or an exception (a float64 frame,
    an untaken width), one count a launch and none for a refusal."""
    before = hopper_rfft.LAUNCHES
    fr = torch.zeros((3, 256), device=dev)
    hopper_rfft.rfft_mag(fr)
    assert hopper_rfft.LAUNCHES == before + 1
    with pytest.raises(TypeError):
        hopper_rfft.rfft_mag(fr.double())
    with pytest.raises(ValueError):
        hopper_rfft.rfft_mag(torch.zeros((3, 300), device=dev))
    assert hopper_rfft.LAUNCHES == before + 1


def _full_step_two_streams(device, mags_fn=None):
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    audio = np.stack([gen.mixed_scene(2.0, SR48, seed=s)
                      + gen.tone_with_harmonics(262.0 * (s + 1), 2.0, SR48,
                                                amplitude=0.2)
                      for s in range(2)]).astype(np.float32)
    windowed, banded = sharding.windowed_mags, sharding.pitch_mags
    if mags_fn is not None:
        # Both STFTs through mags_fn: the pitch call's band and first
        # frames sliced from its full width, as on the CPU.
        sharding.windowed_mags = mags_fn
        sharding.pitch_mags = lambda frames, band: tuple(
            t.to(frames.device) for t in banded(frames.cpu(), band))
    try:
        step = sharding.make_batched_full_step(None, SR48, device=device)
        _, out = step(sharding.init_stream_states(2, device=device), audio)
    finally:
        sharding.windowed_mags, sharding.pitch_mags = windowed, banded
    return sharding.FullStepOut(*(t.cpu() for t in out))


def test_full_step_card_matches_cpu(dev):
    """`make_batched_full_step` on the card against the same step on the
    CPU (the plain versions), 2 streams x 2 s in one step.  With the STFT
    equalized (the CPU's FFT magnitudes used on the card) every decision
    is equal: stable valid flags, fired onsets, levels; frequencies within
    1e-4 relative, velocities within 1e-5.  With K11's own magnitudes
    the levels are equal and at most 1% of the stable slots flip."""
    cpu = _full_step_two_streams("cpu")

    def cpu_mags(frames, window, backend="fft", band=None):
        return windowed_mags(frames.cpu(), window, backend, band).to(
            frames.device)
    card = _full_step_two_streams(dev, cpu_mags)
    for f in ("stable_valid", "onset_fired", "dyn_level",
              "global_onset_count"):
        assert torch.equal(getattr(card, f), getattr(cpu, f)), f
    np.testing.assert_allclose(card.stable_freqs.numpy(),
                               cpu.stable_freqs.numpy(), rtol=1e-4)
    np.testing.assert_allclose(card.onset_velocity.numpy(),
                               cpu.onset_velocity.numpy(), rtol=0, atol=1e-5)
    assert bool(card.stable_valid.any()) and bool(card.onset_fired.any())
    raw = _full_step_two_streams(dev)
    assert torch.equal(raw.dyn_level, cpu.dyn_level)
    flips = int((raw.stable_valid != cpu.stable_valid).sum())
    assert flips <= 0.01 * cpu.stable_valid.numel(), flips


def test_full_step_launches_each_kernel_once(dev, monkeypatch):
    """One full step at B = 4: K3-K7 and K10 once each (K2's comb runs
    inside K10) and K11 twice (the pitch and the onset STFT), no plain
    scan step and no plain extraction."""
    from audio_analyzer_rs_tpu_torch.ops import (dynamics, hopper_dynamics,
                                                 hopper_reducer)
    from audio_analyzer_rs_tpu_torch.ops import reducer
    from audio_analyzer_rs_tpu_torch.parallel import sharding

    def refuse(*args, **kwargs):
        raise AssertionError("a plain scan step ran on the card")
    for mod, name in ((noisefloor, "_step"), (onset, "_step"),
                      (dynamics, "_step"), (tracker, "select_stable"),
                      (reducer, "_feedback"), (reducer, "_envelope"),
                      (pitch, "_extract"), (hopper_comb, "comb")):
        monkeypatch.setattr(mod, name, refuse)
    mods = (hopper_extract, hopper_tracker, hopper_onset, hopper_noisefloor,
            hopper_reducer, hopper_dynamics, hopper_rfft)
    monkeypatch.setattr(hopper_rfft, "rfft_mag_plain", refuse)
    audio = torch.from_numpy(dynamics_streams(4, 6).reshape(4, -1)).to(dev)
    step = sharding.make_batched_full_step(None, SR48, device=dev)
    st = sharding.init_stream_states(4, device=dev)
    before = [m.LAUNCHES for m in mods]
    st, out = step(st, audio)
    torch.cuda.synchronize()
    assert [m.LAUNCHES - n for m, n in zip(mods, before)] == [1] * 6 + [2]


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 3), (4, 37), (1, 300)])
def test_k1_full_width_matches_plain_and_banded(dev, shape):
    """K1 over all 1,025 bins (the debug path's table: 2,080 padded
    columns, 13 column tiles) at the live shapes and beyond: within 1e-5 ·
    max of its plain version, and bins [0, kc] bit for bit the banded
    launch's on the same frames (a column's sum does not depend on the
    tile that holds it)."""
    s, n = shape
    x = torch.from_numpy(
        gen.tone_with_harmonics(220.0, 8.0, SR, harmonics=8, amplitude=0.4)
        + gen.mixed_scene(8.0, SR, seed=11)).to(dev)
    streams = torch.stack([x[i * 30000:i * 30000 + (n - 1) * HOP + W]
                           for i in range(s)])
    frames = frame_signal(streams, W, HOP)
    full = rdft_trig(W, dev)
    win = hann(W, dev)
    got = hopper_stft.dft_mag(frames, full, win)
    ref = hopper_stft.dft_mag_plain(frames, full, win)
    banded = hopper_stft.dft_mag(frames, full[:, :2 * (KC + 1)], win)
    torch.cuda.synchronize()
    assert got.shape == (s, n, HALF)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert_same_bits(got[..., :KC + 1].contiguous(), banded)
    assert hopper_stft._cached_split(full)[1] == 2080


@pytest.mark.parametrize("s,n", [(1, 2), (1, 4096), (3, 31)])
def test_k5_banded_then_full_width_bitwise(dev, s, n):
    """A state that ran banded (its tail above the band frozen: banded
    magnitudes never seed it) continued over all 1,025 bins, as attaching
    a recorder mid-stream does: bitwise to the plain scan."""
    mags_b, gf = _k5_inputs(dev, s, n, KC + 1, seed=n + 1)
    st, _ = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, dev, (s,)), mags_b, gf, KC)
    assert not bool(st.floor[..., KC:].any())
    mags_f, gf = _k5_inputs(dev, s, n, HALF, seed=n + 2)
    _assert_k5_matches_plain(st, mags_f, gf, None)


def test_pitch_analyzer_recorder_keeps_its_outputs(dev):
    """PitchAnalyzer on the card with a DebugRecorder (K1 and K5 at full
    width) gives the stable outputs of the one without, bit for bit, and
    a full-width record a frame."""
    from audio_analyzer_rs_tpu_torch.devtools import DebugRecorder
    from audio_analyzer_rs_tpu_torch.models.analyzer import PitchAnalyzer
    x = gen.mixed_scene(6.0, SR, seed=11)
    rec = DebugRecorder()
    plain = PitchAnalyzer(SR, device="cuda", max_chunk_frames=100)
    debug = PitchAnalyzer(SR, device="cuda", max_chunk_frames=100,
                          debug_recorder=rec)
    for part in (x[:100000], x[100000:]):
        a, b = plain.process(part), debug.process(part)
        for name in ("stable_freqs", "stable_scores", "stable_valid"):
            np.testing.assert_array_equal(getattr(a, name).view(np.uint8),
                                          getattr(b, name).view(np.uint8))
    assert b.stable_valid.any()
    assert [r.frame for r in rec.pitch_frames] == list(
        range(debug.frames_consumed))
    assert rec.pitch_frames[-1].noise_floor.shape == (HALF,)


def test_engine_with_recorder_on_the_card(dev):
    """The live engine with a recorder attached at slot 30: no fused slot
    from then on, and the polls equal an engine without one."""
    from audio_analyzer_rs_tpu_torch.api.device import ArraySource
    from audio_analyzer_rs_tpu_torch.api.engine import AudioEngine
    from audio_analyzer_rs_tpu_torch.devtools import DebugRecorder
    scene = gen.mixed_scene(3.0, SR48, seed=11)
    runs = []
    for attach in (False, True):
        e = AudioEngine(input_source=ArraySource(scene), sample_rate=SR48,
                        loopback_latency_samples=2048, loopback_gain=1.0,
                        device="cuda")
        tuner, onset = e.start_tuner(), e.start_onset_detection()
        rec, polls = DebugRecorder(), []
        for k in range(120):
            if attach and k == 30:
                fused = e._fused_slots
                e.attach_debug_recorder(rec)
            e.advance(1024 / SR48)
            polls.append((tuner.poll_output(), onset.poll_onsets(),
                          e.poll_dynamics()))
        runs.append(polls)
    assert runs[0] == runs[1]
    assert e._fused_slots == fused == 30
    assert rec.pitch_frames and rec.onset_frames


# ── K8 and K9: the Mosaic probe's lane gathers (csrc/gather.cu) ───────────

def _gather_inputs(f, p, seed, special=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((f, p)).astype(np.float32)
    idx = rng.integers(-2 * p, 2 * p, (f, p)).astype(np.int32)
    if special:
        x[0, : min(p, 20)] = -0.0
        x[-1, ::3] = np.nan
        x[-1, 1::7] = 0.0
        idx[0, : min(p, 8)] = np.arange(min(p, 8), dtype=np.int32)
        ends = [2 ** 31 - 1, 2 ** 31 - 11, -2 ** 31, -1][:p]
        idx[-1, :len(ends)] = ends
    return x, idx


def _same_gather(got, want):
    """Bitwise, NaNs compared by position (the card's NaN bits may be its
    canonical ones)."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gn, wn)
    assert torch.equal(torch.where(gn, 0, got.view(torch.int32)),
                       torch.where(wn, 0, want.view(torch.int32)))


@pytest.mark.parametrize("kernel", ["lane_gather", "comb_gather12"])
@pytest.mark.parametrize("f,p,special", [
    (8, 1024, False), (8, 7296, False), (8, 7296, True), (1, 1, False),
    (1, 1, True), (5, 3, True), (3, 129, True), (2, 7297, True),
    (70000, 5, False)])
def test_gathers_match_plain_bitwise(dev, kernel, f, p, special):
    from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather
    x, idx = _gather_inputs(f, p, f * 31 + p, special)
    xd, idd = torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)
    before = (hopper_gather.LAUNCHES_K8, hopper_gather.LAUNCHES_K9)
    got = getattr(hopper_gather, kernel)(xd, idd)
    want = getattr(gather, kernel)(xd, idd)
    torch.cuda.synchronize()
    _same_gather(got, want)
    _same_gather(got.cpu(), getattr(gather, kernel)(torch.from_numpy(x),
                                                    torch.from_numpy(idx)))
    after = (hopper_gather.LAUNCHES_K8, hopper_gather.LAUNCHES_K9)
    assert sum(after) - sum(before) == 1
    if special and kernel == "comb_gather12" and p >= 20:
        # Twelve -0.0 reads sum to +0.0.
        assert not torch.signbit(got[0, :8]).any()


def test_gathers_at_the_probes_cases(dev):
    """The probe's five cases, bitwise to numpy (port_tools/gather_probe.py
    prints them with its timings)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "gather_probe",
        Path(__file__).resolve().parents[1] / "port_tools" / "gather_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    res = probe.check_cases(say=lambda _: None)
    assert all(res["ok"].values()), res
    assert res["max_abs_err"] == {"K8": 0.0, "K9": 0.0}


def test_gathers_over_wide_rows(dev):
    """A row wider than a block's shared memory (60,000 values)."""
    from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather
    x, idx = _gather_inputs(3, 60000, 5, special=True)
    xd, idd = torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)
    for kernel in ("lane_gather", "comb_gather12"):
        _same_gather(getattr(hopper_gather, kernel)(xd, idd),
                     getattr(gather, kernel)(xd, idd))


def test_mesh_at_world_size_one_on_the_card(dev, tmp_path):
    """The full step and the segmented pitch path through an NCCL mesh of
    one rank (a FileStore) equal mesh=None bit for bit."""
    import torch.distributed as dist
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.parallel import mesh as pmesh
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh("cuda")
        rng = np.random.default_rng(9)
        audio = (rng.standard_normal((4, 8192)) * 0.1).astype(np.float32)
        outs = [sharding.make_batched_full_step(m, 48000.0)(
            sharding.init_stream_states(4), audio)[1] for m in (None, mesh)]
        for a, b in zip(*outs):
            assert torch.equal(a.view(torch.int32) if a.dtype ==
                               torch.float32 else a,
                               b.view(torch.int32) if b.dtype ==
                               torch.float32 else b)
        x = gen.mixed_scene(20.0, SR, seed=4)
        for a, b in zip(segmented.segmented_pitch_analysis(x, SR, segments=8),
                        segmented.segmented_pitch_analysis(x, SR, segments=8,
                                                           mesh=mesh)):
            np.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_pipelined_feed_is_bitwise_resident_on_the_card(dev, dtype):
    """transfer="pipelined" (page-locked double buffers, copies on a stream
    of their own) gives the resident path's bits on the card, pitch over 9
    steps and onsets over 5, for float32 input and the scene scaled and
    clipped to int16; the pitch path launches K1, K10, K3 and K5 once a
    step with either feed."""
    from audio_analyzer_rs_tpu_torch.models import segmented
    x = gen.mixed_scene(20.0, SR, seed=1)        # with percussion
    if dtype == "int16":
        x = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    mods = (hopper_stft, hopper_extract, hopper_tracker, hopper_noisefloor)
    launches = {}
    outs = {}
    for mode in ("resident", "pipelined"):
        before = [m.LAUNCHES for m in mods]
        outs[mode] = segmented.segmented_pitch_analysis(
            x, SR, segments=4, transfer=mode)
        launches[mode] = [m.LAUNCHES - n for m, n in zip(mods, before)]
    assert launches["pipelined"] == launches["resident"] == [9] * 4
    for a, b in zip(outs["pipelined"], outs["resident"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert outs["resident"][2].any()
    got, want = (segmented.segmented_onset_analysis(
        x, SR, segments=4, chunk_frames=1024, transfer=mode)
        for mode in ("pipelined", "resident"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[0].any()


def test_full_step_against_the_float64_oracle(dev):
    """`make_batched_full_step` at B = 1 on the card against the port's
    `full_chain_np` on 3 s of JAX's divergence scene (its seconds 10-13,
    after the scene's silent opening), at the gates of JAX's
    tests/test_fullchain_divergence.py: stable sets equal on >= 98% of
    frames, onset frames on >= 99.9%, hist against exact AGC on >= 99.9%
    with fired equal."""
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    x = gen.mixed_scene(13.0, SR48, seed=3)[int(10 * SR48):]
    x = x[:(len(x) // 1024) * 1024]
    oracle = sharding.full_chain_np(x, SR48)
    sets_o = [sorted(int(round(float(f) * 10)) for f, _ in fr)
              for fr in oracle["stable"]]
    outs = {}
    for mode in ("hist", "exact"):
        step = sharding.make_batched_full_step(None, SR48, dyn_mode=mode,
                                               device=dev)
        _, out = step(sharding.init_stream_states(1, device=dev), x[None])
        sf, sv = out.stable_freqs[0].cpu().numpy(), \
            out.stable_valid[0].cpu().numpy()
        outs[mode] = ([sorted(int(round(float(f) * 10)) for f in sf[i][sv[i]])
                       for i in range(sf.shape[0])],
                      out.onset_fired[0].cpu().numpy())
    sets_h, fired_h = outs["hist"]
    sets_e, fired_e = outs["exact"]
    assert len(sets_h) == len(sets_o) and any(sets_h)
    assert np.mean([a == b for a, b in zip(sets_h, sets_o)]) >= 0.98
    assert (fired_h == oracle["onset_fired"][:len(fired_h)]).mean() >= 0.999
    assert np.mean([a == b for a, b in zip(sets_h, sets_e)]) >= 0.999
    np.testing.assert_array_equal(fired_h, fired_e)
    assert fired_h.any()
