"""The port's Hopper kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`: each test skips (inside its fixture) when no CUDA device is
present.  On a machine with a card and no JAX, run them without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Small shapes of the main path's kinds; chip_smoke.py repeats the checks at
the full main-path shapes and times them.  Tolerances: K1 max |Δ| <= 1e-5 ·
max (3xTF32 on the tensor cores against cuBLAS FP32), and bitwise across
batch geometries; K2, K3, K4 and K5 bitwise (K3's, K4's and K5's floats as
bit patterns, so -0.0 and +0.0 differ).
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import (hopper_comb,
                                             hopper_noisefloor, hopper_onset,
                                             hopper_stft, hopper_tracker,
                                             noisefloor, onset, pitch,
                                             tracker)
from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
from test_torch_comb_loop import edge_rows
from test_torch_tracker_select import _outside_state as outside_state
from test_torch_tracker_select import _random_raws as k3_random_raws
from test_torch_tracker_select import assert_same_bits

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SR = 44100.0
W, HOP, HALF = 2048, 512, 1025
BIN_W = float(np.float32(SR) / np.float32(W))
KC = pitch.candidate_band(BIN_W, HALF)
MIN_BIN, MAX_BIN = pitch._bins(BIN_W, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)


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
    """The same frames give the same bits in batches of 1, 63, 64, 65 and
    129 frames starting at other tile rows, as [N, W] views, as a
    contiguous copy and as [S, F, W] views."""
    x = torch.from_numpy(
        gen.mixed_scene(5.0, SR, seed=4)
        + gen.tone_with_harmonics(330.0, 5.0, SR, harmonics=6,
                                  amplitude=0.3)).to(dev)
    trig = rdft_trig(W, dev)[:, :2 * (KC + 1)]
    win = hann(W, dev)
    full = hopper_stft.dft_mag(frame_signal(x, W, HOP), trig, win)
    starts = (0, 37, 200)
    for b in (1, 63, 64, 65, 129):
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


def _k4_inputs(dev, s, n, seed=5):
    """Random magnitudes with bursts, global floors, and sprinkled tick and
    hold frames: mags [S, N, 129], the rest [S, N]."""
    rng = np.random.default_rng(seed)
    mags = (rng.random((s, n, onset.HALF)) * 2.0).astype(np.float32)
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


@pytest.mark.parametrize("s,n", [(133, 150), (5, 0), (1, 4096), (3, 31)])
def test_k4_matches_plain_bitwise(dev, s, n):
    """More streams than SMs with a partial tile, no frames, one long
    stream, and less than one tile."""
    launches = hopper_onset.LAUNCHES
    _, out = _assert_k4_matches_plain(
        onset.init_state(onset.HALF, dev, (s,)), _k4_inputs(dev, s, n, s + n))
    assert hopper_onset.LAUNCHES == launches + 1
    if n >= 150:
        assert bool(out.detected.any())


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
    """On CUDA tensors noise_floor_scan is the one kernel launch (and the
    tail's few torch ops)."""
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
