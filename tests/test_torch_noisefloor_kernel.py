"""Kernel K5's algorithm (csrc/noisefloor.cu), transcribed to numpy, against
the plain floor scan, bitwise; and the wrapper's argument checks.

`kernel_np` is what one thread of K5 does for its (stream, bin), run for all
bins at once: numpy float32 operations, each rounded on its own, the two
fused steps rounded once (`fma_np`), and the constants read from the
kernel's source as it spells them (hex floats).  Its max and min keep a NaN
(np.maximum / np.minimum, the kernel's max_nan / min_nan), so it holds the
kernel's NaN rules to the plain scan too.  It is the CPU check of the
kernel's literals and of which expressions it fuses; the card test
(tests/test_torch_kernels_cuda.py) holds the kernel itself to
`noise_floor_scan_plain`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import hopper_noisefloor
from audio_analyzer_rs_tpu_torch.ops import noisefloor as tnf
from audio_analyzer_rs_tpu_torch.ops.stft import stft_mags_np

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
BAND = 464
F32 = np.float32
SOURCE = (Path(tnf.__file__).resolve().parent.parent / "csrc"
          / "noisefloor.cu")


def kernel_constants() -> dict:
    """`constexpr float NAME = <hex>f;` of csrc/noisefloor.cu."""
    pat = re.compile(r"constexpr float (\w+) = (0x[0-9a-fA-F.]+p[-+]?\d+)f;")
    return {name: F32(float.fromhex(v))
            for name, v in pat.findall(SOURCE.read_text())}


K = kernel_constants()


def fma_np(a, b, c):
    """a*b + c rounded once to float32 (numpy float32 operands): the exact
    float64 product, the sum made round-to-odd in float64 by TwoSum."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = s.view(np.int64) & 1
    s = np.where((err != 0) & (odd == 0),
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


def div_guarded_np(n, d):
    """The kernel's division: IEEE, with 1 in place of a zero numerator and
    the zero put back unless the divisor is NaN."""
    q = (np.where(n == 0, F32(1), n) / d).astype(F32)
    return np.where((n == 0) & ~np.isnan(d), n, q).astype(F32)


def kernel_np(floor, prev, vol, init, mags, gf):
    """One stream: state [B] (float32) and init (bool), mags [N, B], gf [N]
    → (floor, prev, vol, effective [N, B]).  Line for line the kernel's
    frame body."""
    floor, prev, vol = (np.array(a, F32) for a in (floor, prev, vol))
    eff = np.empty(mags.shape, F32)
    for f in range(mags.shape[0]):
        m, g = mags[f].astype(F32), F32(gf[f])
        delta = np.abs(m - prev)
        v = (vol * K["VOL_MEMORY"]) + (delta * K["VOL_NEW"])
        above = div_guarded_np(m, np.maximum(floor, K["FLOOR_EPS"]))
        vn = np.minimum(np.maximum(div_guarded_np(v, np.maximum(
            m, K["MAG_EPS"])), F32(0)), F32(1))
        sustained = (above > K["NOTE_RATIO"]) & (vn < K["NOTE_VOL_MAX"])
        alpha = np.where(m > floor,
                         fma_np(vn, K["FAST_MINUS_BASE"], K["BASE_ALPHA"]),
                         K["RELEASE"]).astype(F32)
        updated = np.where(sustained, floor,
                           fma_np(alpha, m - floor, floor)).astype(F32)
        floor = (updated if init else
                 np.maximum(m, g * K["INIT_SCALE"])).astype(F32)
        vol = v if init else vol
        prev = m
        init = True
        eff[f] = np.minimum(floor, g * K["EFFECTIVE_SCALE"])
    return floor, prev, vol, eff


@pytest.fixture(scope="module")
def scene():
    """Three streams of a mixed scene's magnitudes [3, 120, 1025] and
    per-frame global floors [3, 120]."""
    x = gen.mixed_scene(4.0, SR, seed=5)
    mags = stft_mags_np(x).astype(F32)
    rng = np.random.default_rng(1)
    gf = np.array([tnf.global_floor_linear(float(d), HALF)
                   for d in rng.uniform(-96.0, -40.0, 3 * 120)], F32)
    return (np.stack([mags[i * 100:i * 100 + 120] for i in range(3)]),
            gf.reshape(3, 120))


def test_kernel_constants_are_the_plain_versions():
    assert K == {
        "VOL_MEMORY": F32(tnf.VOL_MEMORY),
        "VOL_NEW": F32(1.0 - tnf.VOL_MEMORY),
        "FLOOR_EPS": F32(0.01),
        "MAG_EPS": F32(0.05),
        "NOTE_RATIO": F32(tnf.NOTE_RATIO),
        "NOTE_VOL_MAX": F32(tnf.NOTE_VOL_MAX),
        "BASE_ALPHA": F32(tnf.FLOOR_BASE_ALPHA),
        "FAST_MINUS_BASE": F32(tnf.FLOOR_FAST_ALPHA - tnf.FLOOR_BASE_ALPHA),
        "RELEASE": F32(tnf.FLOOR_RELEASE),
        "INIT_SCALE": F32(5.0),
        "EFFECTIVE_SCALE": F32(2.5),
    }
    assert K["FAST_MINUS_BASE"] == F32(tnf._FAST_MINUS_BASE32)
    assert K["BASE_ALPHA"] == F32(tnf._BASE32)


@pytest.mark.parametrize("width,band", [(BAND + 1, BAND), (HALF, None)])
def test_kernel_np_matches_plain_bitwise(scene, width, band):
    """Fresh states, then the state carried into a second call with one
    stream reset to uninitialized: banded magnitudes at band 464 (the
    segmented step) and full width with band=None."""
    mags, gf = scene
    mags = np.ascontiguousarray(mags[..., :width])
    b = band or HALF
    st = tnf.init_state(HALF, "cpu", (3,))
    for lo, hi in ((0, 70), (70, 120)):
        got_st, got_eff = tnf.noise_floor_scan_plain(
            st, torch.from_numpy(mags[:, lo:hi].copy()),
            torch.from_numpy(gf[:, lo:hi].copy()), band)
        for s in range(3):
            floor, prev, vol, eff = kernel_np(
                st.floor[s, :b].numpy(), st.prev_mag[s, :b].numpy(),
                st.volatility[s, :b].numpy(), bool(st.initialized[s]),
                mags[s, lo:hi, :b], gf[s, lo:hi])
            np.testing.assert_array_equal(got_eff[s].numpy().view(np.uint32),
                                          eff.view(np.uint32))
            for leaf, want in zip(got_st[:3], (floor, prev, vol)):
                np.testing.assert_array_equal(
                    leaf[s, :b].numpy().view(np.uint32), want.view(np.uint32))
        init = got_st.initialized.clone()
        init[1] = False
        st = got_st._replace(initialized=init)


def test_kernel_np_matches_plain_with_nans(scene):
    """NaN magnitudes (single bins, a whole frame, a fresh stream's first
    frame) and a NaN global floor: the NaN positions equal and every other
    value bitwise, in the effective floors and the final state."""
    mags, gf = scene
    mags = np.ascontiguousarray(mags[..., :BAND + 1]).copy()
    gf = gf.copy()
    mags[0, 3, 10:14] = np.nan
    mags[1, 40] = np.nan
    mags[2, 0, 100] = np.nan
    gf[2, 60] = np.nan
    st = tnf.init_state(HALF, "cpu", (3,))
    got_st, got_eff = tnf.noise_floor_scan_plain(
        st, torch.from_numpy(mags), torch.from_numpy(gf), BAND)
    assert np.isnan(got_eff.numpy()).any()
    for s in range(3):
        floor, prev, vol, eff = kernel_np(
            st.floor[s, :BAND].numpy(), st.prev_mag[s, :BAND].numpy(),
            st.volatility[s, :BAND].numpy(), False, mags[s, :, :BAND],
            gf[s])
        for got, want in ((got_eff[s], eff), (got_st.floor[s, :BAND], floor),
                          (got_st.prev_mag[s, :BAND], prev),
                          (got_st.volatility[s, :BAND], vol)):
            got = got.numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            np.testing.assert_array_equal(got[ok].view(np.uint32),
                                          want[ok].view(np.uint32))


def _args(s=2, n=5, width=BAND + 1):
    st = tnf.init_state(HALF, "cpu", (s,))
    return (st, torch.zeros((s, n, width)), torch.zeros((s, n)), BAND)


@pytest.mark.parametrize("case", [
    "mags_dtype", "gf_shape", "floor_dtype", "init_dtype", "lead",
    "band_zero", "band_wide", "mags_stride", "state_noncontiguous"])
def test_wrapper_refuses(case):
    st, mags, gf, band = _args()
    if case == "mags_dtype":
        mags = mags.double()
    elif case == "gf_shape":
        gf = gf[:, :4]
    elif case == "floor_dtype":
        st = st._replace(floor=st.floor.half())
    elif case == "init_dtype":
        st = st._replace(initialized=st.initialized.int())
    elif case == "lead":
        mags = mags[:1]
    elif case == "band_zero":
        band = 0
    elif case == "band_wide":
        band = BAND + 2
    elif case == "mags_stride":
        mags = torch.zeros((2, BAND + 1, 5)).transpose(1, 2)
    elif case == "state_noncontiguous":
        st = st._replace(prev_mag=torch.zeros((HALF, 2)).t())
    with pytest.raises(ValueError):
        hopper_noisefloor.check_args(st, mags, gf, band)


def test_wrapper_accepts_the_main_path_and_refuses_other_devices():
    st, mags, gf, band = _args()
    m3 = hopper_noisefloor.check_args(st, mags, gf, band)
    assert m3.shape == (2, 5, BAND + 1)
    one = tnf.init_state(HALF, "cpu")
    assert hopper_noisefloor.check_args(
        one, mags[0], gf[0], band).shape == (1, 5, BAND + 1)
    meta = tnf.NoiseFloorState(*(t.to("meta") for t in st))
    with pytest.raises(ValueError, match="unsupported device"):
        tnf.noise_floor_scan(meta, mags.to("meta"), gf.to("meta"), band)
    with pytest.raises(ValueError, match="full-width"):
        tnf.noise_floor_scan(st, mags, gf, None)
