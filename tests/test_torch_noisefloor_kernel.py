"""Kernel K5's algorithm (csrc/noisefloor.cu), transcribed to numpy, against
the plain floor scan, bitwise; the exactness of its shortcut; the chain
probe's recurrence against the kernel's (port_tools/k5_chain.cu); and the
wrapper's argument checks.

`kernel_np` is what one stream's lanes of K5 do, run for all bins at once:
numpy float32 operations, each rounded on its own, the two fused steps
rounded once (`fma_np`), the constants read from the kernel's source as it
spells them (hex floats), `above` decided from the residual m - 1.5 d
rounded once and `vn`'s quotient computed only where the kernel computes
it (`floor_step_np`), and the state above the band written as the kernel
writes it.
Its max and min keep a NaN (np.maximum / np.minimum, the kernel's max_nan /
min_nan), so it holds the kernel's NaN rules to the plain scan too.  It is
the CPU check of the kernel's literals, of which expressions it fuses and of
the divisions it skips; the card test (tests/test_torch_kernels_cuda.py)
holds the kernel itself to `noise_floor_scan_plain`, on `edge_cases()`
too.
"""

from fractions import Fraction
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


def kernel_constants(source=SOURCE) -> dict:
    """`constexpr float NAME = <hex>f;` of csrc/noisefloor.cu."""
    pat = re.compile(r"constexpr float (\w+) = (0x[0-9a-fA-F.]+p[-+]?\d+)f;")
    return {name: F32(float.fromhex(v))
            for name, v in pat.findall(source.read_text())}


K = kernel_constants()


def fma_np(a, b, c):
    """a*b + c rounded once to float32 (numpy float32 operands): the exact
    float64 product, the sum made round-to-odd in float64 by TwoSum."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        p = a * b
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        odd = s.view(np.int64) & 1
        s = np.where((err != 0) & (odd == 0),
                     np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return s.astype(F32)


def div_where(n, d, mask):
    """n / d (IEEE, float32) where mask holds, 0 elsewhere: the lanes that
    divide."""
    out = np.zeros(np.broadcast(n, d).shape, F32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        np.divide(n, d, out=out, where=mask)
    return out


def above_np(m, d):
    """The kernel's `above > 1.5` for d = max(floor, 0.01): the residual
    m - 1.5 d rounded once (`fma_np`) against d 2^-24, no quotient."""
    with np.errstate(invalid="ignore", over="ignore"):
        return fma_np(-K["NOTE_RATIO"], d, m) > d * K["RATIO_MIDPOINT"]


def floor_step_np(m, floor, prev, vol):
    """The kernel's `floor_step` for every bin → (floor, prev, vol, the
    bins that divide)."""
    with np.errstate(invalid="ignore", over="ignore"):
        delta = np.abs(m - prev)
        v = (vol * K["VOL_MEMORY"]) + (delta * K["VOL_NEW"])
        rising = m > floor
        above = above_np(m, np.maximum(floor, K["FLOOR_EPS"]))
        mm = np.maximum(m, K["MAG_EPS"])
        div = rising
        vn = np.minimum(np.maximum(div_where(v, mm, div), F32(0)),
                        F32(1)).astype(F32)
        sustained = rising & above & (vn < K["NOTE_VOL_MAX"])
        alpha = np.where(rising,
                         fma_np(vn, K["FAST_MINUS_BASE"], K["BASE_ALPHA"]),
                         K["RELEASE"]).astype(F32)
        floor = np.where(sustained, floor,
                         fma_np(alpha, m - floor, floor)).astype(F32)
    return floor, m, v.astype(F32), div


def kernel_np(floor, prev, vol, init, mags, gf, band, counts=None):
    """One stream: the state leaves [H] (float32) and init (bool), mags [N,
    width >= band], gf [N] → (floor, prev, vol [H], effective [N, band]).
    Step for step the kernel's lanes: the band scanned, the first frame of
    a fresh stream by the first-frame rule; the columns above the band
    copied, or seeded from a full-width first frame.  `counts`, a dict,
    gathers the steps and the divisions."""
    floor, prev, vol = (np.array(a, F32) for a in (floor, prev, vol))
    half, n = floor.shape[0], mags.shape[0]
    if not init and mags.shape[1] >= half:
        first = mags[0, band:half].astype(F32)
        floor[band:] = np.maximum(first, F32(gf[0]) * K["INIT_SCALE"])
        prev[band:] = first
    f, p, v = floor[:band], prev[:band], vol[:band]
    eff = np.empty((n, band), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(n):
            m, g = mags[i, :band].astype(F32), F32(gf[i])
            if init:
                rising = int((m > f).sum())
                f, p, v, div = floor_step_np(m, f, p, v)
                if counts is not None:
                    for key, val in (("steps", m.size),
                                     ("rising", rising),
                                     ("div", int(div.sum())),
                                     ("div_tiny", int(
                                         (div & (np.abs(v) < 2.0 ** -126))
                                         .sum()))):
                        counts[key] = counts.get(key, 0) + val
            else:
                f, p = np.maximum(m, g * K["INIT_SCALE"]).astype(F32), m
            init = True
            eff[i] = np.minimum(f, g * K["EFFECTIVE_SCALE"])
    floor[:band], prev[:band], vol[:band] = f, p, v
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
    plain = {
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
    assert K == {**plain, "RATIO_MIDPOINT": K["RATIO_MIDPOINT"]}
    assert K["FAST_MINUS_BASE"] == F32(tnf._FAST_MINUS_BASE32)
    assert K["BASE_ALPHA"] == F32(tnf._BASE32)


def test_shortcut_bounds_are_exact():
    """The derivation of floor_step's constant (csrc/noisefloor.cu), in
    exact rationals: RN(q) > 1.5 exactly when q > 1.5 + RATIO_MIDPOINT
    (the midpoint between 1.5 and the next float, a tie rounding to the
    even 1.5)."""
    q = Fraction
    one_and_a_half = q(float(K["NOTE_RATIO"]))
    assert one_and_a_half == q(3, 2)
    ulp = q(1, 2 ** 23)                     # of floats in [1, 2)
    assert q(float(K["RATIO_MIDPOINT"])) == ulp / 2
    assert np.float32(1.5).view(np.uint32) % 2 == 0      # 1.5 is even


def test_chain_probe_runs_the_kernels_floor_recurrence():
    """port_tools/k5_chain.cu, K5's chain bound, times floor_step's floor
    recurrence: the same constants, the same residual test and fused
    update, the max that keeps a NaN, and a rising step's alpha that of
    vn = 0 (fmaf(0, 0.31, 0.04) = 0.04)."""
    chain_src = (Path(__file__).resolve().parent.parent / "port_tools"
                 / "k5_chain.cu")
    chain = kernel_constants(chain_src)
    assert chain and all(chain[name] == K[name] for name in chain)
    assert fma_np(F32(0), K["FAST_MINUS_BASE"], K["BASE_ALPHA"]) \
        == chain["BASE_ALPHA"]
    text = chain_src.read_text()
    for line in ("const bool rising = m > floor;",
                 "const float d = max_nan(floor, FLOOR_EPS);",
                 "fmaf(-NOTE_RATIO, d, m) > __fmul_rn(d, RATIO_MIDPOINT);",
                 "floor = fmaf(alpha, __fsub_rn(m, floor), floor);",
                 'asm("max.NaN.f32 %0, %1, %2;"'):
        assert line in text and line in SOURCE.read_text(), line


def _f32s(rng, n, lo=-40, hi=40):
    return (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(lo, hi, n)
            ).astype(F32)


def _ulps(x, k):
    """x moved by k float32 ulps (k an int array)."""
    return (x.view(np.int32) + k.astype(np.int32)).view(F32)


def test_residual_decides_above_exactly():
    """m > floor, d = max(floor, 0.01): the kernel's residual test equals
    RN(m / d) > 1.5 for m within 2,000 ulps of 1.5 d, exactly at 1.5 d's
    neighbours, far from it, and at the ends of the range (d near FLT_MAX,
    m = +inf or FLT_MAX, residuals that overflow)."""
    rng = np.random.default_rng(11)
    n = 200_000
    d = np.maximum(_f32s(rng, n, -20, 30), F32(0.01))
    big = np.float32(np.finfo(F32).max)
    d[:6] = [big, big / F32(1.5), big / F32(1.49999), F32(0.01),
             F32(0.01), F32(1e30)]
    with np.errstate(over="ignore"):
        m = _ulps((d * F32(1.5)).astype(F32), rng.integers(-2000, 2001, n))
    far = rng.random(n) < 0.2
    m[far] = (d[far] * rng.uniform(0.0, 4.0, far.sum())).astype(F32)
    m[:6] = [np.inf, big, big, F32(0.015), F32(1.5) * F32(0.01), np.inf]
    floor = np.where(rng.random(n) < 0.1, F32(0.001), d).astype(F32)
    ok = m > floor
    m, floor = m[ok], floor[ok]
    d = np.maximum(floor, F32(0.01))
    with np.errstate(over="ignore"):
        want = (m / d).astype(F32) > F32(1.5)
    np.testing.assert_array_equal(above_np(m, d), want)
    assert want.any() and not want.all()


def _assert_bits_nan(got, want, msg=""):
    got = np.asarray(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), msg)
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32), msg)


def assert_kernel_np_matches_plain(st, mags, gf, band, counts=None):
    """kernel_np stream by stream against noise_floor_scan_plain on numpy
    inputs (state leaves [S, H], init [S], mags [S, N, W], gf [S, N]):
    every state leaf across the full width H and the effective floors,
    bitwise, NaNs by position."""
    state = tnf.NoiseFloorState(*(torch.from_numpy(np.array(a)) for a in st))
    got_st, got_eff = tnf.noise_floor_scan_plain(
        state, torch.from_numpy(mags), torch.from_numpy(gf), band)
    b = band or st[0].shape[-1]
    for s in range(mags.shape[0]):
        floor, prev, vol, eff = kernel_np(
            st[0][s], st[1][s], st[2][s], bool(st[3][s]), mags[s], gf[s], b,
            counts)
        _assert_bits_nan(got_eff[s].numpy(), eff, f"effective {s}")
        for name, leaf, want in zip(tnf.NoiseFloorState._fields, got_st,
                                    (floor, prev, vol)):
            _assert_bits_nan(leaf[s].numpy(), want, f"{name} {s}")
    assert got_st.initialized.all()
    return got_st


def _np_state(st):
    return tuple(t.numpy().copy() for t in st)


@pytest.mark.parametrize("width,band", [(BAND + 1, BAND), (HALF, None),
                                        (HALF, BAND)])
def test_kernel_np_matches_plain_bitwise(scene, width, band):
    """Fresh states, then the state carried into a second call with one
    stream reset to uninitialized: banded magnitudes at band 464 (the
    segmented step; the tail frozen), full width with band=None, and
    full-width magnitudes at band 464 (the tail seeded on a fresh stream,
    frozen on the others); every leaf across the full width."""
    mags, gf = scene
    mags = np.ascontiguousarray(mags[..., :width])
    st = _np_state(tnf.init_state(HALF, "cpu", (3,)))
    for lo, hi in ((0, 70), (70, 120)):
        got = assert_kernel_np_matches_plain(
            st, mags[:, lo:hi].copy(), gf[:, lo:hi].copy(), band)
        st = _np_state(got)
        st[3][1] = False


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
    st = _np_state(tnf.init_state(HALF, "cpu", (3,)))
    got = assert_kernel_np_matches_plain(st, mags, gf, BAND)
    assert got.floor.isnan().any()


# ── Cases the kernel's shortcuts could break ─────────────────────────────

EDGE_H, EDGE_B = 80, 70          # three warps: two full, one of 6 lanes


def _odd_values():
    big = np.finfo(F32).max
    return np.array([0.005, 0.0, -0.0, -3.0, np.nan, np.inf, -np.inf,
                     1e-40, 1e-45, big, 0.01, 0.02, 1.0, 37.5, 1e20],
                    F32)


def edge_cases() -> dict:
    """name → ((floor, prev, vol [S, H], init [S]), mags [S, N, W], gf [S,
    N], band): numpy inputs that K5's shortcuts could get wrong, for
    kernel_np here and for K5 on the card (tests/test_torch_kernels_cuda.py).
    The state is 80 wide and the band 70 (None: the full width)."""
    rng = np.random.default_rng(31)
    h, b = EDGE_H, EDGE_B
    cases = {}

    def state(s, floor=None, prev=None, vol=None, init=True):
        z = np.zeros((s, h), F32)
        return tuple(np.broadcast_to(x if x is not None else z, (s, h))
                     .astype(F32).copy() for x in (floor, prev, vol)) + (
            np.broadcast_to(np.asarray(init), (s,)).copy(),)

    # > 400 frames of digital silence after a loud section: v and the
    # floor go subnormal; stream 1 comes back loud at frame 560.
    n = 600
    mags = np.zeros((2, n, b + 1), F32)
    mags[:, :100] = rng.exponential(1.0, (2, 100, b + 1))
    mags[1, 560:] = rng.exponential(1.0, (40, b + 1))
    cases["silence_after_loud"] = (state(2, init=False), mags,
                                   np.full((2, n), 1e-3, F32), b)

    # m within a few ulps of 1.5 max(floor, 0.01), both sides, and further
    # out (the bounds decide); delta 0 and vol 0, so sustained == above.
    floors = np.array([0.001, 0.0099, 0.01, 0.02, 1.0, 37.5, 1e20, -1.0,
                       -np.inf, 0.0], F32)
    odd = np.nextafter(np.array([1.0, 0.02, 37.5, 1e20], F32), F32(np.inf))
    floors = np.concatenate([floors, odd])          # odd last bits
    ks = np.array([-2, -1, 0, 1, 2])                 # 14 x 5 = 70 bins
    fl = np.repeat(floors, ks.size)[:b]
    k = np.tile(ks, floors.size)[:b]
    m0 = _ulps((np.maximum(fl, F32(0.01)) * F32(1.5)).astype(F32), k)
    n = 12
    mags = np.empty((1, n, b + 1), F32)
    mags[0, :, :b] = m0 * np.linspace(1.0, 1.2, n, dtype=F32)[:, None]
    mags[0, :, b] = 1.0
    fl_h = np.zeros(h, F32)
    fl_h[:b] = fl
    pv_h = np.zeros(h, F32)
    pv_h[:b] = m0
    cases["near_one_and_a_half_floors"] = (
        state(1, fl_h, pv_h), mags, np.full((1, n), 1e-3, F32), b)

    # Odd handed-in states: floors below 0.01, zero, -0, negative, NaN,
    # +-inf, subnormal, FLT_MAX; the same for prev and vol; magnitudes with
    # zeros, +inf, huge and subnormal values.
    odd = _odd_values()
    n = 24
    s = 3
    pick = rng.integers(0, odd.size, (3, s, h))
    st = tuple(odd[pick[i]] for i in range(3)) + (
        np.array([True, True, False]),)
    mags = rng.exponential(0.5, (s, n, h)).astype(F32)
    spots = rng.random((s, n, h))
    mags[spots < 0.15] = 0.0
    mags[(spots > 0.15) & (spots < 0.17)] = np.inf
    mags[(spots > 0.17) & (spots < 0.19)] = np.finfo(F32).max
    mags[(spots > 0.19) & (spots < 0.21)] = F32(1e-42)
    cases["odd_states"] = (st, mags, rng.uniform(1e-3, 0.05, (s, n))
                           .astype(F32), b)

    # m > floor with a subnormal (or zero) v: floor 0.001, prev = m so
    # delta is 0, vol subnormal (vn's division takes its slow path); then
    # a floor held by the ratio.
    n = 6
    m = rng.uniform(0.02, 2.0, (1, 1, b + 1)).astype(F32)
    mags = np.repeat(m, n, axis=1)
    vols = np.zeros(h, F32)
    vols[:b] = np.where(np.arange(b) % 2, F32(1e-40), F32(0.0))
    cases["rising_with_subnormal_v"] = (
        state(1, np.full(h, 0.001, F32), np.pad(m[0, 0], (0, h - b - 1)),
              vols), mags, np.full((1, n), 1e-3, F32), b)

    # Full-width magnitudes on fresh (the tail seeded) and initialized (the
    # tail frozen) streams, a handed-in state; band 70 and band None.
    n = 9
    mags = rng.exponential(0.3, (4, n, h)).astype(F32)
    handed = rng.uniform(0.0, 2.0, (3, 4, h)).astype(F32)
    init = np.array([False, True, False, True])
    gf = rng.uniform(1e-3, 0.05, (4, n)).astype(F32)
    cases["full_width_tail"] = (tuple(handed) + (init,), mags, gf, b)
    cases["full_width_scan"] = (tuple(handed) + (init,), mags, gf, None)
    return cases


EDGE = edge_cases()


@pytest.mark.parametrize("name", sorted(EDGE))
def test_kernel_np_matches_plain_on_edge_cases(name):
    st, mags, gf, band = EDGE[name]
    counts = {}
    got = assert_kernel_np_matches_plain(st, mags, gf, band, counts)
    assert counts["div"] == counts["rising"]
    if name == "silence_after_loud":
        vol = got.volatility.numpy()[:, :EDGE_B]
        assert ((vol != 0) & (np.abs(vol) < 2.0 ** -126)).any()
        assert counts["div_tiny"] == 0
    if name == "rising_with_subnormal_v":
        assert counts["div_tiny"] > 0


def test_kernel_np_divides_only_where_needed(scene):
    """On a scene (silence and notes), the transcription divides on the
    steps whose magnitude is above the floor only, and never with a zero
    or subnormal numerator: the subnormal volatilities of silence fall on
    steps that do not rise."""
    mags, gf = scene
    mags = np.ascontiguousarray(mags[..., :BAND + 1])
    counts = {}
    assert_kernel_np_matches_plain(
        _np_state(tnf.init_state(HALF, "cpu", (3,))), mags, gf, BAND, counts)
    assert 0 < counts["div"] <= counts["rising"] < counts["steps"] / 2
    assert counts["div_tiny"] == 0


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
