"""PyTorch port, noise floor against the JAX package: bitwise.

The same magnitudes go to both.  The port rounds the two fused
multiply-adds exactly as XLA:CPU's contraction does (once, `rounding.fma32`),
so it equals `noise_floor_scan(band=464)` and `noise_floor_np(fma=True)`
bit for bit.  `noise_floor_scan` on CPU tensors is `noise_floor_scan_plain`;
both are held to JAX here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu.ops.stft import stft_mags_np
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.ops import noisefloor as tnf
from audio_analyzer_rs_tpu_torch.ops import rounding

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
BAND = 464


@pytest.fixture(scope="module")
def mags_gf():
    x = gen.mixed_scene(6.0, SR, seed=2)
    mags = stft_mags_np(x).astype(np.float32)        # [N, 1025]
    rng = np.random.default_rng(0)
    db = rng.uniform(-96.0, -40.0, mags.shape[0])
    gf = np.array([jnf.global_floor_linear(float(d), HALF) for d in db],
                  np.float32)
    return mags, gf


def _port_scan(state, mags, gf, band):
    return tnf.noise_floor_scan(state, torch.from_numpy(mags),
                                torch.from_numpy(gf), band)


def _jax_state_np(state):
    return jnf.NoiseFloorState(*(np.asarray(a) for a in state))


def test_global_floor_linear_bit_equal():
    for db in (-96.0, -60.5, -20.0, 0.0):
        assert tnf.global_floor_linear(db, HALF) == \
            jnf.global_floor_linear(db, HALF)


@pytest.mark.parametrize("band", [BAND, None])
def test_floor_scan_bitwise(mags_gf, band):
    mags, gf = mags_gf
    st_j, eff_j = jnf.noise_floor_scan(jnf.init_state(HALF),
                                       jnp.asarray(mags), jnp.asarray(gf),
                                       band)
    st_t, eff_t = _port_scan(tnf.init_state(HALF, "cpu"), mags, gf, band)
    np.testing.assert_array_equal(eff_t.numpy(), np.asarray(eff_j))
    for leaf_t, leaf_j in zip(interop.to_numpy(st_t), _jax_state_np(st_j)):
        np.testing.assert_array_equal(leaf_t, leaf_j)
    width = BAND if band else HALF
    oracle = jnf.noise_floor_np(mags, gf, fma=True)[:, :width]
    np.testing.assert_array_equal(eff_t.numpy(), oracle)


def test_banded_magnitudes_freeze_the_tail(mags_gf):
    mags, gf = mags_gf
    banded = np.ascontiguousarray(mags[:, :BAND + 1])
    st_j, eff_j = jnf.noise_floor_scan(jnf.init_state(HALF),
                                       jnp.asarray(banded), jnp.asarray(gf),
                                       BAND)
    st_t, eff_t = _port_scan(tnf.init_state(HALF, "cpu"), banded, gf, BAND)
    np.testing.assert_array_equal(eff_t.numpy(), np.asarray(eff_j))
    for leaf_t, leaf_j in zip(interop.to_numpy(st_t), _jax_state_np(st_j)):
        np.testing.assert_array_equal(leaf_t, leaf_j)


def test_state_carry_and_jax_handoff(mags_gf):
    """Two calls with the state carried equal one call; a mid-stream JAX
    state handed to the port continues bitwise."""
    mags, gf = mags_gf
    k = mags.shape[0] // 2
    _, eff_full = _port_scan(tnf.init_state(HALF, "cpu"), mags, gf, BAND)
    st_a, eff_a = _port_scan(tnf.init_state(HALF, "cpu"), mags[:k], gf[:k],
                             BAND)
    _, eff_b = _port_scan(st_a, mags[k:], gf[k:], BAND)
    np.testing.assert_array_equal(
        np.concatenate([eff_a.numpy(), eff_b.numpy()]), eff_full.numpy())

    st_j, _ = jnf.noise_floor_scan(jnf.init_state(HALF),
                                   jnp.asarray(mags[:k]),
                                   jnp.asarray(gf[:k]), BAND)
    handed = interop.noise_floor_state(jax.tree.map(np.asarray, st_j), "cpu")
    _, eff_h = _port_scan(handed, mags[k:], gf[k:], BAND)
    np.testing.assert_array_equal(eff_h.numpy(), eff_b.numpy())


def test_segment_axis_rows_are_independent(mags_gf):
    """A leading stream axis runs each row as its own recurrence."""
    mags, gf = mags_gf
    stack = np.stack([mags[:40], mags[40:80]])
    gfs = np.stack([gf[:40], gf[40:80]])
    _, eff = _port_scan(tnf.init_state(HALF, "cpu", (2,)), stack, gfs, BAND)
    for r in range(2):
        _, one = _port_scan(tnf.init_state(HALF, "cpu"), stack[r], gfs[r],
                            BAND)
        np.testing.assert_array_equal(eff[r].numpy(), one.numpy())


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _midpoint_triples(rng, n):
    """a*b + c whose exact value lies just below a float32 midpoint of c:
    c has an odd last bit, a*b = half an ulp of c times (1 - 2^-46).  The
    float64 sum rounds onto the midpoint, so rounding it again to float32
    (ties to even) misses by one ulp; one rounding does not."""
    c = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    c = (c.view(np.uint32) | np.uint32(1)).view(np.float32)
    half_ulp = np.spacing(c).astype(np.float64) / 2.0
    e = np.log2(half_ulp).astype(np.int64)
    e1 = rng.integers(-10, 10, n)
    a = (2.0 ** e1 * (1 + 2.0 ** -23)).astype(np.float32)
    b = (2.0 ** (e - e1) * (1 - 2.0 ** -23)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return a * sign, b, c * sign


def test_fma32_rounds_once_like_jax():
    """rounding.fma32 against jitted JAX x*y + z on the CPU (which XLA
    contracts into a hardware FMA): the constructed case, a family of
    near-midpoint sums where rounding twice misses, and random triples."""
    jfma = jax.jit(lambda x, y, z: x * y + z)
    f32 = np.float32

    def port(a, b, c):
        return rounding.fma32(*(torch.from_numpy(np.asarray(v, f32))
                                for v in (a, b, c))).numpy()

    def twice(a, b, c):
        return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
                + np.asarray(c, np.float64)).astype(f32)

    one = (f32(2.0 ** -12 * (1 + 2.0 ** -23)),
           f32(2.0 ** -12 * (1 - 2.0 ** -23)), f32(1 + 2.0 ** -23))
    assert _bits(jfma(*one)) == 0x3F800001
    assert _bits(port(*one)) == 0x3F800001
    assert _bits(twice(*one)) == 0x3F800002       # the old double rounding

    rng = np.random.default_rng(7)
    a, b, c = _midpoint_triples(rng, 1000)
    want = _bits(jfma(a, b, c))
    np.testing.assert_array_equal(_bits(port(a, b, c)), want)
    assert (_bits(twice(a, b, c)) != want).all()

    n = 4000
    a = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-20, 20, n)
         * rng.choice([-1, 1], n)).astype(f32)
    b = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-20, 20, n)).astype(f32)
    c = (-(a.astype(np.float64) * b) * rng.uniform(0.5, 2.0, n)).astype(f32)
    np.testing.assert_array_equal(_bits(port(a, b, c)),
                                  _bits(jfma(a, b, c)))


@pytest.mark.parametrize("band,banded", [(BAND, False), (BAND, True),
                                         (None, False)])
def test_plain_scan_bitwise_carried_and_handed_over(mags_gf, band, banded):
    """noise_floor_scan_plain itself, in two calls with the state carried and
    with a JAX state handed over, against one JAX call and the numpy
    oracle; banded magnitudes (465 columns) freeze the tail."""
    mags, gf = mags_gf
    if banded:
        mags = np.ascontiguousarray(mags[:, :BAND + 1])
    k = mags.shape[0] // 3
    st_j, eff_j = jnf.noise_floor_scan(jnf.init_state(HALF),
                                       jnp.asarray(mags), jnp.asarray(gf),
                                       band)

    def plain(st, lo, hi):
        return tnf.noise_floor_scan_plain(st, torch.from_numpy(mags[lo:hi]),
                                          torch.from_numpy(gf[lo:hi]), band)

    st_a, eff_a = plain(tnf.init_state(HALF, "cpu"), 0, k)
    st_b, eff_b = plain(st_a, k, None)
    np.testing.assert_array_equal(
        np.concatenate([eff_a.numpy(), eff_b.numpy()]), np.asarray(eff_j))
    for leaf_t, leaf_j in zip(interop.to_numpy(st_b), _jax_state_np(st_j)):
        np.testing.assert_array_equal(leaf_t, leaf_j)
    if not banded:
        width = BAND if band else HALF
        np.testing.assert_array_equal(
            eff_b.numpy(), jnf.noise_floor_np(mags, gf, fma=True)[k:, :width])

    st_jk, _ = jnf.noise_floor_scan(jnf.init_state(HALF),
                                    jnp.asarray(mags[:k]),
                                    jnp.asarray(gf[:k]), band)
    handed = interop.noise_floor_state(jax.tree.map(np.asarray, st_jk), "cpu")
    st_h, eff_h = plain(handed, k, None)
    np.testing.assert_array_equal(eff_h.numpy(), eff_b.numpy())
    for leaf_h, leaf_b in zip(st_h, st_b):
        assert torch.equal(leaf_h, leaf_b)


def test_silence_after_loud_and_odd_states_against_jax():
    """The cases the kernel's shortcuts could break (tests/
    test_torch_noisefloor_kernel.py `edge_cases`), through the plain scan
    and JAX's scan from the same state.  Magnitudes within ulps of 1.5x
    the floor, odd floors (below 0.01, negative, -inf) and full-width
    magnitudes on fresh and initialized streams: the effective floors and
    every state leaf bitwise (NaNs by position), except that with
    full-width magnitudes XLA:CPU rounds the volatility's EMA its own way
    on some bins (within 1e-6, as the devtools tests compare it).  > 400
    frames of digital silence after a loud section: bitwise to the FMA
    oracle `noise_floor_np(fma=True)`, subnormals included, and within
    1e-6 of JAX, whose decay through the silence is 1-2 ulps off the
    oracle on a few frames and whose XLA:CPU flushes subnormal results to
    zero (the port keeps them; the cases with subnormal inputs stay out
    for that reason)."""
    from test_torch_noisefloor_kernel import edge_cases

    tiny = 2.0 ** -126
    subnormal = 0

    def bits_nan(got, want, msg):
        nonlocal subnormal
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), msg)
        sub = (got != 0) & (np.abs(got) < tiny)
        subnormal += int(sub.sum())
        ok = ~np.isnan(want) & ~sub
        np.testing.assert_array_equal(got[ok].view(np.uint32),
                                      want[ok].view(np.uint32), msg)
        assert (np.abs(want[sub]) < tiny).all(), msg

    cases = edge_cases()
    for name in ("silence_after_loud", "near_one_and_a_half_floors",
                 "full_width_tail", "full_width_scan"):
        st, mags, gf, band = cases[name]
        state_t = tnf.NoiseFloorState(*(torch.from_numpy(np.array(a))
                                        for a in st))
        st_t, eff_t = tnf.noise_floor_scan_plain(
            state_t, torch.from_numpy(mags), torch.from_numpy(gf), band)
        full = mags.shape[-1] >= st[0].shape[-1]
        for s in range(mags.shape[0]):
            st_j, eff_j = jnf.noise_floor_scan(
                jnf.NoiseFloorState(*(jnp.asarray(a[s]) for a in st)),
                jnp.asarray(mags[s]), jnp.asarray(gf[s]), band)
            if name == "silence_after_loud":
                # XLA:CPU's decay of the floor through the silence is 1-2
                # ulps off the FMA oracle on a few frames; the oracle holds
                # the port bitwise instead.
                np.testing.assert_array_equal(
                    eff_t[s].numpy().view(np.uint32),
                    jnf.noise_floor_np(mags[s], gf[s], fma=True)[:, :band]
                    .view(np.uint32))
                for a, b in zip((eff_t, *st_t[:3]), (eff_j, *st_j[:3])):
                    np.testing.assert_allclose(a[s].numpy(), b, rtol=1e-6,
                                               atol=tiny)
                subnormal += int(((st_t.volatility[s] != 0)
                                  & (st_t.volatility[s].abs() < tiny))
                                 .sum())
                continue
            bits_nan(eff_t[s].numpy(), eff_j, f"{name} effective {s}")
            for field, a, b in zip(("floor", "prev_mag"), st_t, st_j):
                bits_nan(a[s].numpy(), b, f"{name} {field} {s}")
            vol_t = st_t.volatility[s].numpy()
            if full:
                np.testing.assert_allclose(vol_t, st_j.volatility,
                                           rtol=1e-6, atol=tiny)
            else:
                bits_nan(vol_t, st_j.volatility, f"{name} volatility {s}")
    assert subnormal > 0
