"""PyTorch port, pitch extraction (kernel K2's module) against the JAX package.

Tolerances:
- `_pre_comb`: pm and is_peak exact; frac_c within a few ulp (torch.log and
  XLA:CPU's log differ in the last bit on ~2% of inputs);
- the plain `_comb`, fed the JAX pm/frac/fund: bitwise equal to the vmapped
  `_comb_xla` and to `comb_pallas(interpret=True)`;
- `extract_pitches`: valid exact; freqs within rtol 1e-5; scores within 2
  ulp of JAX's (the port spells log2 and the division by 15 as XLA folds
  them, so what is left is torch's CPU log against XLA's; see
  tests/test_torch_extract.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu.ops import pitch as jpitch
from audio_analyzer_rs_tpu.ops.pallas_comb import comb_pallas
from audio_analyzer_rs_tpu.ops.stft import stft_mags_np
from audio_analyzer_rs_tpu_torch.ops import hopper_comb
from audio_analyzer_rs_tpu_torch.ops import pitch as tpitch

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
BIN_W = float(np.float32(SR) / np.float32(2048))
KC = 464
MIN_BIN, MAX_BIN = tpitch._bins(BIN_W, HALF, tpitch.MIN_FREQ, tpitch.MAX_FREQ)
RTOL = 1e-5


@pytest.fixture(scope="module")
def spectra():
    """Harmonic tones + noise + a mixed scene: magnitudes [N, 465] and the
    JAX banded floor [N, 464] for them (writable copies for torch)."""
    x = np.concatenate([
        gen.tone_with_harmonics(220.0, 0.4, SR, harmonics=10, amplitude=0.4),
        gen.tone_with_harmonics(523.25, 0.4, SR, harmonics=6, amplitude=0.3),
        gen.mixed_scene(3.0, SR, seed=7),
    ])
    mags = stft_mags_np(x).astype(np.float32)
    gf = np.full(mags.shape[0], jnf.global_floor_linear(-70.0, HALF),
                 np.float32)
    _, eff = jnf.noise_floor_scan(jnf.init_state(HALF), jnp.asarray(mags),
                                  jnp.asarray(gf), KC)
    return np.ascontiguousarray(mags[:, :KC + 1]), np.array(eff)


def _jax_pre(mags, floor):
    return jax.vmap(partial(jpitch._pre_comb, min_bin=MIN_BIN,
                            max_bin=MAX_BIN, kc=KC))(jnp.asarray(mags),
                                                     jnp.asarray(floor))


def test_constants_and_band():
    assert tpitch.candidate_band(BIN_W, HALF) == \
        jpitch.candidate_band(BIN_W, HALF) == KC
    for name in ("MAX_HARMONICS", "MAX_NOTES", "TOP_K", "MIN_FREQ",
                 "MAX_FREQ"):
        assert getattr(tpitch, name) == getattr(jpitch, name)


def test_pre_comb_matches(spectra):
    mags, floor = spectra
    pm_j, frac_j, m_j, peak_j, deg_j = (np.asarray(a)
                                        for a in _jax_pre(mags, floor))
    pm_t, frac_t, m_t, peak_t, deg_t = tpitch._pre_comb(
        torch.from_numpy(mags), torch.from_numpy(floor), MIN_BIN, MAX_BIN,
        KC)
    np.testing.assert_array_equal(pm_t.numpy(), pm_j)
    np.testing.assert_array_equal(peak_t.numpy(), peak_j)
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_array_equal(deg_t.numpy(), deg_j)
    # frac_c is read only at peaks (comb scores and the top-K pickup are
    # masked to peaks); there it is within a few ulp.  Off peaks an
    # ill-conditioned parabola (denominator near 0) may amplify one log ulp.
    frac_t = frac_t.numpy()
    ulp = np.spacing(np.abs(frac_j).astype(np.float32))
    assert float((np.abs(frac_t - frac_j) / ulp)[peak_j].max()) <= 4
    assert float((frac_t != frac_j).mean()) < 0.01


def test_plain_comb_bitwise_vs_xla(spectra):
    mags, floor = spectra
    pm, frac, fund, _, _ = _jax_pre(mags, floor)
    ref = jax.jit(jax.vmap(
        lambda p, f, m: jpitch._comb_xla(p, f, m, HALF, MAX_BIN)))(
            pm, frac, fund)
    got = tpitch._comb(*(torch.from_numpy(np.array(a))
                         for a in (pm, frac, fund)), HALF, MAX_BIN)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int((np.asarray(ref[2]) > 0).sum()) > 0   # harmonics were found


def test_plain_comb_bitwise_vs_pallas_interpret(spectra):
    mags, floor = spectra
    pm, frac, fund, _, _ = _jax_pre(mags[:16], floor[:16])
    ref = comb_pallas(pm, frac, fund, HALF, interpret=True)
    got = tpitch._comb(*(torch.from_numpy(np.array(a))
                         for a in (pm, frac, fund)), HALF)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_extract_pitches_matches_jax(spectra):
    mags, floor = spectra
    ref = jpitch.extract_pitches(jnp.asarray(mags), jnp.asarray(floor), BIN_W,
                                 true_half=HALF)
    got = tpitch.extract_pitches(torch.from_numpy(mags),
                                 torch.from_numpy(floor), BIN_W,
                                 true_half=HALF)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 20
    np.testing.assert_allclose(got.freqs.numpy()[valid],
                               np.asarray(ref.freqs)[valid], rtol=RTOL)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(ref.scores)[valid], rtol=RTOL)
    ulps = np.abs(got.scores.numpy()[valid].view(np.int32).astype(np.int64)
                  - np.asarray(ref.scores)[valid].view(np.int32))
    assert ulps.max() <= 2


def test_extract_pitches_matches_numpy_oracle(spectra):
    mags, floor = spectra
    full = stft_mags_np(gen.tone_with_harmonics(
        330.0, 0.3, SR, harmonics=8, amplitude=0.4)).astype(np.float32)
    nf = np.full((full.shape[0], HALF), 1e-3, np.float32)
    got = tpitch.extract_pitches(torch.from_numpy(full),
                                 torch.from_numpy(nf), BIN_W)
    for i in range(full.shape[0]):
        want = jpitch.extract_pitches_np(full[i], nf[i], BIN_W)
        v = got.valid[i].numpy()
        assert v.sum() == len(want)
        np.testing.assert_allclose(got.freqs[i].numpy()[v],
                                   [f for f, _ in want], rtol=RTOL)
        np.testing.assert_allclose(got.scores[i].numpy()[v],
                                   [s for _, s in want], rtol=RTOL)


def test_top_k_ties_break_to_the_lower_bin():
    """Equal scores must rank the lower bin first, as lax.top_k does."""
    n = 4
    mags = np.full((n, KC + 1), 1e-3, np.float32)
    for k in (100, 150, 200, 250):     # equal isolated peaks, no harmonics
        mags[:, k] = 1.0
    floor = np.full((n, KC), 1e-4, np.float32)
    ref = jpitch.extract_pitches(jnp.asarray(mags), jnp.asarray(floor), BIN_W,
                                 true_half=HALF)
    got = tpitch.extract_pitches(torch.from_numpy(mags),
                                 torch.from_numpy(floor), BIN_W,
                                 true_half=HALF)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(ref.freqs))


def test_k2_wrapper_takes_plain_version_on_cpu(spectra):
    mags, floor = spectra
    pm, frac, m_c, _, _ = tpitch._pre_comb(torch.from_numpy(mags[:8]),
                                           torch.from_numpy(floor[:8]),
                                           MIN_BIN, MAX_BIN, KC)
    before = hopper_comb.LAUNCHES
    got = hopper_comb.comb(pm, frac, m_c.contiguous(), HALF, MAX_BIN)
    assert hopper_comb.LAUNCHES == before
    for g, r in zip(got, tpitch._comb(pm, frac, m_c, HALF, MAX_BIN)):
        assert torch.equal(g, r)
