"""PyTorch port, noise floor against the JAX package: bitwise.

The same magnitudes go to both.  The port rounds the two fused
multiply-adds exactly as XLA:CPU's contraction does (float64, rounded once),
so it equals `noise_floor_scan(band=464)` and `noise_floor_np(fma=True)`
bit for bit.
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
