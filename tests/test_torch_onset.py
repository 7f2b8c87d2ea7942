"""PyTorch port, the onset scan and `OnsetAnalyzer` against the JAX package.

Tolerances and what is exact:
- decisions are equal: fired, detected, burst_count, energy_rising,
  frames_since, frame by frame;
- the per-bin state (prev_mag, floor, floor_init) and frames_since_onset
  are bitwise equal: the port rounds the floor blend once, as XLA:CPU's
  fused multiply-add does (`test_rounding_forms_match_jax_bits` finds the
  forms from JAX's bits);
- flux, energy, velocity, threshold and energy_ema within rtol 1e-6: the
  flux and energy sums run in the port's fixed tree order, XLA's in its
  own (a 129-term float32 sum; measured differences ~1.2e-7 relative).
  With a single contributing bin, where the order cannot matter, flux and
  velocity are bitwise equal;
- `OnsetAnalyzer` adds the 256-point FFT (torch.fft against jnp.fft,
  ~1e-7 relative): its values are held at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from audio_analyzer_rs_tpu.models.analyzer import OnsetAnalyzer as JaxOnset
from audio_analyzer_rs_tpu.ops import onset as jon
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models.analyzer import OnsetAnalyzer
from audio_analyzer_rs_tpu_torch.ops import onset, rounding

torch.set_num_threads(1)

HALF = onset.HALF
SR = 48000.0
RTOL = 1e-6
DECISIONS = ("fired", "detected", "burst_count", "energy_rising",
             "frames_since")
VALUES = ("velocity", "flux", "energy")
f32 = np.float32


def _inputs(case):
    """The three inputs of tests/test_onset.py, plus a calibration-hold
    case: (mags [N, 129], global floor [N], tick [N], hold [N] or None)."""
    rng = np.random.default_rng(0)
    if case == "random":
        n = 60
        mags = (rng.random((n, HALF)) * 2.0).astype(f32)
        mags[20] *= 20.0
        mags[40] *= 25.0
        return mags, np.full(n, 0.05, f32), np.zeros(n, bool), None
    if case == "tick":
        n = 30
        mags = (rng.random((n, HALF)) * 1.0).astype(f32)
        mags[15] *= 30.0
        ts = np.zeros(n, bool)
        ts[15] = True
        return mags, np.full(n, 0.05, f32), ts, None
    if case == "refractory":
        n = 20
        mags = (rng.random((n, HALF)) * 0.5).astype(f32)
        mags[10] *= 40.0
        mags[11] *= 45.0
        return mags, np.full(n, 0.02, f32), np.zeros(n, bool), None
    assert case == "hold"
    n = 120
    mags = (rng.random((n, HALF)) * 1.5).astype(f32)
    for k in (10, 30, 31, 55, 80, 81, 82, 100):
        mags[k] *= 30.0
    hold = np.zeros(n, bool)
    hold[25:60] = True
    return mags, np.full(n, 0.03, f32), np.zeros(n, bool), hold


def _jax(mags, gf, ts, hold, state=None):
    state = jon.init_state(HALF) if state is None else state
    st, out = jon.onset_scan(state, jnp.asarray(mags), jnp.asarray(gf),
                             jnp.asarray(ts),
                             None if hold is None else jnp.asarray(hold))
    return (jon.OnsetState(*(np.asarray(a) for a in st)),
            jon.OnsetFrameOut(*(np.asarray(a) for a in out)))


def _port(mags, gf, ts, hold, state=None):
    """The port's onset_scan on CPU tensors, for one stream ([1, N])."""
    state = onset.init_state(HALF, "cpu", (1,)) if state is None else state
    st, out = onset.onset_scan(
        state, torch.from_numpy(mags)[None], torch.from_numpy(gf)[None],
        torch.from_numpy(ts)[None],
        None if hold is None else torch.from_numpy(hold)[None])
    return st, onset.OnsetFrameOut(*(a[0].numpy() for a in out))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_outputs_agree(got, ref, rtol=RTOL):
    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    for name in VALUES:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=rtol, atol=0, err_msg=name)


def _assert_states_agree(got, ref):
    """got: a port state with a stream axis of 1; ref: the JAX state."""
    for name in ("prev_mag", "floor", "floor_init", "frames_since_onset"):
        np.testing.assert_array_equal(_bits(getattr(got, name)[0].numpy()),
                                      _bits(getattr(ref, name)), err_msg=name)
    for name in ("threshold", "energy_ema"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   getattr(ref, name), rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["random", "tick", "refractory", "hold"])
def test_onset_scan_matches_jax(case):
    mags, gf, ts, hold = _inputs(case)
    st_ref, ref = _jax(mags, gf, ts, hold)
    st, got = _port(mags, gf, ts, hold)
    _assert_outputs_agree(got, ref)
    _assert_states_agree(st, st_ref)
    assert ref.detected.any()
    if case == "tick":
        assert not got.fired[15]
    if case == "hold":
        # Held frames fire, but do not reset the refractory counter.
        held = np.flatnonzero(got.fired & hold)
        assert held.size and (got.frames_since[held + 1] > 0).all()


def test_state_carried_through_interop():
    """A run split in two, the JAX state after the first half handed to the
    port through interop.onset_state: the second half agrees with JAX."""
    mags, gf, ts, hold = _inputs("hold")
    k = 47
    st_mid, _ = _jax(mags[:k], gf[:k], ts[:k], hold[:k])
    st_ref, ref = _jax(mags[k:], gf[k:], ts[k:], hold[k:],
                       state=jon.OnsetState(*(jnp.asarray(a)
                                              for a in st_mid)))
    carried = interop.onset_state(
        jon.OnsetState(*(a[None] for a in st_mid)), "cpu")
    st, got = _port(mags[k:], gf[k:], ts[k:], hold[k:], state=carried)
    _assert_outputs_agree(got, ref)
    _assert_states_agree(st, st_ref)
    back = interop.to_numpy(st)
    assert type(back).__name__ == "OnsetState" and back.floor.shape == (1,
                                                                         HALF)


def test_streams_equal_single_runs():
    """[S = 3] in one call is three S = 1 calls, bit for bit."""
    cases = [_inputs(c) for c in ("random", "tick", "refractory")]
    n = min(len(c[0]) for c in cases)
    stack = [np.stack([c[i][:n] for c in cases]) for i in range(3)]
    st, out = onset.onset_scan(onset.init_state(HALF, "cpu", (3,)),
                               *(torch.from_numpy(a) for a in stack))
    for s, (mags, gf, ts, _) in enumerate(cases):
        st1, one = _port(mags[:n], gf[:n], ts[:n], None)
        for a, b in zip(out, one):
            np.testing.assert_array_equal(_bits(a[s].numpy()), _bits(b))
        for a, b in zip(st, st1):
            np.testing.assert_array_equal(_bits(a[s].numpy()),
                                          _bits(b[0].numpy()))


def _tree_np(x):
    """The tree of tree_sum, element by element in float32."""
    v = [f32(0.0)] * onset.TREE_WIDTH
    v[:len(x)] = [f32(a) for a in x]
    groups = []
    for g in range(0, onset.TREE_WIDTH, 32):
        w = v[g:g + 32]
        k = 16
        while k:
            w = [f32(w[i] + w[i + k]) for i in range(k)]
            k //= 2
        groups.append(w[0])
    k = 4
    while k:
        groups = [f32(groups[i] + groups[i + k]) for i in range(k)]
        k //= 2
    return groups[0]


def test_tree_sum_order():
    """tree_sum is the stated pairwise tree, not a left-to-right sum: 1 and
    128 values of 2^-24 sum to 1 left to right (each add ties to even), but
    nearly 1 + 2^-17 in the tree."""
    y = np.full(129, 2.0 ** -24, f32)
    y[0] = 1.0
    tree = onset.tree_sum(torch.from_numpy(y)).item()
    seq = f32(0.0)
    for v in y:
        seq = f32(seq + v)
    assert seq == 1.0 and abs(tree - 1.0 - 2.0 ** -17) <= 2.0 ** -23
    rng = np.random.default_rng(1)
    for h in (129, 33, 256):
        x = (rng.random(h) * rng.choice([1e-3, 1.0, 1e3], h)).astype(f32)
        assert _bits(onset.tree_sum(torch.from_numpy(x)).numpy()) == \
            _bits(_tree_np(x))


def _fma_np(a, b, c):
    """a*b + c rounded once to float32 (numpy, via the port's helper)."""
    return rounding.fma32(torch.from_numpy(np.asarray(a, f32)),
                          torch.from_numpy(np.asarray(b, f32)),
                          torch.from_numpy(np.asarray(c, f32))).numpy()


def test_rounding_forms_match_jax_bits():
    """Which expressions XLA:CPU rounds once (the method of
    tests/test_divergence_proof.py): a numpy transcription with and without
    the single rounding, held to JAX's bits.

    - the floor blend: fma(rate, m - floor0, floor0) equals JAX's floor
      state bitwise, the two-rounding form does not;
    - the energy EMA and the threshold, given JAX's own per-frame energy
      and flux: fma(old, mem, new*(1 - mem)) equals JAX's final state;
    - a single contributing bin (the others' diff negative), where the sum
      order cannot matter: the port's flux and velocity equal JAX's
      bitwise, with the smoothing's / 3 and the velocity's / 50 as products
      with the float32 reciprocal and the weight fma(-i, 1/129, 1)."""
    rng = np.random.default_rng(3)
    n = 200
    mags = (rng.random((n, HALF)) * 2.0).astype(f32)
    for k in rng.integers(0, n, 16):
        mags[k] *= f32(rng.uniform(5.0, 40.0))
    gf = np.full(n, 0.05, f32)
    st_ref, ref = _jax(mags, gf, np.zeros(n, bool), None)

    floor_fused = floor_plain = None
    ema = thr = f32(0.0)
    for t in range(n):
        m = mags[t]
        f_eps = max(gf[t], f32(0.01))
        outs = []
        for floor, fused in ((floor_fused, True), (floor_plain, False)):
            f0 = np.maximum(m, gf[t]) if floor is None else floor
            r = m / np.maximum(f0, f_eps)
            rate = np.where(m > f0, f32(0.1), f32(0.04)).astype(f32)
            d = (m - f0).astype(f32)
            blend = (_fma_np(rate, d, f0) if fused
                     else (f0 + rate * d).astype(f32))
            outs.append(np.where(r > f32(2.5), m * f32(1.3), blend)
                        .astype(f32))
        floor_fused, floor_plain = outs
        e, fl = ref.energy[t], ref.flux[t]
        mem = f32(0.84) if e > ema else f32(0.95)
        ema = _fma_np(ema, mem, e * (f32(1.0) - mem))[()]
        mem = f32(0.84) if fl > thr else f32(0.89)
        thr = max(_fma_np(thr, mem, fl * (f32(1.0) - mem))[()], f32(0.9))
    np.testing.assert_array_equal(_bits(floor_fused), _bits(st_ref.floor))
    assert (_bits(floor_plain) != _bits(st_ref.floor)).any()
    assert _bits(ema) == _bits(st_ref.energy_ema)
    assert _bits(thr) == _bits(st_ref.threshold)

    # One contributing bin: prev_mag huge except at bin k; two bins'
    # floors tiny, so that two bursts keep the flux past the silence gate.
    for k in (1, 5, 40, 100, 127):
        m = rng.uniform(0.5, 3.0, (24, HALF)).astype(f32)
        prev = np.full(HALF, 1e6, f32)
        prev[k] = 0.0
        floor = np.full(HALF, 1e6, f32)
        floor[10] = floor[20] = 1e-3
        jstate = jon.OnsetState(jnp.asarray(prev), jnp.asarray(floor),
                                jnp.asarray(True), jnp.asarray(f32(0.0)),
                                jnp.asarray(f32(0.0)),
                                jnp.asarray(4, jnp.int32))
        pstate = interop.onset_state(
            jon.OnsetState(prev[None], floor[None], np.array([True]),
                           np.zeros(1, f32), np.zeros(1, f32),
                           np.full(1, 4, np.int32)), "cpu")
        for t in range(len(m)):
            row, g, no = m[t:t + 1], np.full(1, 0.05, f32), np.zeros(1, bool)
            _, want = _jax(row, g, no, None, state=jstate)
            _, got = _port(row, g, no, None, state=pstate)
            assert want.flux[0] > 0
            assert _bits(got.flux) == _bits(want.flux), (k, t)
            assert _bits(got.velocity) == _bits(want.velocity), (k, t)


def _clicks(sr, seed=7, dur=2.0):
    """tests/test_onset.py's scene: clicks every 0.5 s in quiet noise."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(sr * dur)) * 1e-4).astype(f32)
    click = gen.calibration_click(sr, volume=0.8)
    for t in (0.25, 0.75, 1.25, 1.75):
        i = int(t * sr)
        m = max(0, min(len(click), len(x) - i))
        x[i:i + m] += click[:m]
    return x


def test_onset_analyzer_matches_jax():
    x = _clicks(SR)
    ref = JaxOnset(SR).process(x)
    got = OnsetAnalyzer(SR, device="cpu").process(x)
    _assert_outputs_agree(got, onset.OnsetFrameOut(*ref), rtol=1e-5)
    fired = np.flatnonzero(got.fired)
    assert len(fired) >= 4
    for t in (0.25, 0.75, 1.25, 1.75):
        assert np.any(np.abs(fired - int(t * SR) // onset.HOP) <= 6)


def test_onset_analyzer_streaming_equals_one_call():
    x = _clicks(SR, seed=3, dur=0.5)
    full = OnsetAnalyzer(SR, device="cpu").process(x)
    an = OnsetAnalyzer(SR, device="cpu")
    outs = [o for o in (an.process(c) for c in np.array_split(x, 7))
            if o is not None]
    for name in onset.OnsetFrameOut._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(o, name) for o in outs]),
            getattr(full, name), err_msg=name)
    assert an.frames_consumed == len(full.fired)


def test_onset_analyzer_silence_fires_nothing():
    out = OnsetAnalyzer(SR, device="cpu").process(np.zeros(int(SR), f32))
    assert not out.fired.any()
    assert OnsetAnalyzer(SR, device="cpu").process(np.zeros(100, f32)) is None
