"""The port's device reducer (ops/reducer.py `reduce_signal`, kernel K6's
plain version on the CPU) against the JAX package's, and K6's algorithm
(csrc/reducer.cu) transcribed to numpy against the plain version.

Tolerances: exact mode bitwise (outputs and final states, NaNs by
position); fast mode within 5% of the stream's peak of JAX's fast mode
(JAX's float32 prefix is itself ~4% off its exact mode; the port composes
the prefix in float64 and stays within 1e-3 of the peak of the exact
mode), the hold counter equal, and both attenuated below the gate.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.ops import reducer as jred
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.ops import hopper_reducer
from audio_analyzer_rs_tpu_torch.ops import reducer as tred
from test_torch_kernels_cuda import reducer_streams
from test_torch_noisefloor_kernel import fma_np

torch.set_num_threads(1)

SR = 48000.0
F32 = np.float32
SOURCE = (Path(tred.__file__).resolve().parent.parent / "csrc"
          / "reducer.cu")


def kernel_constants() -> dict:
    pat = re.compile(r"constexpr float (\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;")
    return {name: F32(float.fromhex(v))
            for name, v in pat.findall(SOURCE.read_text())}


def assert_bits(got, want, msg=""):
    """Equal bit for bit; NaN where the other has NaN (any NaN bits)."""
    g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    w = np.asarray(want)
    if g.dtype == np.float32:
        gn, wn = np.isnan(g), np.isnan(w)
        np.testing.assert_array_equal(gn, wn, err_msg=f"{msg} NaN positions")
        g, w = np.where(gn, 0, g).view(np.uint32), np.where(wn, 0, w).view(
            np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def state_leaves(st):
    return [*st.hp, *st.lp, *st.gate]


def kernel_tile() -> int:
    return int(re.search(r"constexpr int TILE = (\d+);",
                         SOURCE.read_text()).group(1))


def kernel_np(x: np.ndarray, state: list, tile: int | None = None):
    """K6's per-sample body for one stream, in numpy float32: the biquads'
    FMA chains and the gate's release blend rounded once (`fma_np`), every
    other operation on its own, the two constants as the kernel spells
    them.  The gate as the kernel's two warps run it: the envelope and its
    gain below the threshold, then the hold as a count of samples below the
    threshold (z, rebased at each tile) against the count at which the hold
    runs out (lim).  state: [hp x1 x2 y1 y2, lp x1 x2 y1 y2, envelope,
    hold] → (y, state).  tile: the rebase's period (the kernel's TILE by
    default)."""
    k = kernel_constants()
    tile = tile or kernel_tile()
    hp = [F32(c) for c in tred.biquad_coeffs(tred.HPF_FREQ, SR, False)]
    lp = [F32(c) for c in tred.biquad_coeffs(tred.LPF_FREQ, SR, True)]
    rel, c1, hold_samples = tred.gate_params(SR)
    rel, c1 = F32(rel), F32(c1)
    bq = [[F32(v) for v in state[:4]], [F32(v) for v in state[4:8]]]
    env = env_prev = F32(state[8])
    z, lim = 0, int(state[9])
    out = np.empty(len(x), F32)

    def step(q, c, v):
        b0, b1, b2, a1, a2 = c
        x1, x2, y1, y2 = q
        y = fma_np(-a2, y2, fma_np(-a1, y1, fma_np(
            b2, x2, fma_np(b0, v, F32(b1 * x1)))))
        q[:] = [v, x1, y, y1]
        return F32(y)

    x = x.astype(F32)
    for t0 in range(0, len(x), tile):
        lim, z = max(lim - z, -1), 0
        for i in range(t0, min(t0 + tile, len(x))):
            lo = step(bq[1], lp, step(bq[0], hp, x[i]))
            # The envelope and the gain below the threshold.
            a = F32(abs(lo))
            blend = fma_np(rel, env, F32(c1 * a))
            env = a if a > env else F32(blend)
            low = F32(F32(F32(F32(env * env) * env) * env) * k["GAIN_SCALE"])
            # The hold and the gated sample.
            above = env >= k["THRESHOLD"]
            if a > env_prev:
                lim = z + hold_samples
            keep = above or z < lim
            out[i] = F32(lo * (F32(1.0) if keep else low))
            z += 0 if above else 1
            env_prev = env
    hold = max(lim - z, 0)
    return out, [*bq[0], *bq[1], env, hold]


def jax_stream(x: np.ndarray, state=None, mode="exact"):
    st = jred.reducer_init() if state is None else state
    st, y = jred.reduce_signal(st, jnp.asarray(x), SR, mode)
    return st, np.asarray(y)


def jax_leaves(st):
    return [np.asarray(a) for a in (*st.hp, *st.lp, *st.gate)]


@pytest.fixture(scope="module")
def streams():
    return reducer_streams(4, 4800, seed=3)


def test_kernel_constants_are_the_plain_versions():
    assert kernel_constants() == {"THRESHOLD": F32(tred.THRESHOLD),
                                  "GAIN_SCALE": F32(tred.GAIN_SCALE)}
    inv = F32(F32(1.0) / F32(10.0 ** (jred.GATE_THRESHOLD_DB / 20.0)))
    assert F32(tred.GAIN_SCALE) == F32(F32(F32(inv * inv) * inv) * inv)


def test_exact_matches_jax_bitwise(streams):
    """Four streams in one batched call against JAX's 1-D scan each: the
    quiet stream's gate holds, releases and attenuates, the NaN stream
    carries its NaN, the silent one stays zero."""
    st, y = tred.reduce_signal(tred.reducer_init("cpu", (4,)),
                               torch.from_numpy(streams), SR)
    for i, x in enumerate(streams):
        jst, jy = jax_stream(x)
        assert_bits(y[i], jy, f"stream {i}")
        for a, b in zip(state_leaves(st), jax_leaves(jst)):
            assert_bits(a[i], b, f"stream {i} state")
    quiet = y[1, 4800 // 3 + 2000:].abs()
    assert 0 < float(quiet.max()) < 1e-4 * float(y[1].abs().max())
    assert torch.isnan(y[2, 2400:]).all() and not torch.isnan(y[2, :2400]).any()
    assert not y[3].any()


def test_streaming_equals_one_chunk(streams):
    x = torch.from_numpy(streams)
    st0 = tred.reducer_init("cpu", (4,))
    st_a, y_a = tred.reduce_signal(st0, x[:, :1700], SR)
    st_b, y_b = tred.reduce_signal(st_a, x[:, 1700:], SR)
    st_f, y_f = tred.reduce_signal(st0, x, SR)
    assert_bits(torch.cat([y_a, y_b], 1), y_f.numpy())
    for a, b in zip(state_leaves(st_b), state_leaves(st_f)):
        assert_bits(a, b.numpy())


def test_batched_equals_per_stream(streams):
    """A batched call equals the 1-D calls (the JAX signature's `[]` state
    case), bit for bit."""
    x = torch.from_numpy(streams[:, :2000].copy())
    st, y = tred.reduce_signal(tred.reducer_init("cpu", (4,)), x, SR)
    for i in range(4):
        st1, y1 = tred.reduce_signal(tred.reducer_init("cpu"), x[i], SR)
        assert y1.shape == (2000,) and st1.gate.envelope.shape == ()
        assert_bits(y1, y[i].numpy())
        for a, b in zip(state_leaves(st1), state_leaves(st)):
            assert_bits(a, b[i].numpy())


def test_jax_state_carries_into_the_port(streams):
    """JAX's state after a first chunk, carried across by
    `interop.reducer_state`, continues bitwise in the port."""
    x = streams[1]
    jst, _ = jax_stream(x[:3000])
    st = interop.reducer_state(jst, "cpu")
    jst2, jy2 = jax_stream(x[3000:], jst)
    st2, y2 = tred.reduce_signal(st, torch.from_numpy(x[3000:].copy()), SR)
    assert_bits(y2, jy2)
    for a, b in zip(state_leaves(st2), jax_leaves(jst2)):
        assert_bits(a, b)


def test_kernel_np_matches_plain_bitwise(streams):
    """K6's transcription against the plain version: the four streams from a
    fresh state and carried into a second chunk, a stream of subnormal
    samples, whose float64 sums sit below float32's normal range, where
    the double-rounding check tests for odd multiples of 2**-150, and
    carried holds of -5, 0, 3 and 700 samples (the last across tiles)."""
    tiny = (np.random.default_rng(5).standard_normal(600)
            * 1e-39).astype(F32)
    cases = [(streams[:, :2000], tred.reducer_init("cpu", (4,)))]
    st_a, _ = tred.reduce_signal(cases[0][1], torch.from_numpy(
        streams[:, :2000].copy()), SR)
    cases.append((streams[:, 2000:3500], st_a))
    cases.append((tiny[None], tred.reducer_init("cpu", (1,))))
    neg = tred.reducer_init("cpu", (4,))
    neg = tred.ReducerState(neg.hp, neg.lp, tred.GateState(
        neg.gate.envelope, torch.tensor([-5, 0, 3, 700], dtype=torch.int32)))
    cases.append((streams[:, 2000:2300], neg))
    assert (np.abs(tiny.astype(np.float64)) < 2.0 ** -126).all()
    for x, st in cases:
        got_st, got = tred.reduce_exact_plain(
            st, torch.from_numpy(np.ascontiguousarray(x)), SR)
        for i in range(x.shape[0]):
            y, leaves = kernel_np(x[i], [float(a[i]) for a in
                                         state_leaves(st)])
            assert_bits(got[i], y, f"stream {i}")
            for a, b in zip(state_leaves(got_st), leaves):
                assert_bits(a[i], np.asarray(b, a.numpy().dtype))


@pytest.mark.parametrize("tile", [1, 7, 64, 128])
def test_kernel_np_hold_count_is_tile_independent(streams, tile):
    """The hold as a count rebased at each tile gives the plain gate's bits
    whatever the tile: a hold carried in (700 samples, across tiles) and
    holds set by attacks run through tile boundaries unchanged."""
    st = tred.reducer_init("cpu", (4,))
    st = tred.ReducerState(st.hp, st.lp, tred.GateState(
        st.gate.envelope, torch.tensor([0, 700, 3, 0], dtype=torch.int32)))
    x = np.ascontiguousarray(streams[:, 1300:2200])
    got_st, got = tred.reduce_exact_plain(st, torch.from_numpy(x), SR)
    for i in range(4):
        y, leaves = kernel_np(x[i], [float(a[i]) for a in state_leaves(st)],
                              tile)
        assert_bits(got[i], y, f"tile {tile} stream {i}")
        assert int(got_st.gate.hold_remaining[i]) == leaves[9]


def test_feedback_paths_agree():
    """The float64 feedback with its double-rounding check and the `fma32`
    loop it falls back to give the same bits where the check passes, and
    the check flags a sum on a float32 midpoint."""
    rng = np.random.default_rng(2)
    ff = torch.from_numpy(rng.standard_normal((3, 400)).astype(F32))
    y1, y2 = torch.zeros(3), torch.zeros(3)
    c = tred.biquad_coeffs(tred.HPF_FREQ, SR, False)
    fast = tred._feedback(ff, y1, y2, -float(c[3]), -float(c[4]))
    a, b, ys = y1, y2, []
    for f in ff.unbind(1):
        b, a = a, tred.fma32(-float(c[4]), b, tred.fma32(-float(c[3]), a, f))
        ys.append(a)
    assert_bits(fast, torch.stack(ys, 1).numpy())
    mid = np.float64(1.0) + np.float64(2.0) ** -24   # 1 + half a float32 ulp
    assert tred._rounds_twice(torch.tensor([mid], dtype=torch.float64))
    assert not tred._rounds_twice(torch.tensor([1.5, 0.0, -2.25],
                                               dtype=torch.float64)).any()
    # Below float32's normal range the midpoints are the odd multiples of
    # 2**-150, half the subnormal spacing; subnormals themselves are not.
    sub = torch.tensor([3.0, -5.0, 4.0, 6.0, 2.0 ** 23 - 1, 2.0 ** 24 - 1],
                       dtype=torch.float64) * 2.0 ** -150
    assert tred._rounds_twice(sub[:, None]).tolist() == [True, True, False,
                                                         False, True, True]
    edge = torch.tensor([2.0 ** -126 + 2.0 ** -150, 2.0 ** -126 + 2.0 ** -149],
                        dtype=torch.float64)[:, None]   # normal: a mid, not one
    assert tred._rounds_twice(edge).tolist() == [True, False]


def test_feedback_subnormal_midpoint_reruns_exact():
    """A feedback sum that lands on a subnormal float32 midpoint: the
    check fires and the plain feedback reruns with `fma32`, bitwise equal
    to the `fma32` loop, also over a decay into the subnormal range."""
    c = tred.biquad_coeffs(tred.HPF_FREQ, SR, False)
    na1, na2 = -float(c[3]), -float(c[4])
    # y[-1] = k * 2**-149 with na1 * y[-1] an odd multiple of 2**-150.
    k = next(k for k in range(1, 1 << 23)
             if (na1 * k * 2.0 ** -149 * 2.0 ** 150) % 2 == 1)
    y1 = torch.tensor([k * 2.0 ** -149], dtype=torch.float32)
    assert tred._rounds_twice(torch.tensor([na1 * float(y1)],
                                           dtype=torch.float64))
    ff = torch.zeros(1, 3000)
    ff[0, 1000] = 1e-30
    fast = tred._feedback(ff, y1, torch.zeros(1), na1, na2)
    a, b, ys = y1, torch.zeros(1), []
    for f in ff.unbind(1):
        b, a = a, tred.fma32(na2, b, tred.fma32(na1, a, f))
        ys.append(a)
    assert_bits(fast, torch.stack(ys, 1).numpy())


def test_fast_mode_matches_jax_fast(streams):
    for i in (0, 1):
        x = streams[i]
        jst_f, yf = jax_stream(x, mode="fast")
        _, ye = jax_stream(x)
        st, y = tred.reduce_signal(tred.reducer_init("cpu"),
                                   torch.from_numpy(x), SR, "fast")
        peak = float(np.abs(ye).max())
        assert float(np.abs(y.numpy() - yf).max()) <= 0.05 * peak
        assert float(np.abs(y.numpy() - ye).max()) <= 1e-3 * peak
        assert float(np.abs(yf - ye).max()) > 1e-3 * peak   # JAX's prefix
        assert int(st.gate.hold_remaining) == int(jst_f.gate.hold_remaining)
        if i == 1:           # below the gate: attenuated in both
            q = slice(4800 // 3 + 2000, None)
            assert float(np.abs(y.numpy()[q]).max()) < 1e-4 * peak
            assert float(np.abs(yf[q]).max()) < 1e-4 * peak


def test_wrapper_checks():
    st = tred.reducer_init("cpu", (2,))
    x = torch.zeros((2, 10))
    hopper_reducer.check_args(st, x)
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        hopper_reducer.check_args(st, x[0])
    with pytest.raises(ValueError, match="state leaf"):
        hopper_reducer.check_args(tred.reducer_init("cpu", (3,)), x)
    with pytest.raises(ValueError, match="contiguous float32"):
        hopper_reducer.check_args(st, x.double())
    with pytest.raises(ValueError, match="mode"):
        tred.reduce_signal(st, x, SR, "approx")
