"""PyTorch port, tracker (kernel K3's module) against the JAX package.

Inputs are the random polyphonic raws of the JAX Pallas-tracker test.
stable, seq, life, valid, next_seq and score are exact; freq is within
rtol 3e-7, the JAX test's own one-ulp allowance (XLA may contract the EMA
`f*0.6 + raw*0.4` into an FMA; the port never does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.ops import tracker as jtr
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.ops import hopper_tracker
from audio_analyzer_rs_tpu_torch.ops import tracker as ttr

torch.set_num_threads(1)


def _random_raws(rng, s, n):
    rf = rng.uniform(50.0, 2000.0, (s, n, 8)).astype(np.float32)
    # Consecutive frames often match (within 3%), so tracks mature.
    for i in range(1, n):
        keep = rng.random((s, 8)) < 0.7
        rf[:, i] = np.where(keep, rf[:, i - 1] * (1 + rng.normal(
            0, 0.01, (s, 8)).astype(np.float32)), rf[:, i])
    rs = rng.uniform(0.1, 5.0, (s, n, 8)).astype(np.float32)
    rv = rng.random((s, n, 8)) < 0.6
    on = rng.random((s, n)) < 0.08
    return rf, rs, rv, on


def _jax_init(s):
    return jax.vmap(lambda _: jtr.init_state())(jnp.arange(s))


def _assert_outputs_match(got, ref):
    fg, sg, vg = (np.asarray(x) for x in got)
    fr, sr, vr = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(vg, vr)
    np.testing.assert_array_equal(sg, sr)
    np.testing.assert_allclose(fg, fr, rtol=3e-7, atol=0)


def _assert_states_match(got, ref):
    got = interop.to_numpy(got)
    np.testing.assert_allclose(got.freq, np.asarray(ref.freq), rtol=3e-7,
                               atol=0)
    for leaf in ("score", "life", "valid", "seq", "next_seq"):
        np.testing.assert_array_equal(getattr(got, leaf),
                                      np.asarray(getattr(ref, leaf)),
                                      err_msg=leaf)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("s,n", [(3, 40), (8, 17)])
def test_batched_scan_matches_jax(s, n, impl):
    raws = _random_raws(np.random.default_rng(11), s, n)
    st_j, out_j = jtr.tracker_scan_batched(
        _jax_init(s), *(jnp.asarray(a) for a in raws), impl=impl)
    st_t, out_t = ttr.tracker_scan_batched(
        ttr.init_state("cpu", (s,)), *(torch.from_numpy(a) for a in raws))
    _assert_outputs_match(out_t, out_j)
    _assert_states_match(st_t, st_j)
    assert np.asarray(out_j[2]).sum() > 0


def test_state_carry_and_jax_handoff():
    """Two chained calls equal one; a mid-stream JAX state handed to the port
    continues as the JAX scan does."""
    s, n = 4, 24
    rf, rs, rv, on = _random_raws(np.random.default_rng(3), s, 2 * n)
    first = tuple(torch.from_numpy(np.ascontiguousarray(a[:, :n]))
                  for a in (rf, rs, rv, on))
    second = tuple(torch.from_numpy(np.ascontiguousarray(a[:, n:]))
                   for a in (rf, rs, rv, on))
    st0 = ttr.init_state("cpu", (s,))
    st_a, out_a = ttr.tracker_scan_batched(st0, *first)
    st_b, out_b = ttr.tracker_scan_batched(st_a, *second)
    st_f, out_f = ttr.tracker_scan_batched(
        st0, *(torch.from_numpy(a) for a in (rf, rs, rv, on)))
    for a, b, f in zip(out_a, out_b, out_f):
        assert torch.equal(torch.cat([a, b], 1), f)
    for b, f in zip(st_b, st_f):
        assert torch.equal(b, f)

    st_j, _ = jtr.tracker_scan_batched(
        _jax_init(s), *(jnp.asarray(a[:, :n]) for a in (rf, rs, rv, on)),
        impl="xla")
    st_jb, out_jb = jtr.tracker_scan_batched(
        st_j, *(jnp.asarray(a[:, n:]) for a in (rf, rs, rv, on)), impl="xla")
    handed = interop.tracker_state(jax.tree.map(np.asarray, st_j), "cpu")
    st_h, out_h = ttr.tracker_scan_batched(handed, *second)
    _assert_outputs_match(out_h, out_jb)
    _assert_states_match(st_h, st_jb)


def test_single_stream_scan_and_numpy_oracle():
    """tracker_scan (S = 1) against the JAX scan and the list-based oracle."""
    rf, rs, rv, on = (a[0] for a in _random_raws(np.random.default_rng(5),
                                                 1, 30))
    on = np.zeros_like(on)
    st_t, (f_t, s_t, v_t) = ttr.tracker_scan(
        ttr.init_state("cpu"), *(torch.from_numpy(a)
                                 for a in (rf, rs, rv, on)))
    _, ref = jtr.tracker_scan(jtr.init_state(),
                              *(jnp.asarray(a) for a in (rf, rs, rv, on)))
    _assert_outputs_match((f_t, s_t, v_t), ref)
    oracle = jtr.PitchTrackerNp()
    for i in range(len(rf)):
        raw = [(float(f), float(s)) for f, s, v in zip(rf[i], rs[i], rv[i])
               if v]
        want = oracle.process(raw, onset=False)[:8]
        got = [(float(f), float(s)) for f, s, v in
               zip(f_t[i].numpy(), s_t[i].numpy(), v_t[i].numpy()) if v]
        assert len(got) == len(want)
        np.testing.assert_allclose([f for f, _ in got], [f for f, _ in want],
                                   rtol=1e-6)


def test_select_stable_zeroes_unfilled_slots():
    t = ttr.MAX_TRACKS
    freq = torch.arange(1, t + 1, dtype=torch.float32)[None]
    score = freq * 2
    stable = torch.zeros((1, t), dtype=torch.bool)
    stable[0, [3, 7, 20]] = True
    seq = torch.full((1, t), ttr.INT_MAX, dtype=torch.int32)
    seq[0, 3], seq[0, 7], seq[0, 20] = 9, 2, 5
    f, s, v = ttr.select_stable(freq, score, stable, seq)
    fj, sj, vj = jtr.select_stable(*(jnp.asarray(a.numpy())
                                     for a in (freq, score, stable, seq)))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    assert f[0, :3].tolist() == [8.0, 21.0, 4.0] and f[0, 3:].eq(0).all()


def test_k3_wrapper_takes_plain_version_on_cpu():
    raws = tuple(torch.from_numpy(a) for a in
                 _random_raws(np.random.default_rng(8), 2, 6))
    st0 = ttr.init_state("cpu", (2,))
    before = hopper_tracker.LAUNCHES
    st_k, out_k = hopper_tracker.tracker_scan(st0, *raws)
    assert hopper_tracker.LAUNCHES == before
    st_p, emits = ttr.tracker_scan_plain(st0, *raws)
    out_p = ttr.select_stable(*emits)
    assert out_k[0].shape == (2, 6, 8)
    for a, b in zip((*out_k, *st_k), (*out_p, *st_p)):
        assert torch.equal(a, b)
