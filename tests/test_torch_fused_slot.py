"""The live engine's fused per-slot program, `fused_slot_step`, against the
JAX package's over 40 live slots (1,024 samples at 48 kHz), from fresh
states made by `interop` from the JAX ones: ramp-up slots (the first has
no pitch frame and leaves the pending flag to the next), calibration-hold
slots (fires do not reach the tracker), tick-suppressed frames and a
global floor that moves every slot.  Each side carries its own states,
tails and pending flag from slot to slot, as the engines do.

The K-lane form (the engine pool's lanes), the chained aggregate and the
pool wave's packed layout are held bitwise to one-lane calls, and the
pool's layout to the JAX package's `unpack_fused_pool_out`, at the end of
the file.

Tolerances, stated once:
- decisions exact: fired, detected, energy_rising, burst_count,
  frames_since, stable valid, and the pending flag;
- the ring tails bitwise (they are slices of the input);
- stable frequencies within 0.1 Hz, stable scores within rtol 1e-5;
- onset flux and energy within rtol 1e-6 (the known drift of the sums'
  order against XLA's; the 256-point FFTs differ by less);
- onset velocity within rtol 1e-5 + 1e-6 absolute: it is the largest
  ratio of a bin's magnitude to its floor (over 50, capped at 1), which
  carries the 256-point FFTs' difference (rtol 1e-5, as
  tests/test_torch_onset.py holds `OnsetAnalyzer`), and for a quiet bin
  the FFTs' ~5e-7 absolute difference is ~1e-5 relative;
- the states: the onset state's floats within 1e-6 of its largest
  magnitude or value; the noise floor's three leaves within 1e-5 of its
  largest floor or magnitude (the pitch STFT's summation order, as
  tests/test_torch_segmented.py states it; the volatility is a magnitude
  difference and carries the magnitudes' absolute error); the trackers'
  decisions exact and their frequencies within 0.1 Hz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import analyzer as janalyzer
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu.ops import onset as jonset
from audio_analyzer_rs_tpu.ops import tracker as jtracker
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.models import analyzer as tanalyzer
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import noisefloor, onset, tracker
from audio_analyzer_rs_tpu_torch.utils.framing import num_frames

torch.set_num_threads(1)

SR = 48000.0
SLOT = 1024
SLOTS = 40
HOLD_SLOTS = 12
P_WIN, P_HOP, O_WIN, O_HOP = 2048, 512, 256, 64


def _batched(state):
    """A JAX state (unbatched) → numpy leaves with a stream axis of 1."""
    return type(state)(*(np.asarray(leaf)[None] for leaf in state))


def _host_vec(slot, gf_db, hold, tick):
    gfp = float(jnf.global_floor_linear(gf_db, P_WIN // 2 + 1))
    gfo = float(jnf.global_floor_linear(gf_db, O_WIN // 2 + 1))
    return np.concatenate([slot, np.asarray([gfp, gfo, float(hold)],
                                            np.float32),
                           tick.astype(np.float32)]).astype(np.float32)


@pytest.fixture(scope="module")
def run():
    x = gen.mixed_scene(SLOTS * SLOT / SR + 0.1, SR, seed=11)
    click = gen.calibration_click(SR, volume=0.7)
    for t in (0.08, 0.19, 0.33, 0.52, 0.7):
        x[int(t * SR):int(t * SR) + len(click)] += click
    rng = np.random.default_rng(3)
    j = (jnf.init_state(P_WIN // 2 + 1), jtracker.init_state(),
         jonset.init_state(O_WIN // 2 + 1), jnp.asarray(False),
         jnp.zeros(0, jnp.float32), jnp.zeros(0, jnp.float32))
    carries = interop.fused_carries(False, np.zeros(0), np.zeros(0), "cpu")
    t = (interop.noise_floor_state(_batched(j[0]), "cpu"),
         interop.tracker_state(_batched(j[1]), "cpu"),
         interop.onset_state(_batched(j[2]), "cpu"), *carries)
    p_len = o_len = 0
    slots = []
    for k in range(SLOTS):
        n_p = num_frames(p_len + SLOT, P_WIN, P_HOP)
        n_o = num_frames(o_len + SLOT, O_WIN, O_HOP)
        host_vec = _host_vec(x[k * SLOT:(k + 1) * SLOT],
                             rng.uniform(-90.0, -50.0), k < HOLD_SLOTS,
                             rng.random(n_o) < 0.15)
        *j, j_out = janalyzer.fused_slot_step(
            *j, jnp.asarray(host_vec), SR, SLOT, p_len, o_len)
        *t, t_vec = tanalyzer.fused_slot_step(
            *t, torch.from_numpy(host_vec), SR, SLOT)
        slots.append(dict(n_p=n_p, n_o=n_o, jax=jax.device_get(j_out),
                          vec=t_vec.numpy(),
                          port=tanalyzer.unpack_fused_out(t_vec.numpy(),
                                                          n_p, n_o),
                          j_carry=jax.device_get(tuple(j)),
                          t_carry=tuple(t)))
        p_len += SLOT - n_p * P_HOP
        o_len += SLOT - n_o * O_HOP
    return slots


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_ramp_and_geometry(run):
    counts = [(s["n_p"], s["n_o"]) for s in run]
    assert counts[0] == (0, 13) and counts[1][0] == 1
    assert {n for n, _ in counts[2:]} == {2}
    for s in run:
        assert s["port"].stable_freqs.shape == (s["n_p"], 8)
        assert s["port"].onset.fired.shape == (s["n_o"],)


def test_decisions_equal(run):
    fired = 0
    for k, s in enumerate(run):
        j, t = s["jax"], s["port"]
        np.testing.assert_array_equal(_np(t.stable_valid), j.stable_valid,
                                      err_msg=f"slot {k}")
        for name in ("fired", "detected", "energy_rising", "burst_count",
                     "frames_since"):
            np.testing.assert_array_equal(
                _np(getattr(t.onset, name)), getattr(j.onset, name),
                err_msg=f"slot {k} {name}")
        fired += int(j.onset.fired.sum())
    assert fired >= 3, "the scene's clicks must fire"
    assert any(s["jax"].stable_valid.any() for s in run)


def test_floats_within_tolerance(run):
    for k, s in enumerate(run):
        j, t = s["jax"], s["port"]
        v = j.stable_valid
        np.testing.assert_allclose(_np(t.stable_freqs)[v], j.stable_freqs[v],
                                   rtol=0, atol=0.1, err_msg=f"slot {k}")
        np.testing.assert_allclose(_np(t.stable_scores)[v],
                                   j.stable_scores[v], rtol=1e-5,
                                   err_msg=f"slot {k}")
        for name in ("flux", "energy"):
            np.testing.assert_allclose(
                _np(getattr(t.onset, name)), getattr(j.onset, name),
                rtol=1e-6, atol=0, err_msg=f"slot {k} {name}")
        np.testing.assert_allclose(_np(t.onset.velocity), j.onset.velocity,
                                   rtol=1e-5, atol=1e-6, err_msg=f"slot {k}")


def test_carries_within_tolerance(run):
    """Every slot's carries: tails bitwise, pending equal, the states
    within the docstring's tolerances."""
    for k, s in enumerate(run):
        (j_nf, j_tr, j_os, j_pend, j_pt, j_ot) = s["j_carry"]
        (t_nf, t_tr, t_os, t_pend, t_pt, t_ot) = s["t_carry"]
        np.testing.assert_array_equal(_np(t_pt).view(np.uint32),
                                      np.asarray(j_pt).view(np.uint32))
        np.testing.assert_array_equal(_np(t_ot).view(np.uint32),
                                      np.asarray(j_ot).view(np.uint32))
        assert t_pend.shape == (1,) and bool(t_pend[0]) == bool(j_pend)
        scale = float(np.abs(j_os.prev_mag).max()) or 1.0
        for name in ("prev_mag", "floor", "threshold", "energy_ema"):
            np.testing.assert_allclose(
                _np(getattr(t_os, name))[0], getattr(j_os, name),
                rtol=0, atol=1e-6 * max(scale, float(np.abs(
                    getattr(j_os, name)).max())), err_msg=f"slot {k} {name}")
        for name in ("floor_init", "frames_since_onset"):
            np.testing.assert_array_equal(_np(getattr(t_os, name))[0],
                                          getattr(j_os, name))
        nf_scale = max(float(np.abs(j_nf.floor).max()),
                       float(np.abs(j_nf.prev_mag).max()))
        for name in ("floor", "prev_mag", "volatility"):
            np.testing.assert_allclose(
                _np(getattr(t_nf, name))[0], getattr(j_nf, name), rtol=0,
                atol=1e-5 * nf_scale, err_msg=f"slot {k} {name}")
        assert bool(t_nf.initialized[0]) == bool(j_nf.initialized)
        for name in ("life", "valid", "seq", "next_seq"):
            np.testing.assert_array_equal(_np(getattr(t_tr, name))[0],
                                          getattr(j_tr, name))
        np.testing.assert_allclose(_np(t_tr.freq)[0], j_tr.freq, rtol=0,
                                   atol=0.1)


def test_pack_round_trip_and_jax_unpack(run):
    """The port's packed vector: the JAX package's unpack reads it as the
    port's does, and packing the unpacked leaves gives it back."""
    for s in run[:4]:
        vec, n_p, n_o = s["vec"], s["n_p"], s["n_o"]
        assert vec.dtype == np.float32
        assert len(vec) == tanalyzer.fused_out_len(n_p, n_o) \
            == janalyzer.fused_out_len(n_p, n_o)
        mine = s["port"]
        theirs = janalyzer.unpack_fused_out(vec, n_p, n_o)
        for b, c in zip((*mine[:3], *mine.onset),
                        (*theirs[:3], *theirs.onset)):
            np.testing.assert_array_equal(b, c)
            assert b.dtype == c.dtype
        again = tanalyzer.FusedSlotOut(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in mine[:3]),
            tanalyzer.OnsetChunkOut(*(torch.from_numpy(a)
                                      for a in mine.onset)))
        np.testing.assert_array_equal(
            tanalyzer.pack_fused_out(again).numpy().view(np.uint32),
            vec.view(np.uint32))
    with pytest.raises(ValueError, match="values"):
        tanalyzer.unpack_fused_out(np.zeros(5, np.float32), 1, 1)


def test_pending_survives_a_slot_without_pitch_frames():
    """A 128-sample slot from fresh tails has no pitch and no onset frame:
    the pending flag and both tails pass through, as in the JAX step."""
    slot = gen.mixed_scene(0.01, SR, seed=2)[:128]
    host_vec = _host_vec(slot, -70.0, False, np.zeros(0, bool))
    j = (jnf.init_state(P_WIN // 2 + 1), jtracker.init_state(),
         jonset.init_state(O_WIN // 2 + 1), jnp.asarray(True),
         jnp.zeros(0, jnp.float32), jnp.zeros(0, jnp.float32))
    t = (interop.noise_floor_state(_batched(j[0]), "cpu"),
         interop.tracker_state(_batched(j[1]), "cpu"),
         interop.onset_state(_batched(j[2]), "cpu"),
         *interop.fused_carries(True, np.zeros(0), np.zeros(0), "cpu"))
    *j, j_out = janalyzer.fused_slot_step(*j, jnp.asarray(host_vec), SR, 128,
                                          0, 0, pack=True)
    *t, t_out = tanalyzer.fused_slot_step(*t, torch.from_numpy(host_vec), SR,
                                          128)
    assert t_out.shape == np.asarray(j_out).shape == (0,)
    assert bool(t[3][0]) and bool(j[3])
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
    np.testing.assert_array_equal(t[5].numpy(), np.asarray(j[5]))
    with pytest.raises(ValueError, match="host_vec"):
        tanalyzer.fused_slot_step(*t, torch.from_numpy(host_vec), SR, 64)


def _fresh(device="cpu"):
    """One lane's fresh carries, as a port engine holds them."""
    return tanalyzer.PoolCarries(
        noisefloor.init_state(P_WIN // 2 + 1, device, (1,)),
        tracker.init_state(device, (1,)),
        onset.init_state(O_WIN // 2 + 1, device, (1,)),
        torch.zeros(1, dtype=torch.bool), torch.zeros(0), torch.zeros(0))



def _same(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.shape == b.shape and torch.equal(a, b)


def _lane_scenes():
    """Three lanes' host vectors for 12 slots: clicks, a moving floor, tick
    suppression, lane 1 holding calibration for the first 8 slots."""
    rng = np.random.default_rng(5)
    click = gen.calibration_click(SR, volume=0.7)
    xs = []
    for seed in (11, 23, 42):
        x = gen.mixed_scene(0.4, SR, seed=seed)
        for t in rng.uniform(0.02, 0.25, 2):
            x[int(t * SR):int(t * SR) + len(click)] += click
        xs.append(x)
    vecs, p_len, o_len = [], 0, 0
    for k in range(12):
        n_p = num_frames(p_len + SLOT, P_WIN, P_HOP)
        n_o = num_frames(o_len + SLOT, O_WIN, O_HOP)
        vecs.append([_host_vec(x[k * SLOT:(k + 1) * SLOT],
                               rng.uniform(-90.0, -50.0),
                               lane == 1 and k < 8, rng.random(n_o) < 0.15)
                     for lane, x in enumerate(xs)])
        p_len += SLOT - n_p * P_HOP
        o_len += SLOT - n_o * O_HOP
    return vecs


def test_lanes_match_one_lane_calls_bitwise():
    """`fused_slot_step` over 3 lanes (plus an inert zero lane) against
    each lane's one-lane call, for 12 slots from fresh carries: the packed
    outputs (lane by lane through `unpack_fused_pool_out`, which reads
    them as the JAX package's does) and every carry bit for bit."""
    vecs = _lane_scenes()
    solo = [tuple(_fresh()) for _ in range(3)]
    pool = [_fresh() for _ in range(4)]
    for k, slot_vecs in enumerate(vecs):
        rows = np.stack(slot_vecs + [np.zeros_like(slot_vecs[0])])
        stacked = tanalyzer.stack_carries(pool)
        *new, out = tanalyzer.fused_slot_step(
            *stacked, torch.from_numpy(rows), SR, SLOT)
        pool = tanalyzer.unstack_carries(tanalyzer.PoolCarries(*new), 4)
        n_p = num_frames(stacked.p_tail.shape[1] + SLOT, P_WIN, P_HOP)
        n_o = num_frames(stacked.o_tail.shape[1] + SLOT, O_WIN, O_HOP)
        lanes = tanalyzer.unpack_fused_pool_out(out.numpy(), 4,
                                                [(n_p, n_o)])[0]
        theirs = janalyzer.unpack_fused_pool_out(out.numpy(), 4,
                                                 [(n_p, n_o)])[0]
        for lane in range(3):
            *solo_c, vec = tanalyzer.fused_slot_step(
                *solo[lane], torch.from_numpy(slot_vecs[lane]), SR, SLOT)
            solo[lane] = tuple(solo_c)
            one = tanalyzer.unpack_fused_out(vec.numpy(), n_p, n_o)
            for a, b, c in zip((*one[:3], *one.onset),
                               (*lanes[lane][:3], *lanes[lane].onset),
                               (*theirs[lane][:3], *theirs[lane].onset)):
                assert a.dtype == b.dtype == c.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"slot {k}")
                np.testing.assert_array_equal(a, c, err_msg=f"slot {k}")
            for a, b in zip(_leaves(solo[lane]), _leaves(pool[lane])):
                assert _same(a, b), f"slot {k} lane {lane}"
    assert bool(pool[1].pending[0]) is False


def _leaves(carries):
    return [leaf for part in carries
            for leaf in (part if isinstance(part, tuple) else (part,))]


def test_aggregate_matches_per_slot_calls_bitwise():
    """`fused_slot_agg_step` over 4 chained slots against 4
    `fused_slot_step` calls, 12 slots of 3 lanes and of one lane: the
    packed outputs and every carry bit for bit, the noise-floor leaves
    included (the JAX package allows those ulp drift)."""
    vecs = _lane_scenes()
    for lanes in (3, 1):
        per = agg = tanalyzer.stack_carries([_fresh() for _ in range(lanes)])
        if lanes == 1:
            per = agg = tuple(_fresh())
        for a0 in range(0, 12, 4):
            outs = []
            for slot_vecs in vecs[a0:a0 + 4]:
                hv = (torch.from_numpy(np.stack(slot_vecs[:lanes]))
                      if lanes > 1 else torch.from_numpy(slot_vecs[0]))
                *per, out = tanalyzer.fused_slot_step(*per, hv, SR, SLOT)
                outs.append(out)
            hv = (np.concatenate([np.stack(v[:lanes]) for v in
                                  vecs[a0:a0 + 4]], axis=1) if lanes > 1
                  else np.concatenate([v[0] for v in vecs[a0:a0 + 4]]))
            *agg, out = tanalyzer.fused_slot_agg_step(
                *agg, torch.from_numpy(hv), SR, SLOT, 4)
            assert _same(out, torch.cat(outs))
            for a, b in zip(_leaves(per), _leaves(agg)):
                assert _same(a, b), f"lanes {lanes} slots {a0}"
    with pytest.raises(ValueError, match="host_vec"):
        tanalyzer.fused_slot_agg_step(*agg, torch.from_numpy(hv[:-1]), SR,
                                      SLOT, 4)


def test_pool_step_layout_round_trip():
    """`fused_slot_pool_step` for 2 engines padded to 3 lanes, 2 chained
    slots a wave: the packed wave unpacks (port and JAX package alike) to
    each engine's own `fused_slot_agg_step` result, lane by lane; the
    carries come back as per-engine views of one stacked tensor a leaf."""
    vecs = _lane_scenes()
    engines = [tuple(_fresh()) for _ in range(2)]
    p_len = o_len = 0
    for a0 in range(0, 8, 2):
        pad = _fresh()._replace(p_tail=torch.zeros(p_len),
                                o_tail=torch.zeros(o_len))
        counts = tanalyzer.slot_frame_counts(SLOT, 2, p_len, o_len)
        rows = [np.concatenate([vecs[a0][k], vecs[a0 + 1][k]])
                for k in range(2)]
        rows.append(np.zeros_like(rows[0]))
        states, packed = tanalyzer.fused_slot_pool_step(
            list(engines) + [pad], torch.from_numpy(np.stack(rows)), SR,
            SLOT, 2)
        got = tanalyzer.unpack_fused_pool_out(packed.numpy(), 3, counts)
        theirs = janalyzer.unpack_fused_pool_out(packed.numpy(), 3, counts)
        for k in range(2):
            *new, vec = tanalyzer.fused_slot_agg_step(
                *engines[k], torch.from_numpy(rows[k]), SR, SLOT, 2)
            off = 0
            for a, (n_p, n_o) in enumerate(counts):
                ln = tanalyzer.fused_out_len(n_p, n_o)
                one = tanalyzer.unpack_fused_out(vec.numpy()[off:off + ln],
                                                 n_p, n_o)
                off += ln
                for x, y, z in zip((*one[:3], *one.onset),
                                   (*got[a][k][:3], *got[a][k].onset),
                                   (*theirs[a][k][:3], *theirs[a][k].onset)):
                    np.testing.assert_array_equal(x, y)
                    np.testing.assert_array_equal(x, z)
            for x, y in zip(_leaves(new), _leaves(states[k])):
                assert _same(x, y)
            engines[k] = tuple(states[k])
        assert states[0].p_tail._base is states[1].p_tail._base
        p_len += sum(SLOT - n_p * P_HOP for n_p, _ in counts)
        o_len += sum(SLOT - n_o * O_HOP for _, n_o in counts)
    with pytest.raises(ValueError, match="unpack"):
        tanalyzer.unpack_fused_pool_out(packed.numpy()[:-1], 3, counts)
