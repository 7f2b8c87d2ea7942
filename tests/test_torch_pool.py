"""The port's classroom path on the CPU: `EnginePool` (api/pool.py), the
engine's deferred and aggregated readback with speculative calibration,
the K-lane slot program, and checkpoints.

One module fixture drives three 3 s mixed scenes (48 kHz, 1,024-sample
slots, tuner and onset detection, loopback calibration 2,048 samples at
gain 1) three ways, polled every slot, with member 0 checkpointed at slot
100 (`save_engine`, which flushes the pool):
- the JAX package's `EnginePool` at pipeline depth 1 (the reference);
- the port's `EnginePool` at pipeline depth 1;
- solo port engines at depth 0 (seed 11 checkpointed at slot 100).
Port against JAX, per slot: the PR 6 tolerances of tests/test_torch_engine
(dynamics and onset events identical, velocity within 1e-4, tuner labels
and notes identical, cents within 0.02).  Within the port, pooled against
solo: polls, events and every carry bitwise.  Depth 1 with aggregation 4
against depth 0: bitwise, the noise-floor leaves included (a stricter
contract than the JAX package's, which allows them ulp drift).
On the CPU the plain matmul keeps a frame's bits only up to ~130 rows
(2 frames a lane), so pools here stay at a few lanes.
"""

import json

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu import checkpoint as jcheckpoint
from audio_analyzer_rs_tpu.api.device import ArraySource as JaxSource
from audio_analyzer_rs_tpu.api.engine import AudioEngine as JaxEngine
from audio_analyzer_rs_tpu.api.pool import EnginePool as JaxPool
from audio_analyzer_rs_tpu_torch import checkpoint, interop
from audio_analyzer_rs_tpu_torch.api import engine as E
from audio_analyzer_rs_tpu_torch.api.device import ArraySource
from audio_analyzer_rs_tpu_torch.api.pool import EnginePool
from audio_analyzer_rs_tpu_torch.models import analyzer as A
from audio_analyzer_rs_tpu_torch.models import generators as gen

torch.set_num_threads(1)

SR = 48000.0
SLOT_S = 1024 / SR
SECONDS = 3.0
N_SLOTS = int(SECONDS / SLOT_S)          # 140
SEEDS = (11, 23, 42)
CKPT_AT = 100
CENTS_TOL = 0.02
VELOCITY_TOL = 1e-4
TUNER_EXACT = ("label", "notes", "mode", "system", "base_freq", "key",
               "beat_position")

_SCENES: dict = {}


def scene(seed: int, seconds: float = SECONDS, clicks: tuple = ()):
    """mixed_scene(seed), with a calibration click added at each slot of
    `clicks`."""
    key = (seed, seconds, clicks)
    if key not in _SCENES:
        x = gen.mixed_scene(seconds + 0.5, SR, seed=seed)
        click = gen.calibration_click(SR, volume=0.8)
        for slot in clicks:
            at = int((slot + 0.3) * 1024)
            x[at:at + len(click)] += click
        _SCENES[key] = x
    return _SCENES[key]


def member(seed: int, kind: str = "port", seconds: float = SECONDS,
           loopback: bool = True, depth: int = 0, agg: int = 1, skip=0,
           calibrated: bool = False, clicks: tuple = ()):
    """(engine, tuner, onset) over scene(seed) from sample skip*1024;
    `calibrated`: the transport calibrated before onset detection starts,
    so it adds no calibration click."""
    kw = dict(sample_rate=SR)
    if loopback:
        kw.update(loopback_latency_samples=2048, loopback_gain=1.0)
    x = scene(seed, seconds, clicks)[skip * 1024:]
    if kind == "jax":
        e = JaxEngine(input_source=JaxSource(x), **kw)
    else:
        e = E.AudioEngine(input_source=ArraySource(x), device="cpu", **kw)
    e.pipeline_depth, e.aggregate_slots = depth, agg
    if calibrated:
        e.transport.set_calibration_offset(1)
    return e, e.start_tuner(), e.start_onset_detection()


def poll(m):
    e, tuner, onset_det = m
    return (tuner.poll_output(), onset_det.poll_onsets(), e.poll_dynamics())


def consumers(e):
    pc = next(c for c in e._consumers.values()
              if type(c).__name__ == "_PitchConsumer")
    oc = next(c for c in e._consumers.values()
              if type(c).__name__ == "_OnsetConsumer")
    return pc, oc


def carries(e):
    """Every carry of a port engine (fused residency left) as tensors."""
    pc, oc = consumers(e)
    return (*pc.analyzer.nf_state, *pc.analyzer.tr_state, *oc.analyzer.state,
            torch.from_numpy(np.asarray(pc.analyzer._tail)),
            torch.from_numpy(np.asarray(oc.analyzer._tail)),
            torch.tensor([pc.analyzer.frames_consumed,
                          oc.analyzer.frames_consumed,
                          int(e.onset_pending)]))


def assert_same_carries(ea, eb):
    for e in (ea, eb):
        e.flush_analysis()      # hand the carries back (a pool's too)
    for k, (a, b) in enumerate(zip(carries(ea), carries(eb))):
        assert a.shape == b.shape and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b), k


def events(polls):
    return [ev for _, o, _ in polls for ev in json.loads(o)]


def assert_polls_agree(got, want):
    """Per slot, the port's polled JSON against JAX's within the stated
    tolerances (tests/test_torch_engine.py's)."""
    assert len(got) == len(want)
    for k, ((gt, go, gd), (wt, wo, wd)) in enumerate(zip(got, want)):
        assert gd == wd, f"slot {k} dynamics"
        gt, wt = json.loads(gt), json.loads(wt)
        for key in TUNER_EXACT:
            assert gt[key] == wt[key], f"slot {k} tuner {key}"
        assert abs(gt["cents"] - wt["cents"]) <= CENTS_TOL, f"slot {k}"
        np.testing.assert_allclose(gt["accuracies"], wt["accuracies"],
                                   rtol=0, atol=CENTS_TOL,
                                   err_msg=f"slot {k}")
        go, wo = json.loads(go), json.loads(wo)
        assert len(go) == len(wo), f"slot {k} onset count"
        for a, b in zip(go, wo):
            assert a["raw_sample_offset"] == b["raw_sample_offset"]
            assert a["beat_position"] == b["beat_position"]
            assert abs(a["velocity"] - b["velocity"]) <= VELOCITY_TOL


def drive(members, step, at=None, slots=N_SLOTS, final=None):
    """Step `slots` times, polling every member after each step; `at`
    maps a slot index to a callable run just before it; `final` runs
    after the last step, before one more poll of every member."""
    polls = [[] for _ in members]
    for i in range(slots):
        if at and i in at:
            at[i]()
        step()
        for k, m in enumerate(members):
            polls[k].append(poll(m))
    if final is not None:
        final()
        for k, m in enumerate(members):
            polls[k].append(poll(m))
    return polls


class TransitionLog:
    """While active, each post of the port's `_OnsetConsumer` records
    (what `_calibration_transition` predicted, whether the post ended the
    calibration hold)."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        orig = self._orig = E._OnsetConsumer._post
        records = self.records

        def post(oc, out, tick_sup, base, anchor=None):
            if anchor is None:
                anchor = oc.engine._stamp_anchor()
            predicted = oc._calibration_transition(out, base, anchor)
            before = oc.calibration_done
            orig(oc, out, tick_sup, base, anchor=anchor)
            records.append((predicted, not before and oc.calibration_done))
        E._OnsetConsumer._post = post
        return self

    def __exit__(self, *exc):
        E._OnsetConsumer._post = self._orig


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [leaf for x in obj for leaf in _leaves(x)]
    return []


def unwritten(fn, calls):
    """`fn` wrapped: every tensor among its arguments is copied before the
    call and must hold the same bits after it (no op writes into an input
    carry, which the speculative rollback's snapshots rely on)."""
    def run(*args, **kwargs):
        leaves = _leaves(args)
        before = [leaf.clone() for leaf in leaves]
        result = fn(*args, **kwargs)
        for i, (a, b) in enumerate(zip(leaves, before)):
            assert torch.equal(a.view(torch.uint8) if a.numel() else a,
                               b.view(torch.uint8) if b.numel() else b), \
                f"{fn.__name__} wrote into input tensor {i}"
        calls.append(fn.__name__)
        return result
    return run


@pytest.fixture(scope="module")
def classroom(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("classroom")
    log = TransitionLog()
    with log:
        out = _classroom(tmp)
    out["transitions"] = log.records
    return out


def _classroom(tmp):
    out = {"jax_ckpt": str(tmp / "jax.npz"),
           "port_ckpt": str(tmp / "port.npz")}
    # The JAX package's pool (the reference).
    jm = [member(s, "jax") for s in SEEDS]
    jpool = JaxPool([m[0] for m in jm], pipeline_depth=1)
    out["jax_polls"] = drive(
        jm, jpool.step_wave,
        at={CKPT_AT: lambda: jcheckpoint.save_engine(out["jax_ckpt"],
                                                     jm[0][0])},
        final=jpool.flush)
    out["jax"], out["jax_pool"] = jm, jpool
    # The port's pool.
    pm = [member(s) for s in SEEDS]
    pool = EnginePool([m[0] for m in pm], pipeline_depth=1)
    out["port_polls"] = drive(
        pm, pool.step_wave,
        at={CKPT_AT: lambda: checkpoint.save_engine(out["port_ckpt"],
                                                    pm[0][0])},
        final=pool.flush)
    out["port"], out["pool"] = pm, pool
    return out


def test_pool_matches_jax_pool(classroom):
    """The port's pool against the JAX package's, K = 3 at depth 1, slot
    for slot, through calibration (one speculative rollback a member) and
    a mid-stream checkpoint."""
    for k in range(len(SEEDS)):
        assert_polls_agree(classroom["port_polls"][k],
                           classroom["jax_polls"][k])
        assert len(events(classroom["jax_polls"][k])) > 0, f"member {k}"
        e, ej = classroom["port"][k][0], classroom["jax"][k][0]
        assert (e.transport.get_calibration_offset()
                == ej.transport.get_calibration_offset())
        assert e._fused_slots == ej._fused_slots == N_SLOTS
    pool, jpool = classroom["pool"], classroom["jax_pool"]
    assert pool._rollbacks == jpool._rollbacks == len(SEEDS)
    assert pool.waves == jpool.waves > 0


def test_pooled_matches_solo_bitwise(classroom, depth0):
    """Each pooled member (depth 1) against its own solo engine at depth 0:
    the event stream, every slot's dynamics, the last tuner reading and
    every carry bit for bit, and the checkpoints of member 0 at slot 100
    key for key.  (Per slot, deferred readback shifts when a result
    becomes visible, never what it is.)"""
    for k, seed in enumerate(SEEDS):
        pooled = classroom["port_polls"][k]
        m, polls = depth0[seed]
        assert events(pooled) == events(polls), f"member {k}"
        assert [d for _, _, d in pooled] == [d for _, _, d in polls]
        assert pooled[-1][0] == polls[-1][0]
        assert_same_carries(classroom["port"][k][0], m[0])
    a = np.load(classroom["port_ckpt"])
    b = np.load(depth0["ckpt"][CKPT_AT])
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_checkpoint_matches_jax(classroom):
    """The port's and the JAX package's checkpoints of pooled member 0 at
    the same slot: the same keys and JSON; tails, host state and decisions
    equal, state floats within tests/test_torch_fused_slot.py's
    tolerances."""
    a = np.load(classroom["port_ckpt"])
    b = np.load(classroom["jax_ckpt"])
    assert sorted(a.files) == sorted(b.files)
    assert json.loads(bytes(a["meta"]).decode()) == \
        json.loads(bytes(b["meta"]).decode())
    nf_scale = max(float(np.abs(b["tuner_nf_0"]).max()),
                   float(np.abs(b["tuner_nf_1"]).max()))
    on_scale = float(np.abs(b["onset_0"]).max())
    close = {"tuner_nf_0": 1e-5 * nf_scale, "tuner_nf_1": 1e-5 * nf_scale,
             "tuner_nf_2": 1e-5 * nf_scale, "tuner_tr_0": 0.1,
             "tuner_tr_1": 1e-5 * float(np.abs(b["tuner_tr_1"]).max())}
    for i in (0, 1, 3, 4):
        close[f"onset_{i}"] = 1e-6 * max(on_scale,
                                         float(np.abs(b[f"onset_{i}"]).max()))
    for key in a.files:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, \
            key
        if key in close:
            np.testing.assert_allclose(a[key], b[key], rtol=0,
                                       atol=close[key], err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_jax_checkpoint_continues_in_the_port(classroom, tmp_path):
    """The JAX engine's file loads into a fresh port engine, which then runs
    the rest of the scene at depth 1 and polls what the pooled JAX member
    polled after its checkpoint; saved again it is the same file, and the
    JAX package loads the port's file back."""
    e, tuner, onset_det = m = member(SEEDS[0], depth=1, skip=CKPT_AT,
                                     calibrated=True)
    checkpoint.load_engine(classroom["jax_ckpt"], e)
    assert consumers(e)[1].calibration_done
    got = drive([m], lambda: e.advance(SLOT_S), slots=N_SLOTS - CKPT_AT,
                final=e.flush_analysis)[0]
    want = classroom["jax_polls"][0][CKPT_AT:]
    # The tuner's last reading is not checkpointed: compare from the first
    # reading the port's engine posts.
    first = next(i for i, p in enumerate(got) if json.loads(p[0])["label"])
    assert first <= 3
    assert_polls_agree(got[first:], want[first:])
    assert [d for _, _, d in got] == [d for _, _, d in want]
    assert events(got) == events(want) and len(events(got)) > 0
    # Load, save: the same file; the JAX package loads the port's file.
    e2, _, _ = member(SEEDS[0])
    checkpoint.load_engine(classroom["jax_ckpt"], e2)
    again = str(tmp_path / "again.npz")
    checkpoint.save_engine(again, e2)
    ej, _, _ = member(SEEDS[0], "jax")
    jcheckpoint.load_engine(again, ej)
    back = str(tmp_path / "back.npz")
    jcheckpoint.save_engine(back, ej)
    want = np.load(classroom["jax_ckpt"])
    for path in (again, back):
        got_f = np.load(path)
        assert sorted(got_f.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got_f[key], want[key], err_msg=key)
    # The analyzer files: the port's, through the JAX package and back.
    pc, oc = consumers(e)
    for save, load, jsave, jload, an in (
            (checkpoint.save_pitch_analyzer, checkpoint.load_pitch_analyzer,
             jcheckpoint.save_pitch_analyzer, jcheckpoint.load_pitch_analyzer,
             pc.analyzer),
            (checkpoint.save_onset_analyzer, checkpoint.load_onset_analyzer,
             jcheckpoint.save_onset_analyzer, jcheckpoint.load_onset_analyzer,
             oc.analyzer)):
        mine, theirs = str(tmp_path / "an.npz"), str(tmp_path / "jan.npz")
        save(mine, an)
        jsave(theirs, jload(mine))
        back = load(theirs, "cpu")
        a, b = np.load(mine), np.load(theirs)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert back.frames_consumed == an.frames_consumed
        for x, y in zip(back.state if hasattr(an, "state") else
                        (*back.nf_state, *back.tr_state),
                        an.state if hasattr(an, "state") else
                        (*an.nf_state, *an.tr_state)):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def depth0(tmp_path_factory):
    """Each seed solo at depth 0 (the synchronous order), polled every slot;
    seed 11 also checkpointed before slots 90-93 and 100 ("ckpt")."""
    tmp = tmp_path_factory.mktemp("depth0")
    runs = {"ckpt": {}}
    for s in SEEDS:
        m = member(s)
        at = {}
        if s == SEEDS[0]:
            for i in (90, 91, 92, 93, CKPT_AT):
                runs["ckpt"][i] = str(tmp / f"sync{i}.npz")
                at[i] = (lambda path=runs["ckpt"][i]:
                         checkpoint.save_engine(path, m[0]))
        runs[s] = (m, drive([m], lambda m=m: m[0].advance(SLOT_S), at=at,
                            final=m[0].flush_analysis)[0])
    return runs


def test_depth_and_aggregation_match_depth0_bitwise(depth0, tmp_path):
    """pipeline_depth 2 with aggregate_slots 4 against depth 0: a
    checkpoint before one of slots 90-93, mid-aggregate (save_engine
    dispatches the partial aggregate per slot), bitwise equal to depth 0's
    at the same slot, every key; then the cumulative events, the last
    tuner reading and every carry bitwise."""
    m0, polls0 = depth0[SEEDS[0]]
    e, tuner, onset_det = m = member(SEEDS[0], depth=2, agg=4)
    saved = []

    def step():
        i = len(steps)
        if not saved and i in depth0["ckpt"] and e._resident.get("agg"):
            saved.append((i, len(e._resident["agg"]["entries"])))
            checkpoint.save_engine(str(tmp_path / "agg.npz"), e)
        steps.append(i)
        e.advance(SLOT_S)

    steps = []
    polls = drive([m], step, final=e.flush_analysis)[0]
    (at, partial), = saved
    assert 0 < partial < 4
    a = np.load(tmp_path / "agg.npz")
    b = np.load(depth0["ckpt"][at])
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert events(polls) == events(polls0) and len(events(polls0)) > 0
    assert polls[-1][0] == polls0[-1][0]
    assert_same_carries(e, m0[0])
    assert e._agg_dispatches > 0 and e._spec_rollbacks == 1
    assert e._fused_slots == N_SLOTS


@pytest.fixture(scope="module")
def timeouts():
    """No loopback, so calibration ends by the 2 s timeout (offset 0), with
    clicks at slots 93-96 around it and at 100 so that the rebuilt and
    the first steady slots fire: seed 5 solo at depth 1 and depth 0, seed
    6 solo at depth 0, and both pooled at depth 1 with aggregation 2;
    posts recorded (TransitionLog) and every slot program checked for
    writes into its inputs."""
    slots = 104
    clicks = (93, 94, 95, 96, 100)
    out, calls = {}, []
    log = TransitionLog()
    saved = (E.fused_slot_step, A.fused_slot_step, A.fused_slot_agg_step)
    E.fused_slot_step, A.fused_slot_step, A.fused_slot_agg_step = (
        unwritten(f, calls) for f in saved)
    try:
        with log:
            for name, seed, depth in (("d1", 5, 1), ("d0", 5, 0),
                                      ("d0_6", 6, 0)):
                m = member(seed, seconds=2.5, loopback=False, depth=depth,
                           clicks=clicks)
                out[name] = (m, drive([m], lambda m=m: m[0].advance(SLOT_S),
                                      slots=slots,
                                      final=m[0].flush_analysis)[0])
            pm = [member(s, seconds=2.5, loopback=False, clicks=clicks)
                  for s in (5, 6)]
            pool = EnginePool([m[0] for m in pm], pipeline_depth=1,
                              aggregate_slots=2)
            out["pool"] = (pool, pm, drive(pm, pool.step_wave, slots=slots,
                                           final=pool.flush))
    finally:
        E.fused_slot_step, A.fused_slot_step, A.fused_slot_agg_step = saved
    out["transitions"], out["calls"] = log.records, calls
    return out


def test_solo_timeout_transition_rolls_back_and_matches(timeouts):
    """A solo engine at depth 1 whose calibration ends by the timeout: the
    in-flight speculative slot is rolled back and rebuilt once, and the
    session equals depth 0's bit for bit (events, the last reading, every
    carry)."""
    (e1, _, _), p1 = timeouts["d1"]
    (e0, _, _), p0 = timeouts["d0"]
    assert e1._spec_rollbacks == 1 and e0._spec_rollbacks == 0
    assert consumers(e1)[1].calibration_done
    assert e1.transport.get_calibration_offset() == 0
    assert events(p1) == events(p0) and len(events(p0)) > 0
    assert p1[-1][0] == p0[-1][0]
    assert_same_carries(e0, e1)


def test_pool_timeout_transition_rolls_back_and_matches(timeouts):
    pool, pm, polls = timeouts["pool"]
    assert pool._rollbacks == 2
    for k, name in enumerate(("d0", "d0_6")):
        (es, _, _), ps = timeouts[name]
        assert events(polls[k]) == events(ps) and len(events(ps)) >= 3, \
            f"member {k}"
        assert polls[k][-1][0] == ps[-1][0]
        assert_same_carries(es, pm[k][0])


def test_calibration_transition_predicate_matches_post(classroom, timeouts):
    """`_calibration_transition` against `_post`'s effect on every post of
    the classroom (click acceptance: three pooled members) and of the
    timeout sessions (five engines)."""
    for name, records, want in (("acceptance", classroom["transitions"], 3),
                                ("timeout", timeouts["transitions"], 5)):
        assert len(records) > 300, name
        assert sum(actual for _, actual in records) == want, name
        for i, (predicted, actual) in enumerate(records):
            assert predicted == actual, f"{name} post {i}"


def test_slot_programs_write_no_input(timeouts):
    """Every `fused_slot_step` / `fused_slot_agg_step` call of the timeout
    sessions (speculative, rolled-back, aggregated and pooled ones) left
    its input carries' bits as they were."""
    calls = timeouts["calls"]
    assert calls.count("fused_slot_step") > 400
    assert calls.count("fused_slot_agg_step") > 100


def test_pool_mid_join_at_capacity(depth0):
    """A third engine joins two calibrated founders at slot 70 of a pool
    provisioned for 3 (depth 1, aggregation 2): the founders keep
    aggregating while the joiner calibrates in its own hold group (drained
    a wave later, one speculative rollback), waves keep their 3 lanes (a
    cached inert lane pads them), each wave's inputs are left unwritten,
    and every member equals its solo run."""
    import audio_analyzer_rs_tpu_torch.api.pool as P

    join_at = 70
    founders = [member(s) for s in SEEDS[:2]]
    pool = EnginePool([m[0] for m in founders], pipeline_depth=1,
                      aggregate_slots=2, capacity=3)
    lanes, calls = [], []
    saved = P.fused_slot_pool_step

    def wave(states, host_vecs, *args):
        lanes.append(len(states))
        return unwritten(saved, calls)(states, host_vecs, *args)

    members = list(founders)
    got = [[], [], []]
    agg_during_join = lag_waves = 0
    P.fused_slot_pool_step = wave
    try:
        for i in range(N_SLOTS):
            if i == join_at:
                members.append(member(SEEDS[2]))
                pool.add(members[2][0])
            before = pool._agg_dispatches
            pool.step_wave()
            if len(members) == 3 and not consumers(
                    members[2][0])[1].calibration_done:
                agg_during_join += pool._agg_dispatches - before
                lag_waves += bool(pool._hold_queue)
            for k, m in enumerate(members):
                got[k].extend(json.loads(m[2].poll_onsets()))
        pool.flush()
    finally:
        P.fused_slot_pool_step = saved
    for k, m in enumerate(members):
        got[k].extend(json.loads(m[2].poll_onsets()))
    assert set(lanes) == {3} and len(calls) == len(lanes)
    assert pool._rollbacks == 3   # the founders' and the joiner's
    assert agg_during_join > 0 and lag_waves > 0
    for k, seed in enumerate(SEEDS[:2]):
        (es, _, _), ps = depth0[seed]
        assert got[k] == events(ps) and got[k], f"founder {k}"
        assert_same_carries(es, members[k][0])
    joiner = member(SEEDS[2])
    polls = drive([joiner], lambda: joiner[0].advance(SLOT_S),
                  slots=N_SLOTS - join_at, final=joiner[0].flush_analysis)[0]
    assert got[2] == events(polls)
    assert_same_carries(joiner[0], members[2][0])
    for key, dummy in pool._dummies.items():
        fresh = EnginePool._dummy_state(
            consumers(members[0][0])[0].analyzer,
            consumers(members[0][0])[1].analyzer, key[2], key[3], "cpu")
        for a, b in zip(_leaves(tuple(dummy)), _leaves(tuple(fresh))):
            assert torch.equal(a, b)


def test_pool_scheduling_fuzz(depth0):
    """Scheduling churn at a small size: random pause windows of the two
    founders (after calibration, so they cut into steady aggregation), pool
    flushes at random waves and a mid-run join, with aggregation 3 and
    capacity 3; every member equals its solo run under the same script."""
    import random

    rng = random.Random(7)
    slots = 100
    join_at = rng.randrange(40, 70)
    pauses = {k: (s0, s0 + rng.randrange(5, 15)) for k, s0 in
              ((0, rng.randrange(60, 80)), (1, rng.randrange(60, 80)))}
    flushes = set(rng.sample(range(10, slots), 4))
    founders = [member(s) for s in SEEDS[:2]]
    pool = EnginePool([m[0] for m in founders], pipeline_depth=1,
                      aggregate_slots=3, capacity=3)
    members, got = list(founders), [[], [], []]
    for i in range(slots):
        if i == join_at:
            members.append(member(SEEDS[2]))
            pool.add(members[2][0])
        for k, (s0, s1) in pauses.items():
            if i == s0:
                members[k][2].pause()
            if i == s1:
                members[k][2].resume()
        pool.step_wave()
        if i in flushes:
            pool.flush()
        for k, m in enumerate(members):
            got[k].extend(json.loads(m[2].poll_onsets()))
    pool.flush()
    for k, m in enumerate(members):
        got[k].extend(json.loads(m[2].poll_onsets()))

    def solo(seed, n, pause=None):
        m = member(seed)
        at = {} if pause is None else {pause[0]: m[2].pause,
                                       pause[1]: m[2].resume}
        return m, events(drive([m], lambda: m[0].advance(SLOT_S), at=at,
                               slots=n, final=m[0].flush_analysis)[0])

    for k in range(2):
        m, ev = solo(SEEDS[k], slots, pauses[k])
        assert got[k] == ev, f"founder {k}"
        assert_same_carries(m[0], members[k][0])
    m, ev = solo(SEEDS[2], slots - join_at)
    assert got[2] == ev, "joiner"
    assert_same_carries(m[0], members[2][0])


def test_pool_membership_rules():
    """add() refuses a member of another pool, another sample rate or
    buffer size, and an engine on another torch device; remove() hands an
    engine back."""
    a, b = member(SEEDS[0])[0], member(SEEDS[1])[0]
    pool = EnginePool([a], pipeline_depth=1)
    with pytest.raises(ValueError, match="another pool"):
        EnginePool([a])
    with pytest.raises(ValueError, match="sample_rate"):
        pool.add(E.AudioEngine(sample_rate=44100.0, device="cpu"))
    with pytest.raises(ValueError, match="torch device"):
        pool.add(E.AudioEngine(sample_rate=SR, device="meta"))
    pool.add(b)
    assert pool.engines == (a, b)
    pool.remove(a)
    assert a._pool is None and pool.engines == (b,)


def test_step_wave_keeps_the_step_error():
    """A member's step raises: the wave collected so far is still
    dispatched (the stepped members keep their clocks), and the step's
    exception is what propagates; when the dispatch raises too, the step's
    exception propagates with the dispatch error as its cause."""
    ms = [member(s) for s in SEEDS[:2]]
    pool = EnginePool([m[0] for m in ms], pipeline_depth=1)
    pool.advance(0.1)

    def broken():
        raise RuntimeError("device step failed")

    ms[1][0].device.step = broken
    before = ms[0][0]._fused_slots
    with pytest.raises(RuntimeError, match="device step failed"):
        pool.step_wave()
    assert ms[0][0]._fused_slots == before + 1
    dispatched = []

    def failing_dispatch(collected):
        dispatched.append(len(collected))
        raise ValueError("dispatch failed")

    pool._wave_dispatch = failing_dispatch
    with pytest.raises(RuntimeError, match="device step failed") as info:
        pool.step_wave()
    assert dispatched == [1]
    assert isinstance(info.value.__cause__, ValueError)


def test_prepare_keys():
    """AudioEngine.prepare(include_sequential=True) with aggregation 4 and
    EnginePool.prepare at capacity 3: the JAX package's keys."""
    e = E.AudioEngine(sample_rate=SR, device="cpu")
    e.pipeline_depth, e.aggregate_slots = 1, 4
    info = e.prepare(include_sequential=True)
    assert info["variants"] == [(0, 0), (1024, 192), (1536, 192)]
    keys = sorted(info["seconds"])
    assert keys[:3] == ["agg4_1536_192", "fused_0_0", "fused_1024_192"]
    assert [k for k in keys if k.startswith("sequential_slot")] == [
        f"sequential_slot{i}" for i in range(4)]
    pool = EnginePool([E.AudioEngine(sample_rate=SR, device="cpu")
                       for _ in range(2)], pipeline_depth=1,
                      aggregate_slots=2, capacity=3)
    pinfo = pool.prepare()
    assert pinfo["variants"] == info["variants"]
    assert sorted(pinfo["seconds"]) == [
        "pool3_0_0", "pool3_1024_192", "pool3_1536_192",
        "pool3_agg2_1536_192"]
    assert pinfo["total_s"] >= sum(pinfo["seconds"].values())


def test_pool_continues_from_the_jax_pools_state(classroom):
    """After the classroom run, each port member's analyzer states and
    fused carries are replaced by its JAX twin's (`interop.pool_carries`;
    the host state is the same code on both sides), and both pools run the
    last 20 waves of the scenes: the polls agree within the stated
    tolerances."""
    jm, pm = classroom["jax"], classroom["port"]
    for (ej, _, _), (e, _, _) in zip(jm, pm):
        pj, oj = consumers(ej)
        p, o = consumers(e)
        r = ej._resident
        c = interop.pool_carries(pj.analyzer.nf_state, pj.analyzer.tr_state,
                                 oj.analyzer.state, np.asarray(r["pending"]),
                                 np.asarray(r["p_tail"]),
                                 np.asarray(r["o_tail"]), "cpu")
        assert c.nf_state.floor.shape == (1, 1025) and c.p_tail.ndim == 1
        p.analyzer.nf_state, p.analyzer.tr_state = c.nf_state, c.tr_state
        o.analyzer.state = c.onset_state
        if e._resident is None:
            e._enter_fused(p, o)
        e._resident.update(pending=c.pending, p_tail=c.p_tail,
                           o_tail=c.o_tail)
    got = drive(pm, classroom["pool"].step_wave, slots=20,
                final=classroom["pool"].flush)
    want = drive(jm, classroom["jax_pool"].step_wave, slots=20,
                 final=classroom["jax_pool"].flush)
    for k in range(len(SEEDS)):
        assert_polls_agree(got[k], want[k])
