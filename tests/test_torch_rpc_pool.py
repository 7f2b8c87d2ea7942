"""The port's multi-session RPC server (api/rpc.py) on the CPU: K sessions
pooled on one server (`pool.join`) against K solo servers of the port, and
against the JAX package's server driven the same way.

Parity bars: pooled against solo within the port, every session's onset
event stream and final tuner reading identical (deferred wave readback
changes when a result is visible, not what it is); the port's pooled
server against the JAX package's, after every `advance`, onset events
identical and tuner readings within tests/test_torch_engine.py's
tolerances (labels and notes identical, cents within 0.02).
"""

import base64

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.api.rpc import RpcServer as JaxServer
from audio_analyzer_rs_tpu_torch.api.rpc import RpcServer
from audio_analyzer_rs_tpu_torch.models import generators as gen

torch.set_num_threads(1)

SR = 48000.0
SEEDS = (11, 23, 42)
SCHEDULE = [0.25] * 8           # 2 s in lockstep steps
CENTS_TOL = 0.02
LOOPBACK = {"loopback_latency_samples": 2048, "loopback_gain": 1.0}


def call(server, method, *params, session=None):
    req = {"id": 1, "method": method, "params": list(params)}
    if session is not None:
        req["session"] = session
    resp = server.handle(req)
    assert "error" not in resp, resp
    return resp["result"]


def error(server, method, *params, session=None):
    req = {"id": 7, "method": method, "params": list(params)}
    if session is not None:
        req["session"] = session
    resp = server.handle(req)
    assert resp["id"] == 7 and "result" not in resp, resp
    return resp["error"]


def b64(x):
    return base64.b64encode(np.asarray(x, np.float32).astype("<f4")
                            .tobytes()).decode()


def port_server(**kw):
    return RpcServer(device="cpu", **kw)


def hub_run(server):
    """Three sessions with loopback calibration, pooled at depth 1 with
    aggregation 2; after every advance, each session's tuner reading and
    onsets; then a pool flush and the final polls."""
    scenes = [gen.mixed_scene(2.5, SR, seed=s) for s in SEEDS]
    sids = [0] + [call(server, "session.create", LOOPBACK) for _ in range(2)]
    assert call(server, "session.list") == sids
    for sid, x in zip(sids, scenes):
        call(server, "push_audio", b64(x), session=sid)
        call(server, "start_tuner", session=sid)
        call(server, "start_onset_detection", session=sid)
    assert call(server, "pool.join",
                {"pipeline_depth": 1, "aggregate_slots": 2}) == {"k": 3}
    polls = {sid: [] for sid in sids}
    for dt in SCHEDULE:
        call(server, "advance", dt)
        for sid in sids:
            polls[sid].append((call(server, "poll_output", session=sid),
                               call(server, "poll_onsets", session=sid)))
    call(server, "pool.flush")
    for sid in sids:
        polls[sid].append((call(server, "poll_output", session=sid),
                           call(server, "poll_onsets", session=sid)))
    return sids, polls, call(server, "pool.stats")


@pytest.fixture(scope="module")
def hubs():
    return {"port": hub_run(port_server(**LOOPBACK)),
            "jax": hub_run(JaxServer(**LOOPBACK))}


def solo_run(seed):
    """One dedicated port server (depth 0, per-slot results)."""
    s = port_server(**LOOPBACK)
    call(s, "push_audio", b64(gen.mixed_scene(2.5, SR, seed=seed)))
    call(s, "start_tuner")
    call(s, "start_onset_detection")
    onsets = []
    for dt in SCHEDULE:
        call(s, "advance", dt)
        onsets.extend(call(s, "poll_onsets"))
    call(s, "flush_analysis")
    onsets.extend(call(s, "poll_onsets"))
    return call(s, "poll_output"), onsets


def test_pooled_sessions_match_solo_servers(hubs):
    sids, polls, stats = hubs["port"]
    assert stats == {"k": 3, "waves": 88, "pipeline_depth": 1,
                     "aggregate_slots": 2}
    any_events = False
    for sid, seed in zip(sids, SEEDS):
        solo_out, solo_onsets = solo_run(seed)
        assert [ev for _, o in polls[sid] for ev in o] == solo_onsets, sid
        assert polls[sid][-1][0] == solo_out, sid
        any_events = any_events or bool(solo_onsets)
    assert any_events


def test_pooled_sessions_match_the_jax_server(hubs):
    (sids, polls, stats), (jsids, jpolls, jstats) = hubs["port"], hubs["jax"]
    assert sids == jsids and stats == jstats
    for sid in sids:
        assert len(polls[sid]) == len(jpolls[sid])
        for k, ((t, o), (jt, jo)) in enumerate(zip(polls[sid], jpolls[sid])):
            assert len(o) == len(jo), (sid, k)
            for a, b in zip(o, jo):
                assert a["raw_sample_offset"] == b["raw_sample_offset"]
                assert a["beat_position"] == b["beat_position"]
                assert abs(a["velocity"] - b["velocity"]) <= 1e-4
            for key in ("label", "notes", "mode", "system", "key",
                        "beat_position"):
                assert t[key] == jt[key], (sid, k, key)
            assert abs(t["cents"] - jt["cents"]) <= CENTS_TOL, (sid, k)
        assert any(o for _, o in polls[sid]) or sid != 0


def test_session_close_and_errors():
    hub = port_server()
    sid = call(hub, "session.create")
    call(hub, "push_audio",
         b64(gen.tone_with_harmonics(220.0, 1.2, SR, harmonics=6,
                                     amplitude=0.3)), session=sid)
    call(hub, "start_tuner", session=sid)
    call(hub, "advance", 1.0, session=sid)   # no pool: per-session time
    assert "A3" in call(hub, "poll_output", session=sid)["notes"]
    assert "unknown session" in error(hub, "poll_transport", session=99)
    assert "cannot be closed" in error(hub, "session.close")
    call(hub, "session.close", session=sid)
    assert call(hub, "session.list") == [0]
    call(hub, "session.create")
    assert "session.create" in error(hub, "configure", {})
    # Pool errors: no pool to leave or describe; one pool at a time; a
    # session of another buffer size is refused and not registered.
    assert call(hub, "pool.leave") is False
    assert call(hub, "pool.stats") is None
    assert call(hub, "pool.join", {})["k"] == 2
    assert "pool already active" in error(hub, "pool.join", {})
    assert "buffer_size" in error(hub, "session.create",
                                  {"buffer_size": 512})
    assert call(hub, "session.list") == [0, 2]
    assert "unknown method" in error(hub, "no.such.method")
    assert "ValueError" in error(hub, "push_audio", b64([0.0]), "f64")


def test_pool_join_leave_midstream():
    """Sessions pool and unpool mid-stream; results keep flowing."""
    hub = port_server()
    sid = call(hub, "session.create")
    tone = gen.tone_with_harmonics(330.0, 2.5, SR, harmonics=6,
                                   amplitude=0.3)
    for s in (0, sid):
        call(hub, "push_audio", b64(tone), session=s)
        call(hub, "start_tuner", session=s)
        call(hub, "start_onset_detection", session=s)
    call(hub, "advance", 0.5)            # un-pooled: session 0 alone
    call(hub, "advance", 0.5, session=sid)
    call(hub, "pool.join", {"aggregate_slots": 2})
    call(hub, "advance", 0.75)           # pooled: lockstep
    assert call(hub, "pool.stats")["waves"] > 0
    assert call(hub, "pool.leave") is True
    call(hub, "advance", 0.5)            # back to per-session time
    call(hub, "advance", 0.5, session=sid)
    for s in (0, sid):
        assert "E4" in call(hub, "poll_output", session=s)["notes"]
