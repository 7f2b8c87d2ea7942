"""The port's live engine, `AudioEngine(device="cpu")`, against the JAX
package's `AudioEngine` on the CPU.

The session is the practice configuration of tests/test_fused_streaming.py
`_run_session`: tuner and onset detection over a 48 kHz mixed scene, 1,024
sample slots, loopback calibration (2,048 samples, gain 1), 3 s, polled
every slot.  On the CPU the port's kernels run their plain versions.

Per slot, the port against JAX (the JSON the app reads):
- `poll_dynamics` identical (the host reducer and AGC are the same code);
- onset events identical in count, raw sample offset and beat position,
  velocity within 1e-4 (printed with 4 decimals; the value itself is held
  to rtol 1e-5 by tests/test_torch_fused_slot.py);
- tuner outputs: label, notes, mode, system, key and beat position
  identical; cents and accuracies within 0.02 cents (frequencies within
  rtol ~1e-5: the STFT's summation order, as tests/test_torch_segmented.py
  states it).
Within the port, the fused per-slot program and the sequential consumers
give the same polled JSON slot for slot and the same final states, bit for
bit.  Deferred readback and slot aggregation are held to depth 0 by
tests/test_torch_pool.py.  No decision flipped on these sessions, so no straddle is pinned.
"""

import json

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.api.device import ArraySource as JaxSource
from audio_analyzer_rs_tpu.api.engine import AudioEngine as JaxEngine
from audio_analyzer_rs_tpu_torch import interop
from audio_analyzer_rs_tpu_torch.api import engine as E
from audio_analyzer_rs_tpu_torch.api.device import ArraySource
from audio_analyzer_rs_tpu_torch.devtools import DebugRecorder
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops.onset import HOP, TICK_GUARD_S, WINDOW
from audio_analyzer_rs_tpu_torch.utils.midi import write_midi_file

torch.set_num_threads(1)

SR = 48000.0
SECONDS = 3.0
NAN_AT = 1.5                 # seconds: the NaN sample of the NaN session
CENTS_TOL = 0.02
VELOCITY_TOL = 1e-4
TUNER_EXACT = ("label", "notes", "mode", "system", "base_freq", "key",
               "beat_position")


def _scene(nan: bool = False):
    x = gen.mixed_scene(SECONDS + 0.5, SR, seed=11)
    if nan:
        x[int(NAN_AT * SR)] = np.nan
    return x


def _engine(kind: str, scene):
    kw = dict(sample_rate=SR, loopback_latency_samples=2048,
              loopback_gain=1.0)
    if kind == "jax":
        return JaxEngine(input_source=JaxSource(scene), **kw)
    return E.AudioEngine(input_source=ArraySource(scene), device="cpu",
                         **kw)


def _run(e, slots: int):
    tuner, onset = e.start_tuner(), e.start_onset_detection()
    slot_s = e.buffer_size / SR
    outs = []
    for _ in range(slots):
        e.advance(slot_s)
        outs.append((tuner.poll_output(), onset.poll_onsets(),
                     e.poll_dynamics()))
    return outs


def _session(kind: str, fused: bool = True, nan: bool = False):
    e = _engine(kind, _scene(nan))
    e.fused_streaming = fused
    return e, _run(e, int(SECONDS * SR / e.buffer_size))


@pytest.fixture(scope="module")
def sessions():
    return {"jax": _session("jax"), "fused": _session("port"),
            "sequential": _session("port", fused=False)}


def _consumers(e):
    pc = next(c for c in e._consumers.values()
              if type(c).__name__ == "_PitchConsumer")
    oc = next(c for c in e._consumers.values()
              if type(c).__name__ == "_OnsetConsumer")
    return pc, oc


def assert_polls_agree(got, want):
    """Per slot, the port's polled JSON against JAX's within the stated
    tolerances."""
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


def test_polls_match_jax_slot_for_slot(sessions):
    (e, outs), (ej, outs_j) = sessions["fused"], sessions["jax"]
    assert_polls_agree(outs, outs_j)
    assert e._fused_slots == len(outs) == ej._fused_slots
    assert sum(len(json.loads(o)) for _, o, _ in outs) >= 3
    assert sum(bool(json.loads(t)["notes"]) for t, _, _ in outs) > 50
    _, oc = _consumers(e)
    _, oc_j = _consumers(ej)
    assert oc.calibration_done and oc_j.calibration_done
    assert (e.transport.get_calibration_offset()
            == ej.transport.get_calibration_offset())


def test_fused_matches_sequential_bitwise(sessions):
    (ef, outs_f), (es, outs_s) = sessions["fused"], sessions["sequential"]
    assert ef._fused_slots > 0 and es._fused_slots == 0
    for k, (a, b) in enumerate(zip(outs_f, outs_s)):
        assert a == b, f"slot {k}"
    (pf, of), (ps, os_) = _consumers(ef), _consumers(es)
    assert pf.analyzer.frames_consumed == ps.analyzer.frames_consumed
    assert of.analyzer.frames_consumed == os_.analyzer.frames_consumed
    np.testing.assert_array_equal(pf.analyzer._tail, ps.analyzer._tail)
    np.testing.assert_array_equal(of.analyzer._tail, os_.analyzer._tail)
    for a, b in zip((*pf.analyzer.nf_state, *pf.analyzer.tr_state,
                     *of.analyzer.state),
                    (*ps.analyzer.nf_state, *ps.analyzer.tr_state,
                     *os_.analyzer.state)):
        assert torch.equal(a, b)


def test_nan_sample_matches_jax():
    """One NaN sample in the input: it runs through the host reducer into
    every later slot; the port's polled outputs still equal JAX's."""
    e, outs = _session("port", nan=True)
    _, outs_j = _session("jax", nan=True)
    assert_polls_agree(outs, outs_j)
    assert any("nan" in d for _, _, d in outs)
    nan_slot = int(NAN_AT * SR) // 1024
    assert not any("nan" in d for _, _, d in outs[:nan_slot])


def test_continues_from_the_jax_engines_mid_session_state():
    """Both engines run the first 60 slots; then the port's analyzer states
    and fused carries are replaced by the JAX engine's (interop) and both
    run 30 more: the polls agree within the stated tolerances."""
    ej, e = _engine("jax", _scene()), _engine("port", _scene())
    _run(ej, 60)
    _run(e, 60)
    (pj, oj), (pt, ot) = _consumers(ej), _consumers(e)

    def batched(state):
        return type(state)(*(np.asarray(leaf)[None] for leaf in state))

    pt.analyzer.nf_state = interop.noise_floor_state(
        batched(pj.analyzer.nf_state), "cpu")
    pt.analyzer.tr_state = interop.tracker_state(
        batched(pj.analyzer.tr_state), "cpu")
    ot.analyzer.state = interop.onset_state(batched(oj.analyzer.state),
                                            "cpu")
    r = ej._resident
    e._resident.update(interop.fused_carries(
        np.asarray(r["pending"]), np.asarray(r["p_tail"]),
        np.asarray(r["o_tail"]), "cpu")._asdict())
    slot_s = 1024 / SR
    got, want = [], []
    for eng, out in ((e, got), (ej, want)):
        tuner, onset = eng.active_tuner, eng.active_onset
        for _ in range(30):
            eng.advance(slot_s)
            out.append((tuner.poll_output(), onset.poll_onsets(),
                        eng.poll_dynamics()))
    assert_polls_agree(got, want)


def test_uniffi_api_surface_complete():
    surface = {
        "AudioEngine": [
            "start_input", "start_output", "create_metronome",
            "create_synth", "create_player", "start_recording",
            "start_onset_detection", "start_tuner", "stop_metronome",
            "stop_synth", "stop_player", "stop_recording",
            "stop_onset_detection", "create_practice_session",
            "stop_practice_session", "stop_tuner", "poll_dynamics",
            "poll_transport", "clean_input", "clean_output"],
        "Tuner": ["poll_output", "set_base_freq", "set_key", "set_mode",
                  "set_system"],
        "Metronome": ["set_bpm", "set_volume", "set_pattern", "set_muted",
                      "set_polyrhythm"],
        "Synth": ["load_file", "play", "play_note", "pause", "resume",
                  "clear", "set_volume", "set_muted"],
        "Player": ["load_track", "play", "pause", "seek"],
        "Recording": ["pause", "resume"],
        "OnsetDetection": ["poll_onsets", "pause", "resume"],
        "PracticeSession": ["start", "stop", "poll_transport", "poll_errors",
                            "get_metrics", "is_running", "set_tuner_mode",
                            "set_bpm"],
    }
    missing = [f"{c}.{m}" for c, ms in surface.items()
               for m in ms if not hasattr(getattr(E, c, None), m)]
    assert not missing, missing


@pytest.mark.parametrize("what", ["tuner", "onset", "metronome", "synth",
                                  "player", "recording"])
def test_double_create_errors(what, tmp_path):
    e = E.AudioEngine(device="cpu")
    create = {
        "tuner": e.start_tuner, "onset": e.start_onset_detection,
        "metronome": lambda: e.create_metronome(120.0, [3, 1, 1, 1], [],
                                                1.0, False),
        "synth": e.create_synth, "player": e.create_player,
        "recording": lambda: e.start_recording(str(tmp_path / "r.wav")),
    }[what]
    create()
    with pytest.raises(E.SpawnFailed, match="Already active"):
        create()
    if what == "recording":
        e.stop_recording()


def test_poll_schemas():
    e = E.AudioEngine(device="cpu")
    tuner, onset = e.start_tuner(), e.start_onset_detection()
    e.advance(0.1)
    snap = json.loads(e.poll_transport())
    for field in ("beat_position", "bpm", "is_playing", "output_frames",
                  "input_frames", "drift_samples", "display_beat_position",
                  "ui_latency_compensation_s", "current_beat", "beat_phase",
                  "input_latency_samples", "capture_time_s"):
        assert field in snap, field
    d = json.loads(e.poll_dynamics())
    assert set(d) == {"level", "rms_db", "gain_db", "session_median_db",
                      "noise_floor_db"}
    assert list(json.loads(tuner.poll_output())) == [
        "label", "cents", "notes", "accuracies", "mode", "system",
        "base_freq", "key", "beat_position"]
    assert onset.poll_onsets() == "[]"


def test_practice_session_end_to_end(tmp_path):
    """A MIDI reference written by the port's `write_midi_file`, its notes
    played into the virtual microphone, scored by a practice session (the
    JAX package's test, on the port's engine)."""
    midi_path = str(tmp_path / "ref.mid")
    notes = [(60, 0.0, 0.9, 90), (64, 1.0, 0.9, 90), (67, 2.0, 0.9, 90),
             (72, 3.0, 0.9, 90),
             (72, 4.0, 0.9, 90), (67, 5.0, 0.9, 90), (64, 6.0, 0.9, 90),
             (60, 7.0, 0.9, 90)]
    write_midi_file(midi_path, notes, bpm=120.0)
    perf = np.zeros(int(SR * 4.5), dtype=np.float32)
    for midi, start, dur, _vel in notes:
        freq = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        tone = gen.tone_with_harmonics(freq, dur * 0.5 * 0.9, SR,
                                       harmonics=6, amplitude=0.35)
        s = int(start * 0.5 * SR)
        perf[s:s + len(tone)] += tone
    e = E.AudioEngine(input_source=ArraySource(perf), device="cpu")
    e.transport.set_calibration_offset(1)   # offline: no residual latency
    e.transport.set_input_latency(0)
    e.transport.set_output_latency(0)
    session = e.create_practice_session(midi_path, "Piano", 0,
                                        "Performance", "Beginner", 120.0)
    session.start(0, 1)
    e.advance(4.4)
    assert e._fused_slots > 0
    assert not session.is_running()
    metrics = json.loads(session.get_metrics())
    assert metrics["num_measures"] >= 1
    assert metrics["accuracy_percent"] >= 75.0, metrics
    assert json.loads(session.poll_transport())["practice_end"] == 1
    assert isinstance(json.loads(session.poll_errors()), list)


def test_tick_suppression_matches_per_frame_stamping():
    """The vectorized `_tick_suppression` against the per-frame path it
    replaces (`stamp_onset`, then `nearest_tick_distance_beats` against the
    guard), over random transports, tick histories and consumer offsets."""
    rng = np.random.default_rng(7)
    e = E.AudioEngine(device="cpu")
    e.start_tuner()
    e.start_onset_detection()
    _, oc = _consumers(e)
    t = e.transport
    suppressed = kept = 0
    for trial in range(60):
        t.reset()
        t.set_bpm(float(rng.uniform(40.0, 240.0)))
        t.set_input_latency(int(rng.integers(0, 4096)))
        t.set_output_latency(int(rng.integers(0, 4096)))
        t.set_calibration_offset(int(rng.integers(0, 3000)))
        t.play()
        for _ in range(int(rng.integers(1, 40))):
            t.tick_output(1024, 0.0)
            t.tick_input(1024)
        if trial % 7:
            for _ in range(int(rng.integers(1, 12))):
                t.notify_tick_at_frame(int(rng.integers(
                    0, t.get_output_frames() + 4096)))
        oc.analyzer.frames_consumed = int(rng.integers(0, 5000))
        oc.base_input_frame = int(rng.integers(0, 20000))
        oc.dropped_samples = int(rng.integers(0, 3000))
        n = int(rng.integers(0, 20))
        got = oc._tick_suppression(n)
        guard = TICK_GUARD_S * t.get_bpm() / 60.0
        want = np.zeros(n, bool)
        for i in range(n):
            center = (oc.base_input_frame
                      + (oc.analyzer.frames_consumed + i) * HOP
                      + WINDOW // 2 + oc.dropped_samples)
            event = t.stamp_onset(center - t.get_input_frames(), 0.0)
            want[i] = t.nearest_tick_distance_beats(
                event.beat_position) < guard
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        suppressed += int(want.sum())
        kept += int((~want).sum())
    assert suppressed > 20 and kept > 20


@pytest.mark.parametrize("knob,value", [("pipeline_depth", 1),
                                        ("aggregate_slots", 4)])
def test_unported_knobs_raise_at_the_next_slot(knob, value):
    """The deferral knobs, once unported, now run: set mid-session, the
    engine goes on and after a flush has consumed the same slots with the
    same states as a depth-0 engine.  The debug recorder, once unported
    too, now attaches to that engine: the next slots run the sequential
    consumers and log a record a frame (tests/test_torch_devtools.py holds
    the records to JAX's)."""
    engines = []
    for turn_knob in (False, True):
        e = E.AudioEngine(input_source=ArraySource(_scene()), device="cpu")
        e.start_tuner()
        e.start_onset_detection()
        e.advance(0.1)
        if turn_knob:
            setattr(e, knob, value)
        e.advance(0.3)
        e.flush_analysis()
        engines.append(e)
    (p0, o0), (p1, o1) = (_consumers(x) for x in engines)
    assert p0.analyzer.frames_consumed == p1.analyzer.frames_consumed
    assert o0.analyzer.frames_consumed == o1.analyzer.frames_consumed
    for x, y in zip((*p0.analyzer.nf_state, *p0.analyzer.tr_state,
                     *o0.analyzer.state),
                    (*p1.analyzer.nf_state, *p1.analyzer.tr_state,
                     *o1.analyzer.state)):
        assert torch.equal(x, y)
    e = engines[1]
    rec = DebugRecorder()
    e.attach_debug_recorder(rec)
    pc, oc = _consumers(e)
    assert pc.analyzer.debug_recorder is rec and e._resident is None
    fused, frames = e._fused_slots, pc.analyzer.frames_consumed
    e.advance(0.1)
    e.flush_analysis()
    assert e._fused_slots == fused
    assert [r.frame for r in rec.pitch_frames] == list(
        range(frames, pc.analyzer.frames_consumed))
    assert rec.pitch_frames[-1].noise_floor.shape == (1025,)
    assert len(rec.onset_frames) > 0


def test_prepare_walks_the_ramp():
    e = E.AudioEngine(device="cpu")
    info = e.prepare()
    assert info["variants"] == [(0, 0), (1024, 192), (1536, 192)]
    assert sorted(info["seconds"]) == ["fused_0_0", "fused_1024_192",
                                       "fused_1536_192"]
    assert info["total_s"] >= sum(info["seconds"].values())


def test_engine_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    e = E.AudioEngine()
    assert e.torch_device.type == "cuda"
    with pytest.raises((AssertionError, RuntimeError)):
        e.start_tuner()
