"""The port's debug surface against the JAX package's, on the CPU.

`devtools.py` is a copy held line for line (tests/test_torch_host_copies.py);
this file holds what the port computes for it:
- the full-width pitch front, `pitch_extract_frames(..., return_floor=True)`
  (K1 and K5 over all 1,025 bins; their plain versions here): magnitudes
  within 1e-5 of the max (the GEMM's summation order, as
  tests/test_torch_stft.py states it); on JAX's magnitudes the full-width
  floor scan is bitwise to the float32 FMA oracle `noise_floor_np(fma=True)`
  and within rtol 1e-6 of JAX's scan (XLA:CPU's volatility EMA is 1 ulp
  off both the plain and the fused form on some bins of this scene: frame
  15, 11 bins from 200 to 970; the floors drift by <= 4 ulp from there);
  from the port's own magnitudes, effective floors and the final floor
  state within rtol 1e-6 plus the magnitudes' tolerance (the floor follows
  the magnitudes: near silence a floor of ~1e-9 moves by what the
  magnitudes do, ~1e-7 of the max); valid flags bitwise, frequencies and
  scores within rtol 1e-5;
- `PitchAnalyzer` with a `DebugRecorder`, from the start and attached
  mid-stream after a banded second: one record a frame, the floors and the
  stable pitches at the tolerances above;
- the live engine with `attach_debug_recorder` at 0 s and at 1 s: no fused
  slot while attached, the polled outputs slot for slot as
  tests/test_torch_engine.py holds them, the onset records' status strings
  equal;
- `JsonlStreamRecorder` streaming while the engine runs, and
  `DebugStreamView` rendering the stream.
No decision flipped on these scenes, so no straddle is pinned.
"""

import json

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu import devtools as jdev
from audio_analyzer_rs_tpu.api.device import ArraySource as JaxSource
from audio_analyzer_rs_tpu.api.engine import AudioEngine as JaxEngine
from audio_analyzer_rs_tpu.models import analyzer as jan
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu.utils import framing as jframing
from audio_analyzer_rs_tpu_torch import cli, devtools, interop
from audio_analyzer_rs_tpu_torch.api.device import ArraySource
from audio_analyzer_rs_tpu_torch.api.engine import AudioEngine
from audio_analyzer_rs_tpu_torch.models import analyzer as tan
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import noisefloor as tnf
from audio_analyzer_rs_tpu_torch.ops import tracker as ttr

torch.set_num_threads(1)

SR = 44100.0
W, HOP, HALF = 2048, 512, 1025
BAND = 464                   # the floor's candidate band kc at 44.1 kHz
MAG_TOL = 1e-5               # of the max, as tests/test_torch_stft.py
FLOOR_RTOL = 1e-6
RTOL = 1e-5
LIVE_SR = 48000.0
LIVE_SECONDS = 2.0
CENTS_TOL = 0.02             # tests/test_torch_engine.py's tolerances
VELOCITY_TOL = 1e-4
TUNER_EXACT = ("label", "notes", "mode", "system", "base_freq", "key",
               "beat_position")


def _assert_pitches(got, want):
    """got/want: (freqs, scores, valid) [N, 8]: valid bitwise, the rest at
    rtol 1e-5."""
    (gf, gs, gv), (wf, ws, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gf[wv], wf[wv], rtol=RTOL)
    np.testing.assert_allclose(gs[wv], ws[wv], rtol=RTOL)


def _assert_mags(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MAG_TOL * np.abs(want).max()


def _assert_floors(got, want, scale, name=""):
    """Floors (or floor-state leaves) from the two packages' own
    magnitudes, whose largest is `scale`."""
    np.testing.assert_allclose(got, want, rtol=FLOOR_RTOL,
                               atol=MAG_TOL * scale, err_msg=name)


SCENE_S = 1.5                # 126 frames: one JAX compile serves the file


@pytest.fixture(scope="module")
def extract():
    """One 1.5 s melody through the JAX `PitchAnalyzer` with a recorder
    (its chunk is `pitch_extract_frames(return_floor=True)` and the
    tracker), and through the port's full-width front and its analyzer
    with a recorder."""
    x = gen.mixed_scene(SCENE_S, SR, seed=11)
    frames = jframing.frame_signal_np(x, W, HOP)
    gf = float(jnf.global_floor_linear(-96.0, HALF))
    n = len(frames)
    jrec, trec = jdev.DebugRecorder(), devtools.DebugRecorder()
    ja = jan.PitchAnalyzer(SR, debug_recorder=jrec)
    jout = ja.process(x)
    ts, tpf, tm, te = tan.pitch_extract_frames(
        tnf.init_state(HALF, "cpu", (1,)), torch.from_numpy(frames)[None],
        torch.full((1, n), gf), SR, return_floor=True)
    tout = tan.PitchAnalyzer(SR, device="cpu",
                             debug_recorder=trec).process(x)
    return dict(
        jax=dict(state=[np.asarray(a) for a in ja.nf_state],
                 pf=[jout.raw_freqs, jout.raw_scores, jout.raw_valid],
                 mags=jout.mags, eff=jout.eff_floor, out=jout, rec=jrec),
        port=dict(state=[a[0].numpy() for a in ts],
                  pf=[a[0].numpy() for a in tpf], mags=tm[0].numpy(),
                  eff=te[0].numpy(), out=tout, rec=trec),
        frames=frames, gf=gf, scale=float(np.abs(jout.mags).max()))


def test_full_width_floor_on_jax_magnitudes(extract):
    """The full-width floor scan (K5's plain version over 1,025 bins) fed
    JAX's magnitudes: bit for bit the FMA oracle, within rtol 1e-6 of
    JAX's scan."""
    mags, n = extract["jax"]["mags"], len(extract["frames"])
    _, eff = tnf.noise_floor_scan(
        tnf.init_state(HALF, "cpu", (1,)), torch.from_numpy(mags.copy())[None],
        torch.full((1, n), extract["gf"]), None)
    oracle = jnf.noise_floor_np(mags, np.full(n, extract["gf"], np.float32),
                                fma=True)
    np.testing.assert_array_equal(eff[0].numpy().view(np.uint32),
                                  oracle.view(np.uint32))
    np.testing.assert_allclose(eff[0].numpy(), extract["jax"]["eff"],
                               rtol=FLOOR_RTOL, atol=0)


@pytest.mark.parametrize("part", ["mags", "eff_floor", "state", "pitches"])
def test_full_width_extract_matches_jax(extract, part):
    j, t = extract["jax"], extract["port"]
    if part == "mags":
        assert t["mags"].shape == (len(extract["frames"]), HALF)
        _assert_mags(t["mags"], j["mags"])
    elif part == "eff_floor":
        assert t["eff"].shape == j["eff"].shape == t["mags"].shape
        _assert_floors(t["eff"], j["eff"], extract["scale"])
    elif part == "state":
        for name, a, b in zip(tnf.NoiseFloorState._fields, t["state"],
                              j["state"]):
            _assert_floors(a, b, extract["scale"], name)
    else:
        _assert_pitches(t["pf"][:3], j["pf"][:3])
        assert j["pf"][2].any()


def test_banded_front_agrees_with_full_width(extract):
    """Without return_floor the front is banded: magnitudes [N, 465], the
    floor over 464 bins, an empty eff_floor leaf in PitchChunkOut, and
    the same bins and pitches as the full-width front."""
    frames = torch.from_numpy(extract["frames"])[None]
    n = frames.shape[1]
    gf = torch.full((1, n), extract["gf"])
    onsets = torch.zeros((1, n), dtype=torch.bool)
    outs = {}
    for full in (False, True):
        outs[full] = tan.pitch_analyze_frames(
            tnf.init_state(HALF, "cpu", (1,)), ttr.init_state("cpu", (1,)),
            frames, gf, onsets, SR, return_floor=full)
    (nb, _, ob), (nf, _, of) = outs[False], outs[True]
    assert ob.mags.shape == (1, n, BAND + 1) and ob.eff_floor.shape == (
        1, 0, 0)
    assert of.mags.shape == of.eff_floor.shape == (1, n, HALF)
    _assert_mags(ob.mags.numpy(), of.mags[..., :BAND + 1].numpy())
    _assert_floors(nb.floor[..., :BAND].numpy(),
                   nf.floor[..., :BAND].numpy(), extract["scale"])
    for a, b in ((ob.stable_freqs, of.stable_freqs),
                 (ob.raw_freqs, of.raw_freqs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL)
    assert torch.equal(ob.stable_valid, of.stable_valid)


def _assert_records(got_rec, want_rec):
    """Two recorders' pitch records: frames, spectra, floors, pitches."""
    got, want = list(got_rec.pitch_frames), list(want_rec.pitch_frames)
    assert len(got) == len(want) > 0
    scale = max(float(np.abs(w.magnitudes).max()) for w in want)
    for g, w in zip(got, want):
        assert g.frame == w.frame and g.bin_width == w.bin_width
        assert g.magnitudes.shape == g.noise_floor.shape == (HALF,)
        np.testing.assert_allclose(g.magnitudes, np.asarray(w.magnitudes),
                                   rtol=0, atol=MAG_TOL * scale)
        _assert_floors(g.noise_floor, np.asarray(w.noise_floor), scale)
        assert len(g.stable_pitches) == len(w.stable_pitches), g.frame
        for (gf, gs), (wf, ws) in zip(g.stable_pitches, w.stable_pitches):
            assert gf == pytest.approx(wf, rel=RTOL)
            assert gs == pytest.approx(ws, rel=RTOL)


def test_pitch_analyzer_records_like_jax(extract):
    """JAX tests/test_devtools.py's flow on the 1.5 s scene: one record a
    frame, full-width spectra and floors, the same stable pitches and the
    same JSONL keys."""
    jout, jrec = extract["jax"]["out"], extract["jax"]["rec"]
    tout, trec = extract["port"]["out"], extract["port"]["rec"]
    assert len(trec.pitch_frames) == len(tout.stable_freqs)
    assert tout.eff_floor.shape == tout.mags.shape == (len(tout.mags), HALF)
    _assert_records(trec, jrec)
    _assert_pitches((tout.stable_freqs, tout.stable_scores,
                     tout.stable_valid),
                    (jout.stable_freqs, jout.stable_scores,
                     jout.stable_valid))
    assert any(r.stable_pitches for r in trec.pitch_frames)
    tl = [json.loads(line) for line in trec.drain_jsonl().splitlines()]
    jl = [json.loads(line) for line in jrec.drain_jsonl().splitlines()]
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl]
    assert [[p["label"] for p in r["stable_pitches"]] for r in tl] == \
        [[p["label"] for p in r["stable_pitches"]] for r in jl]
    assert not trec.pitch_frames


def test_recorder_attached_mid_stream_continues_like_jax():
    """1 s banded, then a recorder attached and 1.5 s at full width.  The
    floor's tail above the band was frozen (never seeded from banded
    magnitudes) and continues at full width exactly as JAX continues it:
    the port runs the second part from the JAX analyzer's carried state
    (interop), and from its own."""
    x = gen.mixed_scene(2.6, SR, seed=14)
    cut = int(1.0 * SR)
    ja = jan.PitchAnalyzer(SR)
    ja.process(x[:cut])
    # The second part ends where its 126th frame does (the extract
    # fixture's frame count: the JAX program compiled there is reused).
    tail = len(ja._tail)
    x = x[:cut + (125 * HOP + W) - tail]
    carried = dict(
        nf=type(ja.nf_state)(*(np.asarray(a)[None] for a in ja.nf_state)),
        tr=type(ja.tr_state)(*(np.asarray(a)[None] for a in ja.tr_state)),
        tail=ja._tail.copy(), frames=ja.frames_consumed)
    assert not carried["nf"].floor[0, BAND:].any()      # the frozen tail
    ja.debug_recorder = jrec = jdev.DebugRecorder()
    jout = ja.process(x[cut:])

    own = tan.PitchAnalyzer(SR, device="cpu")
    own.process(x[:cut])
    assert not own.nf_state.floor[0, BAND:].any()
    moved = tan.PitchAnalyzer(SR, device="cpu")
    moved.nf_state = interop.noise_floor_state(carried["nf"], "cpu")
    moved.tr_state = interop.tracker_state(carried["tr"], "cpu")
    moved._tail, moved.frames_consumed = carried["tail"], carried["frames"]
    for an in (own, moved):
        an.debug_recorder = rec = devtools.DebugRecorder()
        out = an.process(x[cut:])
        _assert_records(rec, jrec)
        _assert_pitches((out.stable_freqs, out.stable_scores,
                         out.stable_valid),
                        (jout.stable_freqs, jout.stable_scores,
                         jout.stable_valid))
        scale = max(float(np.abs(r.magnitudes).max())
                    for r in jrec.pitch_frames)
        for name, a, b in zip(tnf.NoiseFloorState._fields, an.nf_state,
                              ja.nf_state):
            _assert_floors(a[0].numpy(), np.asarray(b), scale, name)
        assert an.nf_state.floor[0, BAND:].all()


def _live_scene():
    return gen.mixed_scene(LIVE_SECONDS + 0.5, LIVE_SR, seed=11)


def _live_engine(kind: str):
    kw = dict(sample_rate=LIVE_SR, loopback_latency_samples=2048,
              loopback_gain=1.0)
    if kind == "jax":
        return JaxEngine(input_source=JaxSource(_live_scene()), **kw)
    return AudioEngine(input_source=ArraySource(_live_scene()),
                       device="cpu", **kw)


def _live_session(kind: str, attach_slot: int):
    """Tuner and onset detection, polled every slot; a DebugRecorder
    attached before slot `attach_slot` (0: before the consumers start)."""
    e = _live_engine(kind)
    rec = (jdev if kind == "jax" else devtools).DebugRecorder(1 << 20)
    if attach_slot == 0:
        e.attach_debug_recorder(rec)
    tuner, onset = e.start_tuner(), e.start_onset_detection()
    polls, fused_at_attach = [], 0
    for k in range(int(LIVE_SECONDS * LIVE_SR / e.buffer_size)):
        if k == attach_slot and k:
            fused_at_attach = e._fused_slots
            e.attach_debug_recorder(rec)
        e.advance(e.buffer_size / LIVE_SR)
        polls.append((tuner.poll_output(), onset.poll_onsets(),
                      e.poll_dynamics()))
    return dict(engine=e, rec=rec, polls=polls,
                fused_at_attach=fused_at_attach)


@pytest.fixture(scope="module")
def live():
    """Sessions by (kind, attach slot), each run once a module."""
    sessions = {}

    def get(kind, attach_slot):
        if (kind, attach_slot) not in sessions:
            sessions[kind, attach_slot] = _live_session(kind, attach_slot)
        return sessions[kind, attach_slot]
    return get


def _assert_polls(got, want):
    assert len(got) == len(want)
    for k, ((gt, go, gd), (wt, wo, wd)) in enumerate(zip(got, want)):
        assert gd == wd, f"slot {k} dynamics"
        gt, wt = json.loads(gt), json.loads(wt)
        for key in TUNER_EXACT:
            assert gt[key] == wt[key], f"slot {k} tuner {key}"
        assert abs(gt["cents"] - wt["cents"]) <= CENTS_TOL, f"slot {k}"
        go, wo = json.loads(go), json.loads(wo)
        assert len(go) == len(wo), f"slot {k} onset count"
        for a, b in zip(go, wo):
            assert a["raw_sample_offset"] == b["raw_sample_offset"]
            assert a["beat_position"] == b["beat_position"]
            assert abs(a["velocity"] - b["velocity"]) <= VELOCITY_TOL


@pytest.mark.parametrize("attach_slot", [0, 47])    # 0 s and ~1 s
def test_engine_with_recorder_matches_jax(live, attach_slot):
    t, j = live("port", attach_slot), live("jax", attach_slot)
    e, ej = t["engine"], j["engine"]
    assert e._fused_slots == ej._fused_slots == t["fused_at_attach"] \
        == j["fused_at_attach"]
    assert (e._fused_slots > 0) == (attach_slot > 0)
    _assert_polls(t["polls"], j["polls"])
    assert sum(len(json.loads(o)) for _, o, _ in t["polls"]) >= 2
    _assert_records(t["rec"], j["rec"])
    to, jo = list(t["rec"].onset_frames), list(j["rec"].onset_frames)
    assert len(to) == len(jo) > 0
    assert [r.frame for r in to] == [r.frame for r in jo]
    assert [r.status for r in to] == [r.status for r in jo]
    assert [(r.fired, r.detected, r.burst_count) for r in to] == \
        [(r.fired, r.detected, r.burst_count) for r in jo]
    np.testing.assert_allclose([r.flux for r in to], [r.flux for r in jo],
                               rtol=1e-6, atol=1e-6)
    assert any(r.fired for r in to)
    assert {r.status.split(":")[0].split(" ")[0] for r in to} >= {
        "DETECTED", "idle"}


def test_recorder_leaves_decisions_unchanged(live):
    """Within the port: attached at slot 47, the polls before it are the
    fused session's and after it the sequential consumers' at full width;
    both equal an engine without a recorder slot for slot."""
    e = _live_engine("port")
    tuner, onset = e.start_tuner(), e.start_onset_detection()
    plain = []
    for _ in range(int(LIVE_SECONDS * LIVE_SR / e.buffer_size)):
        e.advance(e.buffer_size / LIVE_SR)
        plain.append((tuner.poll_output(), onset.poll_onsets(),
                      e.poll_dynamics()))
    _assert_polls(live("port", 47)["polls"], plain)


def test_jsonl_stream_is_live_and_renders(tmp_path):
    """A JsonlStreamRecorder on the port's engine (JAX
    tests/test_devtools.py's flow): records reach the file while the
    engine runs, and DebugStreamView / `cli debug-view` render them."""
    sr = 48000.0
    tone = np.zeros(int(1.2 * sr), np.float32)
    note = gen.tone_with_harmonics(440.0, 0.9, sr, harmonics=5, amplitude=0.4)
    tone[int(0.3 * sr):int(0.3 * sr) + len(note)] = note
    path = str(tmp_path / "debug.jsonl")
    e = AudioEngine(input_source=ArraySource(tone), sample_rate=sr,
                    device="cpu")
    e.transport.set_calibration_offset(1)
    rec = devtools.JsonlStreamRecorder(path, include_spectrum=True)
    e.attach_debug_recorder(rec)
    e.start_tuner()
    e.start_onset_detection()
    e.advance(0.5)
    mid = open(path).read().splitlines()
    assert mid, "no live records after 0.5 s"
    e.advance(0.5)
    rec.close()
    lines = open(path).read().splitlines()
    assert len(lines) > len(mid)
    records = [json.loads(line) for line in lines]
    assert {r["kind"] for r in records} == {"pitch", "onset"}
    pitch = [r for r in records if r["kind"] == "pitch"]
    assert len(pitch[0]["magnitudes"]) == len(pitch[0]["noise_floor"]) \
        == HALF
    labels = [p["label"] for r in pitch for p in r["stable_pitches"]]
    assert any(lbl.startswith("A4") for lbl in labels), labels
    assert any(r["status"] != "idle" for r in records if r["kind"] == "onset")
    view = devtools.DebugStreamView()
    events = [ev for ev in map(view.feed, records) if ev]
    assert any("A4" in ev for ev in events)
    assert view.n_pitch == len(pitch) and view.floor_db is not None
    import io
    out = io.StringIO()
    cli.cmd_debug_view(path, follow=False, out=out)
    assert (f"{len(pitch)} pitch frames, {len(records) - len(pitch)} onset "
            "frames") in out.getvalue()


@pytest.mark.parametrize("args", [
    (True, True, False, True, 5, 12.0, 4),
    (False, True, True, True, 5, 12.0, 4),
    (False, True, False, False, 5, 12.0, 4),
    (False, True, False, True, 1, 12.0, 4),
    (False, False, False, False, 5, 3.0, 1),
    (False, False, False, False, 5, 0.0, 0)])
def test_onset_status_labels_match_jax(args):
    assert devtools.onset_status(*args) == jdev.onset_status(*args)


def test_note_labels_match_jax():
    for f in (0.0, 27.5, 261.63, 440.0, 445.0, 4186.0):
        assert devtools.freq_to_note_label(f) == jdev.freq_to_note_label(f)
