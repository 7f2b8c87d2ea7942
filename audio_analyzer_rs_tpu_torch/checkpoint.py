"""Checkpoint / resume of streaming analyzer and engine state (port of
audio_analyzer_rs_tpu/checkpoint.py).

The reference has no checkpointing (SURVEY §5: "Sessions are ephemeral");
this module snapshots carried state to `.npz`/JSON and restores it
bit-exactly:

* per-analyzer: `save_pitch_analyzer` / `save_onset_analyzer` (noise-floor
  scan carry, tracker slots, onset detector state, ring-buffer tails);
* transport: `save_transport` (beat/frame counters, latency, calibration);
* engine-level: `save_engine` / `load_engine` — one file covering the whole
  streaming-analysis substrate of a live AudioEngine: reducer biquad/gate
  state and AGC histories (host Python or native C++ path), dynamics
  output, transport, and any active tuner/onset consumer's analyzer state
  plus its alignment counters.  Restore into an engine configured the same
  way (same sample rate/buffer size, same consumers started); output
  generators (metronome/synth/player) and in-flight recordings are out of
  scope, as in the JAX package.

The files are the JAX package's: the same `.npz` keys, a state's leaves in
field order (which is `jax.tree.leaves` order for its NamedTuples) without
this port's stream axis, and the same JSON.  A file either package saved
loads into the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from .interop import STATE_DTYPES
from .models.analyzer import OnsetAnalyzer, PitchAnalyzer
from .ops.noisefloor import NoiseFloorState
from .ops.onset import OnsetState
from .ops.tracker import TrackerState
from .transport import MusicalTransport


def _flatten(prefix: str, state) -> Dict[str, np.ndarray]:
    """A port state (leaves with a stream axis of 1) → {prefix<i>: leaf}
    in field order, the stream axis dropped (the JAX package's shapes)."""
    return {f"{prefix}{i}": leaf[0].detach().cpu().numpy()
            for i, leaf in enumerate(state)}


def _unflatten(prefix: str, cls, data, device) -> Any:
    """{prefix<i>: leaf} → a port state of class `cls` on `device`, each
    leaf given its stream axis of 1 and the port's dtype."""
    return cls(*(torch.from_numpy(np.array(data[f"{prefix}{i}"]))[None]
                 .to(device=device, dtype=dtype)
                 for i, dtype in enumerate(STATE_DTYPES[cls])))


def _meta_bytes(meta: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_pitch_analyzer(path: str, analyzer: PitchAnalyzer) -> None:
    arrays = _flatten("nf_", analyzer.nf_state)
    arrays.update(_flatten("tr_", analyzer.tr_state))
    arrays["tail"] = analyzer._tail
    arrays["meta"] = _meta_bytes({
        "sample_rate": analyzer.sample_rate, "window": analyzer.window,
        "hop": analyzer.hop, "backend": analyzer.backend,
        "frames_consumed": analyzer.frames_consumed,
    })
    np.savez(path, **arrays)


def load_pitch_analyzer(path: str, device="cuda") -> PitchAnalyzer:
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    an = PitchAnalyzer(meta["sample_rate"], window=meta["window"],
                       hop=meta["hop"], backend=meta["backend"],
                       device=device)
    an.nf_state = _unflatten("nf_", NoiseFloorState, data, device)
    an.tr_state = _unflatten("tr_", TrackerState, data, device)
    an._tail = np.asarray(data["tail"])
    an.frames_consumed = meta["frames_consumed"]
    return an


def save_onset_analyzer(path: str, analyzer: OnsetAnalyzer) -> None:
    arrays = _flatten("on_", analyzer.state)
    arrays["tail"] = analyzer._tail
    arrays["meta"] = _meta_bytes({
        "sample_rate": analyzer.sample_rate, "window": analyzer.window,
        "hop": analyzer.hop, "backend": analyzer.backend,
        "frames_consumed": analyzer.frames_consumed,
    })
    np.savez(path, **arrays)


def load_onset_analyzer(path: str, device="cuda") -> OnsetAnalyzer:
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    an = OnsetAnalyzer(meta["sample_rate"], window=meta["window"],
                       hop=meta["hop"], backend=meta["backend"],
                       device=device)
    an.state = _unflatten("on_", OnsetState, data, device)
    an._tail = np.asarray(data["tail"])
    an.frames_consumed = meta["frames_consumed"]
    return an


def _transport_dict(t: MusicalTransport) -> Dict[str, Any]:
    return {
        "output_frames": t.output_frames,
        "input_frames": t.input_frames,
        "last_tick_output_frame": t.last_tick_output_frame,
        "tick_history_beats": t._tick_history_beats,
        "tick_history_count": t._tick_history_count,
        "bpm": t._bpm,
        "accumulated_beats": t._accumulated_beats,
        "is_playing": t._is_playing,
        "output_latency_samples": t._output_latency_samples,
        "input_latency_samples": t._input_latency_samples,
        "calibration_offset_samples": t._calibration_offset_samples,
        "calibration_done": t._calibration_done,
        "ui_latency_s": t._ui_latency_s,
        "sample_rate": t._sample_rate,
    }


def save_transport(path: str, t: MusicalTransport) -> None:
    with open(path, "w") as f:
        json.dump(_transport_dict(t), f)


def _apply_transport(t: MusicalTransport, s: Dict[str, Any]) -> MusicalTransport:
    t.output_frames = s["output_frames"]
    t.input_frames = s["input_frames"]
    t.last_tick_output_frame = s["last_tick_output_frame"]
    t._tick_history_beats = [float(x) for x in s["tick_history_beats"]]
    t._tick_history_count = s["tick_history_count"]
    t._bpm = s["bpm"]
    t._accumulated_beats = s["accumulated_beats"]
    t._is_playing = s["is_playing"]
    t._output_latency_samples = s["output_latency_samples"]
    t._input_latency_samples = s["input_latency_samples"]
    t._calibration_offset_samples = s["calibration_offset_samples"]
    t._calibration_done = s["calibration_done"]
    t._ui_latency_s = s["ui_latency_s"]
    return t


def load_transport(path: str) -> MusicalTransport:
    with open(path) as f:
        s = json.load(f)
    return _apply_transport(MusicalTransport(s["bpm"], s["sample_rate"]), s)


# ── engine-level snapshot (see module docstring for scope) ────────────────

def save_engine(path: str, engine) -> None:
    """Snapshot a live AudioEngine's streaming-analysis state to one .npz.

    Covers: reducer biquad/gate state + AGC histories (host Python path
    always; the native C++ reducer's state too when active), dynamics
    output, transport, onset_pending flag, and — when a tuner / onset
    detection is active — that consumer's analyzer state and alignment
    counters.  Restore with `load_engine` into an engine configured the
    same way (sample rate, buffer size, same consumers started)."""
    from .api.engine import _OnsetConsumer, _PitchConsumer

    # Surface every deferred fused-streaming result first (the pool's
    # waves, a partial aggregate, the readback queue) and hand the carries
    # back, so the snapshot reflects every consumed slot.
    engine.flush_analysis()
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {
        "sample_rate": engine.sample_rate,
        "buffer_size": engine.buffer_size,
        "transport": _transport_dict(engine.transport),
        "dynamics_out": {k: v for k, v in engine.dynamics_out.items()},
        "onset_pending": bool(engine.onset_pending),
    }

    r = engine.reducer
    arrays["red_hp"] = np.asarray(r.hp_state, np.float32)
    arrays["red_lp"] = np.asarray(r.lp_state, np.float32)
    arrays["red_env"] = np.asarray([r.envelope], np.float32)
    meta["red_hold"] = int(r.hold)
    d = engine.dynamics
    arrays["dyn_long"] = d.long
    arrays["dyn_play"] = d.play
    meta["dyn"] = {"long_pos": d.long_pos, "long_filled": d.long_filled,
                   "play_pos": d.play_pos, "play_filled": d.play_filled,
                   "gain": float(d.gain)}
    if engine.native_reducer is not None:
        nf, ni = engine.native_reducer.save_state()
        arrays["native_f"] = nf
        arrays["native_i"] = ni

    for handle, consumer in engine._consumers.items():
        if isinstance(consumer, _PitchConsumer):
            arrays.update(_flatten("tuner_nf_", consumer.analyzer.nf_state))
            arrays.update(_flatten("tuner_tr_", consumer.analyzer.tr_state))
            arrays["tuner_tail"] = consumer.analyzer._tail
            meta["tuner"] = {
                "frames_consumed": consumer.analyzer.frames_consumed,
                "base_input_frame": consumer.base_input_frame,
            }
        elif isinstance(consumer, _OnsetConsumer):
            arrays.update(_flatten("onset_", consumer.analyzer.state))
            arrays["onset_tail"] = consumer.analyzer._tail
            meta["onset"] = {
                "frames_consumed": consumer.analyzer.frames_consumed,
                "base_input_frame": consumer.base_input_frame,
                "dropped_samples": consumer.dropped_samples,
                "calibration_done": consumer.calibration_done,
                "calibration_start_frame": consumer.calibration_start_frame,
            }
    arrays["meta"] = _meta_bytes(meta)
    np.savez(path, **arrays)


def load_engine(path: str, engine) -> None:
    """Restore `save_engine` state into a compatibly-configured engine."""
    from .api.engine import _OnsetConsumer, _PitchConsumer

    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    if (meta["sample_rate"] != engine.sample_rate
            or meta["buffer_size"] != engine.buffer_size):
        raise ValueError(
            f"engine config mismatch: snapshot is "
            f"{meta['sample_rate']}Hz/{meta['buffer_size']}, engine is "
            f"{engine.sample_rate}Hz/{engine.buffer_size}")
    # Leave fused mode first: its device-resident tails and pending flag
    # would otherwise outlive the state restored below.
    engine.flush_analysis()

    _apply_transport(engine.transport, meta["transport"])
    engine.dynamics_out = dict(meta["dynamics_out"])
    engine.onset_pending = bool(meta["onset_pending"])

    r = engine.reducer
    r.hp_state = [np.float32(v) for v in data["red_hp"]]
    r.lp_state = [np.float32(v) for v in data["red_lp"]]
    r.envelope = np.float32(data["red_env"][0])
    r.hold = int(meta["red_hold"])
    d = engine.dynamics
    d.long = np.asarray(data["dyn_long"], np.float32)
    d.play = np.asarray(data["dyn_play"], np.float32)
    d.long_pos = int(meta["dyn"]["long_pos"])
    d.long_filled = bool(meta["dyn"]["long_filled"])
    d.play_pos = int(meta["dyn"]["play_pos"])
    d.play_filled = bool(meta["dyn"]["play_filled"])
    d.gain = np.float32(meta["dyn"]["gain"])
    if "native_f" in data:
        if engine.native_reducer is None:
            raise ValueError("snapshot holds native reducer state but the "
                             "native runtime is not loaded in this engine")
        engine.native_reducer.load_state(data["native_f"], data["native_i"])

    dev = engine.torch_device
    for consumer in engine._consumers.values():
        if isinstance(consumer, _PitchConsumer) and "tuner" in meta:
            an = consumer.analyzer
            an.nf_state = _unflatten("tuner_nf_", NoiseFloorState, data, dev)
            an.tr_state = _unflatten("tuner_tr_", TrackerState, data, dev)
            an._tail = np.asarray(data["tuner_tail"])
            an.frames_consumed = meta["tuner"]["frames_consumed"]
            consumer.base_input_frame = meta["tuner"]["base_input_frame"]
        elif isinstance(consumer, _OnsetConsumer) and "onset" in meta:
            an = consumer.analyzer
            an.state = _unflatten("onset_", OnsetState, data, dev)
            an._tail = np.asarray(data["onset_tail"])
            an.frames_consumed = meta["onset"]["frames_consumed"]
            consumer.base_input_frame = meta["onset"]["base_input_frame"]
            consumer.dropped_samples = meta["onset"]["dropped_samples"]
            consumer.calibration_done = meta["onset"]["calibration_done"]
            consumer.calibration_start_frame = (
                meta["onset"]["calibration_start_frame"])
