"""AudioEngine — the uniffi-shaped public API over the virtual audio device.

Mirrors the reference's exported objects (ref src/lib.rs:63-849): AudioEngine
(constructor, start_input/start_output, create/stop for each worker with a
singleton-per-type "Already active" guard, poll_dynamics / poll_transport
JSON), Tuner, Metronome, Synth, Player, Recording, OnsetDetection, and
PracticeSession — with the same method names, string-enum mappings (including
silent fallbacks), and the same JSON schemas.

The audio path: virtual device input callback → host reducer (biquads + gate,
ref mod.rs:336-511) → AGC/dynamics (ref dynamics.rs) → fan-out to consumers
(recorder / pitch STFT → tuner / onset detector).  The analyzers run on the
engine's torch device (`device`, default "cuda"; the tests pass "cpu", which
runs every kernel's plain version) and are fed per callback; the fan-out is
plain function calls instead of the reference's SlotPool + SPSC rings.

Port of the JAX package's api/engine.py: with the tuner and onset detection
both running, each slot is one `fused_slot_step` (one upload, the kernels,
one packed readback), or a lane of an `EnginePool` wave (api/pool.py).
`pipeline_depth` N >= 1 defers each slot's readback by N slots: the packed
result is copied into page-locked host memory behind a CUDA event, and the
drain waits on that event alone.  `aggregate_slots` A > 1 runs A slots in
one `fused_slot_agg_step`.  Calibration slots at depth >= 1 dispatch
speculatively and roll back at the calibration transition.
`attach_debug_recorder` (devtools) leaves the fused path: the sequential
consumers run, the pitch flow at full width.
"""

from __future__ import annotations

import json
import threading
import time
import wave as wave_mod
from typing import List, Optional

import numpy as np
import torch

from ..models.analyzer import (OnsetAnalyzer, PitchAnalyzer, fused_out_len,
                               fused_slot_agg_step, fused_slot_step,
                               unpack_fused_out)
from ..models.calibration import CalibrationClick
from ..models.metronome import Metronome as MetronomeSource
from ..models.player import AudioPlayer, PlayerController
from ..models.sources import Mixer
from ..models.synth import Synthesizer, instrument_from
from ..models.tuner import Tuner as TunerCore
from ..ops.dynamics import DynamicsTrackerNp, LEVEL_NAMES
from ..ops.onset import HOP as ONSET_HOP, TICK_GUARD_S, WINDOW as ONSET_WINDOW
from ..ops.reducer import HostReducer
from ..ops.stft import PITCH_HOP, PITCH_WINDOW
from ..practice.session import PracticeSession as PracticeCore
from ..practice.types import practice_mode_from_str
from ..utils.framing import num_frames
from ..tracing import get_logger
from ..transport import MusicalTransport, OnsetEvent
from ..utils.wav import quantize_i16
from .device import InputSource, VirtualAudioDevice

_log = get_logger("engine")


class AudioEngineError(Exception):
    pass


class DeviceUnavailable(AudioEngineError):
    def __init__(self, msg):
        super().__init__(f"Audio device unavailable: {msg}")


class StreamFailed(AudioEngineError):
    def __init__(self, msg):
        super().__init__(f"Audio stream failed: {msg}")


class SpawnFailed(AudioEngineError):
    def __init__(self, component, msg):
        super().__init__(f"Failed to start {component}: {msg}")


class FileError(AudioEngineError):
    def __init__(self, msg):
        super().__init__(f"File error: {msg}")


class InternalError(AudioEngineError):
    def __init__(self, msg):
        super().__init__(f"Internal engine error: {msg}")


# ── Host <-> device transfers of the fused path ──────────────────────────

def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 host array onto `device`: on CUDA through page-locked
    memory, asynchronously (the caching host allocator does not reuse the
    staging block before the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(host, np.float32))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Readback:
    """A deferred device->host read of one packed result vector (the GPU
    form of the JAX package's `copy_to_host_async`): on CUDA the copy into
    a page-locked buffer is queued now, with an event recorded behind it on
    the current stream; `wait()` waits on that event alone, then numpy
    reads the buffer.  The buffer belongs to this object, so nothing reuses
    it while its entry is queued.  A CPU vector is already on the host."""

    def __init__(self, vec: torch.Tensor):
        if vec.device.type != "cuda":
            self._host, self._event = vec, None
            return
        self._host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        self._host.copy_(vec, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(vec.device))

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()



# ── Exported objects (ref lib.rs:63-351) ─────────────────────────────────

class Tuner:
    def __init__(self, core: TunerCore):
        self._core = core

    def poll_output(self) -> str:
        return json.dumps(self._core.output.to_dict())

    def output_handle(self) -> TunerCore:
        return self._core

    def set_base_freq(self, freq: float) -> None:
        self._core.send("SetBaseFreq", freq)

    def set_key(self, key: str) -> None:
        self._core.send("SetKey", key)

    def set_mode(self, mode: str) -> None:
        # Silent fallback mapping (ref lib.rs:95-104).
        self._core.send("SetMode",
                        "SinglePitch" if mode == "SinglePitch" else "MultiPitch")

    def set_system(self, system: str) -> None:
        self._core.send("SetSystem",
                        "JustIntonation" if system == "JustIntonation"
                        else "EqualTemperament")

    def send(self, *cmd) -> None:
        self._core.send(*cmd)


def _pattern_from_ints(pattern: List[int]) -> List[str]:
    """3→Strong 2→Medium 1→Weak else None (ref lib.rs:136-145)."""
    return [{3: "Strong", 2: "Medium", 1: "Weak"}.get(p, "None")
            for p in pattern]


class Metronome:
    def __init__(self, source: MetronomeSource):
        self._source = source

    def set_bpm(self, bpm: float) -> bool:
        return self._source.send("SetBpm", bpm)

    def set_volume(self, volume: float) -> bool:
        return self._source.send("SetVolume", volume)

    def set_pattern(self, pattern: List[int]) -> bool:
        return self._source.send("SetPattern", _pattern_from_ints(pattern))

    def set_muted(self, muted: bool) -> bool:
        return self._source.send("SetMuted", muted)

    def set_polyrhythm(self, subdivisions: List[int], beat_index: int) -> bool:
        return self._source.send("SetPolyrhythm", list(subdivisions), beat_index)


class Synth:
    def __init__(self, source: Synthesizer):
        self._source = source

    @staticmethod
    def _instrument(name: str) -> str:
        # Silent fallback: Piano else Violin (ref lib.rs:179-182).
        return "Piano" if name == "Piano" else "Violin"

    def load_file(self, path: str, instrument: str) -> bool:
        return self._source.send("LoadFile", path, self._instrument(instrument))

    def play(self, start_measure_idx: int) -> bool:
        return self._source.send("Play", start_measure_idx)

    def play_note(self, freq: float, velocity: float, instrument: str) -> bool:
        if velocity > 0.0:
            return self._source.send("NoteOn", freq, velocity,
                                     self._instrument(instrument))
        return self._source.send("NoteOff", freq)

    def pause(self) -> None:
        self._source.send("Pause")

    def resume(self) -> None:
        self._source.send("Resume")

    def clear(self) -> bool:
        return self._source.send("Clear")

    def set_volume(self, volume: float) -> None:
        self._source.send("SetVolume", volume)

    def set_muted(self, muted: bool) -> bool:
        return self._source.send("SetMuted", muted)


class Player:
    def __init__(self, controller: PlayerController):
        self._controller = controller

    def load_track(self, path: str) -> None:
        try:
            self._controller.load_file(path)
        except (OSError, ValueError, EOFError) as e:
            raise FileError(str(e))

    def play(self) -> None:
        self._controller.play()

    def pause(self) -> None:
        self._controller.pause()

    def seek(self, seconds: float) -> None:
        self._controller.seek(seconds)

    def is_playing(self) -> bool:
        """True while playback is active (drops when the cursor passes the
        decoded track end or after pause/stop)."""
        return self._controller.is_playing()

    def is_finished(self) -> bool:
        """True once stop_player() retired this source from the mixer."""
        return self._controller.is_finished()


class Recording:
    """Recorder consumer (ref audio_io/recorder.rs, lib.rs:283-302).

    WAV (the reference's hound path) streams i16 frames to disk as they
    arrive; any other extension (flac/ogg/...) buffers float32 and encodes
    through the native FFmpeg module on stop — beyond the reference, which
    is WAV-only."""

    # Flush cadence: every 8 slots, like the reference's hound writer
    # (ref audio_io/recorder.rs:69-79) — a crash mid-recording loses at
    # most 8 slots of audio (the data chunk survives; only the RIFF
    # length header needs patching, same as an unflushed hound file).
    FLUSH_EVERY_SLOTS = 8

    def __init__(self, path: str, sample_rate: int):
        self._path = path
        self._rate = sample_rate
        self.state = 1   # -1 stop / 0 pause / 1 run
        self._finalized = False
        self._slots_since_flush = 0
        if path.lower().endswith(".wav"):
            self._file = open(path, "wb")
            self._writer = wave_mod.open(self._file, "wb")
            self._writer.setnchannels(1)
            self._writer.setsampwidth(2)
            self._writer.setframerate(sample_rate)
            self._pending = None
        else:
            from .. import runtime as native_runtime
            if not native_runtime.decode_available():
                raise FileError(
                    f"cannot encode {path!r}: FFmpeg libs unavailable")
            if not native_runtime.encode_supported(path):
                raise FileError(
                    f"cannot encode {path!r}: no encoder for extension")
            self._writer = None
            self._pending: List[np.ndarray] = []

    def consume(self, slot: np.ndarray) -> None:
        if self.state != 1:
            return
        if self._writer is not None:
            self._writer.writeframes(quantize_i16(slot).tobytes())
            self._slots_since_flush += 1
            if self._slots_since_flush >= self.FLUSH_EVERY_SLOTS:
                self._file.flush()
                self._slots_since_flush = 0
        else:
            self._pending.append(np.asarray(slot, np.float32).copy())

    def pause(self) -> None:
        self.state = 0

    def resume(self) -> None:
        self.state = 1

    def stop(self) -> None:
        self.state = -1
        if self._finalized:
            return
        self._finalized = True
        if self._writer is not None:
            self._writer.close()
            self._file.close()
        else:
            from .. import runtime as native_runtime
            samples = (np.concatenate(self._pending)
                       if self._pending else np.zeros(1, np.float32))
            native_runtime.encode_file(self._path, samples, self._rate)
            self._pending = []


class OnsetDetection:
    def __init__(self, engine: "AudioEngine"):
        self._engine = engine
        self._events: List[OnsetEvent] = []
        self.state = 1
        self._lock = threading.Lock()

    def _push(self, event: OnsetEvent) -> None:
        with self._lock:
            self._events.append(event)

    def drain_onset_events(self) -> List[OnsetEvent]:
        with self._lock:
            events, self._events = self._events, []
        return events

    def poll_onsets(self) -> str:
        """Exact manual JSON format (ref lib.rs:326-338)."""
        items = [
            f'{{"beat_position":{e.beat_position:.6f},'
            f'"raw_sample_offset":{e.raw_sample_offset},'
            f'"velocity":{e.velocity:.4f}}}'
            for e in self.drain_onset_events()]
        return "[" + ",".join(items) + "]"

    def pause(self) -> None:
        self.state = 0

    def resume(self) -> None:
        self.state = 1

    def stop(self) -> None:
        self.state = -1


class PracticeSession:
    def __init__(self, core: PracticeCore):
        self._core = core

    def start(self, start_measure: int, end_measure: int) -> None:
        try:
            self._core.start(start_measure, end_measure)
        except ValueError as e:
            raise InternalError(str(e))

    def stop(self) -> None:
        self._core.stop()

    def tick(self) -> bool:
        return self._core.tick()

    def poll_transport(self) -> str:
        return self._core.poll_transport()

    def poll_errors(self) -> str:
        return self._core.poll_errors()

    def get_metrics(self) -> str:
        return self._core.get_metrics()

    def is_running(self) -> bool:
        return self._core.is_running()

    def set_tuner_mode(self, mode: str) -> None:
        self._core.set_tuner_mode(mode)

    def set_bpm(self, bpm: float) -> None:
        self._core.set_bpm(bpm)


# ── Pitch / onset consumers (the reference's worker threads) ─────────────

class _PitchConsumer:
    """STFT pitch worker + tuner (ref stft.rs:155-441, tuner.rs:129-211).

    Tuner outputs are produced per analysis frame (~11.6 ms) but consumed by
    polling; frames computed in one burst are queued and released one per
    practice tick so the 10 ms poll loop sees (nearly) every frame, exactly
    like the reference's RwLock updated by the free-running tuner thread."""

    def __init__(self, engine: "AudioEngine"):
        self.engine = engine
        self.analyzer = PitchAnalyzer(engine.sample_rate,
                                      device=engine.torch_device)
        self.analyzer.debug_recorder = engine.debug_recorder
        self.tuner_core = TunerCore()
        self.pending_outputs: List = []
        self.state = 1
        # Input-frame position at attach: the analyzer's frame counter is
        # consumer-relative, the transport's input_frames is engine-absolute.
        # A consumer started after input has been running must add this or
        # every stamped beat lags by the prior input duration.
        self.base_input_frame = engine.transport.get_input_frames()

    def release_output(self) -> None:
        """Publish the next queued per-frame TunerOutput (time passing)."""
        if self.pending_outputs:
            self.tuner_core.output = self.pending_outputs.pop(0)

    def consume(self, slot: np.ndarray) -> None:
        if self.state != 1:
            return
        e = self.engine
        # onset_pending is consumed once per burst (ref stft.rs:387 swaps it
        # per frame; the flag can only be set once between bursts here).
        onset_flag = e.onset_pending
        e.onset_pending = False
        base = self.analyzer.frames_consumed
        out = self.analyzer.process(
            slot, global_floor_db=e.dynamics_out["noise_floor_db"],
            onset_first=onset_flag)
        if out is None:
            return
        self._post(out, base)

    def _post(self, out, base: int, anchor: Optional[dict] = None) -> None:
        """Host side of a processed burst: stamp per-frame beats and feed the
        tuner (shared by the sequential and fused engine paths — `out` only
        needs the stable_* fields).  `anchor` is the transport snapshot from
        consume time, which the fused path passes."""
        e = self.engine
        n = len(out.stable_freqs)
        if anchor is None:
            anchor = e.transport.anchor()
        # Deterministic per-frame beats: each frame is stamped at the input
        # sample where its window ended (the reference stamps with the beat
        # at thread-emission time; sample-indexed time makes that exact).
        total_in = anchor["input_frames"]
        frame_end = (self.base_input_frame
                     + (base + np.arange(n)) * PITCH_HOP + PITCH_WINDOW)
        beats_per_sample = anchor["bpm"] / (60.0 * e.sample_rate)
        now_beat = anchor["beats"]
        for i in range(n):
            pitches = [(float(out.stable_freqs[i][j]), float(out.stable_scores[i][j]))
                       for j in range(out.stable_valid.shape[1])
                       if out.stable_valid[i][j]]
            if pitches:
                beat = now_beat - (total_in - frame_end[i]) * beats_per_sample
                self.tuner_core.process(pitches, beat)
                self.pending_outputs.append(self.tuner_core.output)
        # Keep at most one burst queued (stale frames age out like the
        # reference's overwritten RwLock).
        self.pending_outputs = self.pending_outputs[-4:]


class _OnsetConsumer:
    """Onset worker incl. latency self-calibration (ref onset.rs:104-546)."""

    def __init__(self, engine: "AudioEngine", detection: OnsetDetection):
        self.engine = engine
        self.detection = detection
        self.analyzer = OnsetAnalyzer(engine.sample_rate,
                                      device=engine.torch_device)
        self.calibration_done = engine.transport.is_calibrated()
        self.calibration_start_frame = engine.transport.get_output_frames()
        self.calibration_timeout = int(engine.sample_rate) * 2
        # Samples dropped while paused: frame positions derived from the
        # analyzer's frame counter must be shifted by this to stay aligned
        # with the transport's input_frames (the reference stamps relative
        # to its live ring, so pause/resume never skews its timestamps).
        self.dropped_samples = 0
        # Input-frame position at attach (see _PitchConsumer.base_input_frame).
        self.base_input_frame = engine.transport.get_input_frames()

    def _tick_suppression(self, n_expected: int) -> np.ndarray:
        """Per-frame tick suppression from the transport's tick history
        (ref onset.rs:383-395 stamps then checks the history).  Must be
        called BEFORE the analyzer consumes the burst (frame positions are
        derived from its current frame counter).

        Vectorized over the burst: the transport state is frozen once
        (`anchor` + tick-history snapshot) and the per-frame stamped beat
        positions and nearest-tick distances compute in one numpy pass —
        bitwise-identical to per-frame `stamp_onset` +
        `nearest_tick_distance_beats` calls (same float64 expression
        order; nothing mutates the transport mid-burst; measured 0
        mismatches over live metronome sessions), and ~2.4x cheaper on
        the host (35 -> 15 us/burst), which adds up at pool scale: K
        engines x (2 locked transport calls x 16 frames) per wave become
        K x 2 locks."""
        t = self.engine.transport
        ticks = t.tick_history_snapshot()
        if n_expected == 0 or ticks.size == 0:
            # No metronome/click has ever ticked (the common plain
            # tuner+onset session): nothing can be suppressed — skip the
            # stamping math entirely.
            return np.zeros(n_expected, dtype=bool)
        base = self.analyzer.frames_consumed
        anchor = t.anchor()
        guard_beats = TICK_GUARD_S * anchor["bpm"] / 60.0
        bps = anchor["bpm"] / (60.0 * t._sample_rate)
        latency_beats = (anchor["input_lat"] + anchor["output_lat"]) * bps
        calibration_beats = anchor["calibration"] * bps
        centers = (self.base_input_frame
                   + (base + np.arange(n_expected)) * ONSET_HOP
                   + ONSET_WINDOW // 2 + self.dropped_samples)
        offset_beats = (centers - anchor["input_frames"]) * bps
        beat_pos = ((anchor["beats"] - latency_beats) + offset_beats
                    - calibration_beats)
        dists = np.abs(beat_pos[:, None] - ticks[None, :]).min(axis=1)
        return dists < guard_beats

    def consume(self, slot: np.ndarray) -> None:
        if self.detection.state != 1:
            self.dropped_samples += len(slot)
            return
        e = self.engine
        n_expected = num_frames(len(self.analyzer._tail) + len(slot),
                                ONSET_WINDOW, ONSET_HOP)
        base = self.analyzer.frames_consumed
        tick_sup = self._tick_suppression(n_expected)
        out = self.analyzer.process(
            slot, global_floor_db=e.dynamics_out["noise_floor_db"],
            tick_suppressed=tick_sup,
            calibration_hold=not self.calibration_done)
        if out is None:
            return
        self._post(out, tick_sup, base)

    def _post(self, out, tick_sup: np.ndarray, base: int,
              anchor: Optional[dict] = None) -> None:
        """Host side of a processed burst: debug telemetry, calibration
        handling, event stamping (shared by sequential and fused paths).
        `anchor` is the consume-time transport snapshot (see
        _PitchConsumer._post)."""
        e = self.engine
        t = e.transport
        if anchor is None:
            anchor = e._stamp_anchor()
        n = len(out.fired)
        if e.debug_recorder is not None:
            from .. import devtools
            for i in range(n):
                fired_i, det_i = bool(out.fired[i]), bool(out.detected[i])
                e.debug_recorder.log_onset_frame(devtools.OnsetFrameRecord(
                    frame=base + i, flux=float(out.flux[i]),
                    burst_count=int(out.burst_count[i]), detected=det_i,
                    fired=fired_i,
                    status=devtools.onset_status(
                        fired_i, det_i, bool(tick_sup[i]),
                        bool(out.energy_rising[i]),
                        int(out.frames_since[i]), float(out.flux[i]),
                        int(out.burst_count[i]))))
        # Calibration timeout (ref onset.rs:361-371).  Elapsed frames come
        # from the consume-time anchor, not the live transport: a post sees
        # the clock as it stood when its slot was consumed.
        if not self.calibration_done:
            elapsed = anchor["output_frames"] - self.calibration_start_frame
            if elapsed > self.calibration_timeout:
                _log.warning("onset calibration timed out after %d samples "
                             "— using offset 0", elapsed)
                t.set_calibration_offset(0)
                self.calibration_done = True
        for i in range(n):
            if not out.fired[i]:
                continue
            center = (self.base_input_frame + (base + i) * ONSET_HOP
                      + ONSET_WINDOW // 2 + self.dropped_samples)
            offset = center - anchor["input_frames"]
            event = t.stamp_onset_anchored(anchor, int(offset),
                                           float(out.velocity[i]))
            if not self.calibration_done:
                # Anchored for the same reason as the timeout above: a post
                # must not see a click target published after its slot was
                # consumed.
                target = anchor.get("calibration_target",
                                    e.calibration_target)
                if target == 0:
                    _log.debug("pre-calibration onset ignored (target not set)")
                    continue
                residual = event.output_samples - target
                if residual < 0 or residual > int(e.sample_rate * 0.5):
                    _log.warning(
                        "onset calibration: rejected implausible residual "
                        "(%.1fms) — retrying",
                        residual * 1000.0 / e.sample_rate)
                    continue
                _log.info("onset calibration: residual=%.1fms (%d samples) "
                          "at target frame %d",
                          residual * 1000.0 / e.sample_rate, residual, target)
                t.set_calibration_offset(int(residual))
                self.calibration_done = True
                e.onset_pending = False
                # The accepted event resets the refractory counter (the scan
                # held it during calibration; ref onset.rs:535-537).
                since = self.analyzer.state.frames_since_onset
                self.analyzer.state = self.analyzer.state._replace(
                    frames_since_onset=torch.zeros_like(since))
            else:
                self.detection._push(event)
                e.onset_pending = True

    def _calibration_transition(self, out, base: int, anchor: dict) -> bool:
        """Would `_post(out, tick_sup, base, anchor)` end the calibration
        hold (timeout crossing or click acceptance)?  A pure pre-check with
        no side effects, mirroring `_post`'s calibration decisions exactly:
        the speculative calibration dispatch (solo `_fused_drain_entry`,
        api/pool.py) uses it to decide whether the one in-flight
        optimistic slot must be rolled back and rebuilt.  Any drift from
        `_post` makes speculative state diverge from the synchronous
        order, which the rollback tests catch.  Port of the JAX package's
        `_calibration_transition` (api/engine.py:569)."""
        if self.calibration_done:
            return False
        if len(out.fired) == 0:
            # _fused_post calls _post only for bursts with onset frames, so
            # an empty burst never transitions, not even past the timeout.
            return False
        elapsed = anchor["output_frames"] - self.calibration_start_frame
        if elapsed > self.calibration_timeout:
            return True
        target = anchor.get("calibration_target",
                            self.engine.calibration_target)
        if target == 0:
            return False
        t = self.engine.transport
        for i in range(len(out.fired)):
            if not out.fired[i]:
                continue
            center = (self.base_input_frame + (base + i) * ONSET_HOP
                      + ONSET_WINDOW // 2 + self.dropped_samples)
            event = t.stamp_onset_anchored(
                anchor, int(center - anchor["input_frames"]),
                float(out.velocity[i]))
            residual = event.output_samples - target
            if 0 <= residual <= int(self.engine.sample_rate * 0.5):
                return True
        return False


# ── The main engine (ref lib.rs:434-849) ─────────────────────────────────

class AudioEngine:
    def __init__(self, input_source: Optional[InputSource] = None,
                 sample_rate: float = 48000.0, buffer_size: int = 1024,
                 loopback_latency_samples: int = 0,
                 loopback_gain: float = 0.0, use_native: bool = True,
                 device: str | torch.device = "cuda"):
        self.sample_rate = float(sample_rate)
        self.buffer_size = int(buffer_size)
        # The torch device the analyzers and the fused slot program run on
        # (`self.device` is the virtual audio device, as in the reference).
        # Nothing falls back to the CPU: "cpu" runs the kernels' plain
        # versions only when asked for.
        self.torch_device = torch.device(device)
        self.device = VirtualAudioDevice(
            sample_rate=sample_rate, buffer_size=buffer_size,
            input_source=input_source,
            loopback_latency_samples=loopback_latency_samples,
            loopback_gain=loopback_gain)
        self.transport = MusicalTransport(120.0, sample_rate)
        # Seed latency estimates from the buffer size (ref mod.rs:242-247).
        self.transport.set_output_latency(buffer_size)
        self.transport.set_input_latency(buffer_size)
        self.mixer = Mixer(1)
        # Host conditioning path: native C++ (the reference's reducer thread
        # equivalent) when built, pure-Python fallback otherwise.
        self.native_reducer = None
        if use_native:
            from .. import runtime as native_runtime
            if native_runtime.available():
                self.native_reducer = native_runtime.NativeReducer(
                    sample_rate, buffer_size)
        self.reducer = HostReducer(sample_rate)
        # target -18 dBFS / max boost 100 dB / 240 s TC (ref mod.rs:341-349)
        self.dynamics = DynamicsTrackerNp(sample_rate, buffer_size)
        self.dynamics_out = {"level": -1, "rms_db": -96.0, "gain_db": 0.0,
                             "session_median_db": -96.0,
                             "noise_floor_db": -96.0}
        self.onset_pending = False
        # Fused streaming: when both live flows (pitch + onset) run, each
        # slot is ONE device program covering calibration and steady state
        # (one upload, the kernels, one readback) instead of two
        # independent consumer steps — see models/analyzer.fused_slot_step.
        # Results are identical (tested); set False to force the
        # sequential per-consumer path.
        self.fused_streaming = True
        # Deferred-readback depth of the fused path: slot k's results are
        # read back and posted only after slot k+depth has been dispatched,
        # so the host enqueues the next slot while the card runs this one.
        # 0 = synchronous (results visible the same slot); N >= 1 = results
        # surface N slots (~N*21 ms) later, a latency constant like the
        # reference's free-running analysis threads (ref src/lib.rs:80-82:
        # every consumer surface is poll-based).  While latency calibration
        # holds, depth 0 stays synchronous and N >= 1 runs the calibration
        # slots speculatively at a depth of 1, rolled back at the
        # transition (_fused_consume, _fused_drain_entry).
        self.pipeline_depth = 0
        # Slot aggregation: every A-th slot dispatches ONE chained program
        # over the last A slots (models/analyzer.fused_slot_agg_step).
        # Results surface up to A slots later (plus pipeline_depth
        # dispatches), bitwise equal otherwise.  1 = per-slot dispatch.
        # Forced to 1 while latency calibration runs (acceptance rewrites
        # scan state between slots, ref onset.rs:404-440).
        self.aggregate_slots = 1
        self._fused_slots = 0      # observability: slots run via fused path
        self._agg_dispatches = 0   # observability: aggregate dispatches
        self._spec_rollbacks = 0   # observability: speculative rollbacks
        self._resident = None      # device-resident fused-stream carries
        self._pool = None          # EnginePool membership (api/pool.py)
        self.calibration_target = 0
        self.debug_recorder = None   # devtools recorder (attach_debug_recorder)
        self.input_error = False
        self.output_error = False
        self._consumers: dict = {}
        self._available_handles = list(range(255, -1, -1))
        self.active_tuner: Optional[Tuner] = None
        self.active_metronome: Optional[Metronome] = None
        self.active_synth: Optional[Synth] = None
        self.active_player: Optional[Player] = None
        self.active_recording: Optional[Recording] = None
        self.active_onset: Optional[OnsetDetection] = None
        self.active_practice_session: Optional[PracticeSession] = None
        self._epoch = time.monotonic()
        self.device.input_callback = self._input_callback
        self.device.output_callback = self._output_callback

    # ── stream control + failure recovery (ref mod.rs:561-655) ──────────

    def start_input(self) -> None:
        if self.input_error:
            # Async stream error detected: tear down, rebuild the input
            # infrastructure, reset calibration, retry (ref mod.rs:585-622).
            _log.warning("detected async input error — restarting input")
            self.stop_input()
            self.reducer = HostReducer(self.sample_rate)
            self.dynamics = DynamicsTrackerNp(self.sample_rate,
                                              self.buffer_size)
            if self.native_reducer is not None:
                from .. import runtime as native_runtime
                self.native_reducer = native_runtime.NativeReducer(
                    self.sample_rate, self.buffer_size)
            self.transport.reset_calibration()
            self.input_error = False
        self.device.input_running = True

    def start_output(self) -> None:
        if self.output_error:
            _log.warning("detected async output error — restarting output")
            self.stop_output()
            self.transport.reset_calibration()
            self.output_error = False
        self.device.output_running = True
        self.transport.play()

    def stop_input(self) -> None:
        self.device.input_running = False

    def stop_output(self) -> None:
        self.transport.stop()
        self.device.output_running = False

    def inject_input_error(self) -> None:
        """Fault injection for tests (the cpal error callback analog,
        ref mod.rs:673-676)."""
        self.input_error = True
        self.stop_input()

    def inject_output_error(self) -> None:
        self.output_error = True
        self.stop_output()

    def clean_input(self) -> None:
        if not self._consumers:
            self.stop_input()

    def clean_output(self) -> None:
        if not self.mixer.has_sources():
            self.stop_output()

    def run_realtime(self, seconds: float) -> None:
        """Run the device in wall-clock time (the realtime simulation mode):
        one buffer per buffer-period, like the reference's audio callbacks."""
        import time as _time
        n = int(round(seconds * self.sample_rate)) // self.buffer_size
        period = self.buffer_size / self.sample_rate
        next_t = _time.monotonic()
        for _ in range(n):
            self.advance(period)
            next_t += period
            sleep = next_t - _time.monotonic()
            if sleep > 0:
                _time.sleep(sleep)

    def advance(self, seconds: float) -> None:
        """Run virtual time forward (offline deterministic mode).

        The practice loop ticks at ~10 ms (ref practice/mod.rs:558); one
        1024-sample buffer is ~21 ms, so each device step runs two practice
        ticks, releasing one queued per-frame tuner output before each —
        the virtual twin of the reference's free-running poll loop."""
        n = int(round(seconds * self.sample_rate)) // self.buffer_size
        for _ in range(n):
            self.device.step()
            self._practice_ticks()

    def _practice_ticks(self) -> None:
        """Per-buffer practice-session housekeeping."""
        ps = self.active_practice_session
        if ps is None or not ps.is_running():
            return
        ticks_per_buffer = max(
            int(round(self.buffer_size / self.sample_rate / 0.010)), 1)
        tuner = self.active_tuner
        for _t in range(ticks_per_buffer):
            if tuner is not None:
                consumer = self._consumers.get(
                    getattr(tuner, "_handle", -1))
                if isinstance(consumer, _PitchConsumer):
                    consumer.release_output()
            if not ps.tick():
                break

    # ── callbacks ────────────────────────────────────────────────────────

    def _output_callback(self, buf: np.ndarray) -> None:
        frames = len(buf)
        self.transport.tick_output(
            frames, self.device.samples_elapsed / self.sample_rate)
        self.mixer.process(buf, 1)

    def _input_callback(self, mono: np.ndarray) -> None:
        self.transport.tick_input(len(mono))
        if self.native_reducer is not None:
            slot, d = self.native_reducer.process_slot(mono)
        else:
            conditioned = self.reducer.process(mono)
            d = self.dynamics.process_slot(conditioned)
            slot = d["slot"]
        self.dynamics_out = {k: d[k] for k in
                             ("level", "rms_db", "gain_db",
                              "session_median_db", "noise_floor_db")}
        # Fused fast path: both live flows in one device program (see
        # _fused_consume) covering calibration and steady state.  Falls
        # back to the sequential consumers when a flow is paused or a
        # debug recorder is attached (the debug path wants the full floor
        # surface).
        pc = oc = None
        if self.fused_streaming and self.debug_recorder is None:
            for c in self._consumers.values():
                if isinstance(c, _PitchConsumer):
                    pc = c
                elif isinstance(c, _OnsetConsumer):
                    oc = c
            if not (pc is not None and oc is not None and pc.state == 1
                    and oc.detection.state == 1
                    and pc.analyzer.debug_recorder is None):
                pc = oc = None
        if pc is None and self._resident is not None:
            # Conditions for fusion just lapsed: surface the deferred
            # results and hand the device-resident carries back to the
            # analyzers before any sequential consume touches them.
            self._flush_fused()
        # Onset before pitch so onset_pending reaches the tracker in-burst
        # (the reference's onset thread runs at 4x the pitch hop rate).
        ordered = sorted(self._consumers.items(),
                         key=lambda kv: 0 if isinstance(kv[1], _OnsetConsumer) else 1)
        for _, consumer in ordered:
            if consumer is pc or consumer is oc:
                continue
            consumer.consume(slot)
        if pc is not None:
            self._fused_consume(slot, pc, oc)

    def _stamp_anchor(self) -> dict:
        """Consume-time stamping snapshot: the transport anchor plus every
        engine-level field a deferred post reads (the calibration click
        target).  All posts, synchronous or deferred, stamp against it,
        which makes readback deferral a pure latency constant."""
        anchor = self.transport.anchor()
        anchor["calibration_target"] = self.calibration_target
        return anchor

    def _enter_fused(self, pc: "_PitchConsumer",
                     oc: "_OnsetConsumer") -> dict:
        """Enter fused mode (solo or pooled): move the ring tails and the
        pending flag to the device.  Returns the residency."""
        dev = self.torch_device
        res = self._resident = {
            "p_tail": torch.from_numpy(
                np.array(pc.analyzer._tail, np.float32)).to(dev),
            "o_tail": torch.from_numpy(
                np.array(oc.analyzer._tail, np.float32)).to(dev),
            "pending": torch.tensor([bool(self.onset_pending)], device=dev),
            "queue": [], "pc": pc, "oc": oc,
        }
        self.onset_pending = False
        return res

    def _fused_consume(self, slot: np.ndarray, pc: "_PitchConsumer",
                       oc: "_OnsetConsumer") -> None:
        """Run both live flows as ONE device program for this slot, with
        ring tails, analyzer states, and the pending flag device-resident.

        Per slot the host uploads one small vector (raw audio + floor
        scalars + hold flag + tick suppression) and reads back one packed
        result, and with `pipeline_depth` N >= 1 that readback is deferred
        N slots, so the host enqueues the next slot's kernels while the
        card runs this one's.  All event and beat stamping is in absolute
        sample time against the consume-time anchor, so deferred posts are
        identical; results merely reach the poll surfaces N slots later.
        Calibration is a data input of the program, so the session runs
        fused from its first slot; an accepted calibration click rewrites
        the onset state between slots (ref onset.rs:404-440), which depth
        0 orders synchronously and depth >= 1 speculatively (see
        _fused_drain_entry).  Under an EnginePool the slot joins the pool's
        wave instead."""
        pool = self._pool
        if pool is not None and pool._collect is not None:
            # Pooled mode: the slot joins the EnginePool's wave, K engines'
            # slots as the lanes of one program (api/pool.py).
            pool._collect.append((self, slot, pc, oc))
            return
        pa, oa = pc.analyzer, oc.analyzer
        slot = np.asarray(slot, np.float32)
        res = self._resident
        if res is None:
            res = self._enter_fused(pc, oc)
        host_vec, n_p, n_o, tick_sup, hold, p_len, o_len = \
            self._fused_inputs(slot, pc, oc)
        agg = 1 if hold else max(int(self.aggregate_slots), 1)
        meta = (n_p, n_o, pa.frames_consumed, oa.frames_consumed, tick_sup,
                self._stamp_anchor())
        if agg > 1:
            # Slot aggregation: accumulate host inputs; every agg-th slot
            # dispatches ONE chained program covering them all.
            acc = res.get("agg")
            if acc is None:
                acc = res["agg"] = {"entries": [], "slot_len": len(slot)}
            acc["entries"].append((host_vec, meta))
            self._fused_slots += 1
            self._fused_advance_host(slot, pc, oc, n_p, n_o)
            if len(acc["entries"]) >= agg:
                self._dispatch_aggregate(pc, oc)
        else:
            if res.get("agg"):
                # Aggregation just turned off (knob change, calibration
                # restart): dispatch the partial aggregate first so the
                # slot order holds.
                self._dispatch_aggregate(pc, oc)
            # Calibration slots dispatch SPECULATIVELY when the session
            # already runs deferred (pipeline_depth >= 1): the next slot
            # goes out before this one's result is read, and the at most
            # one invalidated in-flight dispatch is rolled back and rebuilt
            # at the transition (_fused_drain_entry).  Depth-0 sessions
            # keep the synchronous order.
            spec = None
            if hold and self.pipeline_depth >= 1:
                spec = {"slot": slot,
                        "mirrors": (pa._tail, oa._tail, pa.frames_consumed,
                                    oa.frames_consumed)}
            self._dispatch_slot(pc, oc, host_vec, meta, len(slot), spec=spec)
            self._fused_slots += 1
            self._fused_advance_host(slot, pc, oc, n_p, n_o)
        if hold:
            depth = 1 if self.pipeline_depth >= 1 else 0
        else:
            depth = max(int(self.pipeline_depth), 0)
        while len(res["queue"]) > depth:
            self._fused_drain_entry(res["queue"].pop(0), pc, oc)

    def _dispatch_slot(self, pc: "_PitchConsumer", oc: "_OnsetConsumer",
                       host_vec: np.ndarray, meta: tuple, slot_len: int,
                       spec=None) -> None:
        """Upload the slot's host vector, run one `fused_slot_step` on the
        resident carries and queue its deferred readback.  `spec` (a
        speculative calibration dispatch) carries the raw slot and the
        pre-slot host mirrors and receives the pre-dispatch carries
        ("snap": the very tensors about to be replaced; no op writes into
        a carry, so keeping them is free), so a calibration transition can
        roll this dispatch back and rebuild it."""
        res = self._resident
        pa, oa = pc.analyzer, oc.analyzer
        if spec is not None:
            spec["snap"] = (pa.nf_state, pa.tr_state, oa.state,
                            res["pending"], res["p_tail"], res["o_tail"])
        # The slot's 11 output arrays come back as ONE float32 vector, one
        # device->host copy (models/analyzer.pack_fused_out).
        (pa.nf_state, pa.tr_state, oa.state, res["pending"],
         res["p_tail"], res["o_tail"], out) = fused_slot_step(
            pa.nf_state, pa.tr_state, oa.state, res["pending"],
            res["p_tail"], res["o_tail"], upload(host_vec, self.torch_device),
            self.sample_rate, slot_len, pa.window, pa.hop, oa.window,
            oa.hop, pa.backend, oa.backend)
        res["queue"].append(("one", Readback(out), meta, spec))

    def _dispatch_aggregate(self, pc: "_PitchConsumer",
                            oc: "_OnsetConsumer") -> None:
        """Dispatch the accumulated aggregate as one chained program
        (models/analyzer.fused_slot_agg_step) and queue its deferred
        readback.  A PARTIAL aggregate (flush mid-chain, knob change)
        decomposes into per-slot dispatches, as the JAX package does (its
        chain lengths are separate compiled programs); per-slot dispatch is
        the reference semantics, so the decomposition is exact."""
        res = self._resident
        acc = res.pop("agg", None)
        if not acc or not acc["entries"]:
            return
        pa, oa = pc.analyzer, oc.analyzer
        entries = acc["entries"]
        if len(entries) < max(int(self.aggregate_slots), 1):
            for host_vec, meta in entries:
                self._dispatch_slot(pc, oc, host_vec, meta, acc["slot_len"])
            return
        host_vec = np.concatenate([e[0] for e in entries])
        (pa.nf_state, pa.tr_state, oa.state, res["pending"], res["p_tail"],
         res["o_tail"], outs) = fused_slot_agg_step(
            pa.nf_state, pa.tr_state, oa.state, res["pending"],
            res["p_tail"], res["o_tail"], upload(host_vec, self.torch_device),
            self.sample_rate, acc["slot_len"], len(entries),
            pa.window, pa.hop, oa.window, oa.hop, pa.backend, oa.backend)
        self._agg_dispatches += 1
        res["queue"].append(("agg", Readback(outs), [e[1] for e in entries]))

    def _fused_drain_entry(self, entry, pc: "_PitchConsumer",
                           oc: "_OnsetConsumer") -> None:
        """Post one deferred-readback queue entry (a single slot or a whole
        aggregate): wait for its packed vector (one event), unpack it on
        the host (models/analyzer.unpack_fused_out) and post.

        Speculative calibration entries (spec != None, see _fused_consume)
        get the transition check: the at-most-once calibration transition
        (acceptance or timeout) invalidates the one newer in-flight
        dispatch, which is rolled back BEFORE this entry posts (the
        acceptance's scan-state rewrite must land on post-this-slot state,
        the synchronous order) and rebuilt with post-transition inputs
        afterwards."""
        kind, readback, metas = entry[0], entry[1], entry[2]
        spec = entry[3] if len(entry) > 3 else None
        if spec is not None and spec.get("invalid"):
            # A calibration transition invalidated this speculative
            # dispatch; the slot was rebuilt and redispatched: drop it.
            return
        vec = readback.wait()
        if kind == "one":
            out = unpack_fused_out(vec, metas[0], metas[1])
            if spec is not None and oc._calibration_transition(
                    out.onset, metas[3], metas[5]):
                inflight = next(
                    (e2[3] for e2 in self._resident["queue"]
                     if e2[0] == "one" and len(e2) > 3 and e2[3] is not None
                     and not e2[3].get("invalid")), None)
                if inflight is not None:
                    # Roll the newer dispatch back to its pre-dispatch
                    # carries (the snapshot holds the very tensors).
                    self._rollback_spec(pc, oc, inflight["snap"])
                    inflight["invalid"] = True
                    self._spec_rollbacks += 1
                self._fused_post((out,) + metas, pc, oc)
                if inflight is not None:
                    self._respeculate(pc, oc, inflight)
                return
            self._fused_post((out,) + metas, pc, oc)
            return
        off = 0
        for meta in metas:
            n_p, n_o = meta[0], meta[1]
            ln = fused_out_len(n_p, n_o)
            self._fused_post(
                (unpack_fused_out(vec[off:off + ln], n_p, n_o),) + meta, pc,
                oc)
            off += ln

    def _rollback_spec(self, pc: "_PitchConsumer", oc: "_OnsetConsumer",
                       snap: tuple) -> None:
        """Undo a speculative dispatch's carry write-back: `snap` holds the
        pre-dispatch tensors, which no op has written since.  Shared by the
        solo drain and the pool's per-lane rollback."""
        pc.analyzer.nf_state, pc.analyzer.tr_state = snap[0], snap[1]
        oc.analyzer.state = snap[2]
        res = self._resident
        res["pending"], res["p_tail"], res["o_tail"] = (snap[3], snap[4],
                                                        snap[5])

    def _rebuild_inputs(self, pc: "_PitchConsumer", oc: "_OnsetConsumer",
                        info: dict):
        """Rebuild an invalidated speculative slot's inputs with the
        POST-transition state: the host mirrors are rewound to their
        pre-slot values for the call, so `_fused_inputs` sees what a
        synchronous consume would have (the same virtual instant, with the
        new calibration offset and hold flag).  Returns (host_vec, meta,
        p_len, o_len).  Shared by the solo redispatch and the pool's
        (api/pool.py _redispatch_lane)."""
        pa, oa = pc.analyzer, oc.analyzer
        save = (pa._tail, oa._tail, pa.frames_consumed, oa.frames_consumed)
        (pa._tail, oa._tail, pa.frames_consumed,
         oa.frames_consumed) = info["mirrors"]
        host_vec, n_p, n_o, tick_sup, hold, p_len, o_len = \
            self._fused_inputs(info["slot"], pc, oc)
        meta = (n_p, n_o, pa.frames_consumed, oa.frames_consumed, tick_sup,
                self._stamp_anchor())
        (pa._tail, oa._tail, pa.frames_consumed, oa.frames_consumed) = save
        return host_vec, meta, p_len, o_len

    def _respeculate(self, pc: "_PitchConsumer", oc: "_OnsetConsumer",
                     info: dict) -> None:
        """Rebuild and redispatch an invalidated speculative slot (solo)."""
        host_vec, meta, _, _ = self._rebuild_inputs(pc, oc, info)
        self._dispatch_slot(pc, oc, host_vec, meta, len(info["slot"]))

    def _fused_inputs(self, slot: np.ndarray, pc: "_PitchConsumer",
                      oc: "_OnsetConsumer"):
        """Build the slot's host-produced inputs for `fused_slot_step`
        (shared by the single-engine path and the EnginePool wave):
        (host_vec, n_p, n_o, tick_sup, hold, p_tail_len, o_tail_len)."""
        from ..ops import noisefloor
        pa, oa = pc.analyzer, oc.analyzer
        p_len, o_len = len(pa._tail), len(oa._tail)
        n_p = num_frames(p_len + len(slot), pa.window, pa.hop)
        n_o = num_frames(o_len + len(slot), oa.window, oa.hop)
        hold = not oc.calibration_done
        tick_sup = oc._tick_suppression(n_o)
        gf_db = self.dynamics_out["noise_floor_db"]
        gfp = float(noisefloor.global_floor_linear(gf_db, pa.window // 2 + 1))
        gfo = float(noisefloor.global_floor_linear(gf_db, oa.window // 2 + 1))
        host_vec = np.concatenate([
            slot, np.asarray([gfp, gfo, 1.0 if hold else 0.0], np.float32),
            tick_sup.astype(np.float32)])
        return host_vec, n_p, n_o, tick_sup, hold, p_len, o_len

    def _fused_advance_host(self, slot: np.ndarray, pc: "_PitchConsumer",
                            oc: "_OnsetConsumer", n_p: int, n_o: int) -> None:
        """Advance the host-side frame counters and ring-tail mirrors after
        a fused dispatch.  The mirrors are numpy: tail contents are literal
        slices of the slot stream (no arithmetic touches them), so the
        mirror is bit-identical to the device carry and keeps checkpoints
        and the sequential fallback exact with no readback."""
        pa, oa = pc.analyzer, oc.analyzer
        p_len, o_len = len(pa._tail), len(oa._tail)
        p_buf = np.concatenate([pa._tail, slot]) if p_len else slot
        o_buf = np.concatenate([oa._tail, slot]) if o_len else slot
        pa._tail = p_buf[n_p * pa.hop:]
        oa._tail = o_buf[n_o * oa.hop:]
        pa.frames_consumed += n_p
        oa.frames_consumed += n_o

    def _fused_post(self, entry, pc: "_PitchConsumer",
                    oc: "_OnsetConsumer") -> None:
        """Run the host posts of one read-back fused slot (event stamping,
        calibration handling, tuner feed), identical to the synchronous
        path because stamping uses the consume-time transport anchor
        (transport.anchor)."""
        out, n_p, n_o, p_base, o_base, tick_sup, anchor = entry
        if n_o:
            oc._post(out.onset, tick_sup, o_base, anchor=anchor)
        # The device applied pending | fired to this burst's first frame;
        # clear the flag exactly like the sequential pitch consume does
        # (fires recorded by oc._post above were consumed in-burst, and
        # while fused the pending carry lives on device).
        self.onset_pending = False
        if n_p:
            pc._post(out, p_base, anchor=anchor)

    def _flush_fused(self) -> None:
        """Leave fused mode: drain the deferred-readback queue (a pool's
        too) and restore the host pending flag (one readback) so the
        sequential path and checkpoints see the exact current state.  The
        analyzers' `_tail`s are already exact (host-mirrored every fused
        slot)."""
        if self._pool is not None:
            # Pool-deferred results include this engine's: surface them all.
            self._pool.flush()
        if self._resident is not None and self._resident.get("agg"):
            # Dispatch the partial aggregate so its slots surface too.
            r = self._resident
            self._dispatch_aggregate(r["pc"], r["oc"])
        res = self._resident
        if res is None:
            return
        pc, oc = res["pc"], res["oc"]
        # Drain by popping with the residency still installed: a
        # calibration transition during the drain rolls back and
        # redispatches the one in-flight speculative slot, which appends
        # to this very queue (see _fused_drain_entry).
        while res["queue"]:
            self._fused_drain_entry(res["queue"].pop(0), pc, oc)
        self._resident = None
        if bool(res["pending"].any()):
            self.onset_pending = True

    def flush_analysis(self) -> None:
        """Surface any deferred fused-streaming results now (a no-op when
        the fused path is idle).  Poll surfaces reflect every slot consumed
        so far after this returns."""
        self._flush_fused()

    def prepare(self, include_sequential: bool = False) -> dict:
        """Warm the live session's slot programs on this engine's device
        before the first real slot: the kernels' build (nvcc, at first
        use), the cuFFT plans, and one launch of every kernel at each
        ring-tail geometry this buffer size gives.

        One fused slot variant exists per distinct (pitch_tail_len,
        onset_tail_len) ring-buffer state, and for a fixed buffer size the
        ramp-up sequence reaches its fixed point within a few slots.  A
        scratch engine with this engine's configuration (sample rate,
        buffer size, device, fused_streaming, aggregate_slots,
        pipeline_depth) streams silence through the REAL per-slot path in
        two phases: first uncalibrated (calibration holds, so every slot
        dispatches per slot and walks the ramp until a variant repeats),
        then with calibration marked done (so the steady aggregate,
        `fused_slot_agg_step`, runs twice when aggregate_slots > 1).
        `include_sequential=True` also warms the per-consumer fallback by
        streaming the same ramp through throwaway analyzers.

        Returns {"variants": [(p_tail, o_tail), ...], "seconds": {...},
        "total_s": s} with the JAX package's keys: "fused_<p>_<o>" for
        each variant's first slot, "agg<A>_<p>_<o>" for the first
        aggregate dispatch, "sequential_slot<i>"; each a wall time, build
        and plans included (on CUDA the slot's stream is waited on)."""
        import time as _time

        from .device import ArraySource

        seen: list = []
        seconds: dict = {}
        t_all = _time.perf_counter()
        agg = max(int(self.aggregate_slots), 1)
        # The ramp is walked until its (pitch_tail, onset_tail) variant
        # repeats (a small buffer takes many slots just to fill the
        # 2048-sample pitch window), then two full aggregates.
        ramp_cap = max(16, 2 * (PITCH_WINDOW // self.buffer_size) + 8)
        n_agg = 2 * agg if agg > 1 else 0
        scratch = AudioEngine(
            input_source=ArraySource(
                np.zeros((ramp_cap + n_agg + 1) * self.buffer_size,
                         np.float32)),
            sample_rate=self.sample_rate, buffer_size=self.buffer_size,
            device=self.torch_device)
        scratch.fused_streaming = self.fused_streaming
        scratch.aggregate_slots = self.aggregate_slots
        scratch.pipeline_depth = self.pipeline_depth
        scratch.start_tuner()
        scratch.start_onset_detection()
        pc = next(c for c in scratch._consumers.values()
                  if isinstance(c, _PitchConsumer))
        oc = next(c for c in scratch._consumers.values()
                  if isinstance(c, _OnsetConsumer))
        slot_s = self.buffer_size / self.sample_rate

        def timed_slot() -> float:
            t0 = _time.perf_counter()
            scratch.advance(slot_s)
            if self.torch_device.type == "cuda":
                torch.cuda.current_stream(self.torch_device).synchronize()
            return _time.perf_counter() - t0

        # Phase 1: calibration holds (the consumer attaches uncalibrated,
        # like a live session's first ~2 s).
        for _ in range(ramp_cap):
            variant = (len(pc.analyzer._tail), len(oc.analyzer._tail))
            if variant in seen:
                break   # the ramp cycled: every variant has run
            seconds[f"fused_{variant[0]}_{variant[1]}"] = timed_slot()
            seen.append(variant)
        # Phase 2: calibration done (a live session reaches this by
        # loopback acceptance or the 2 s timeout): aggregation engages.
        oc.calibration_done = True
        scratch.transport.set_calibration_offset(0)
        for _ in range(n_agg):
            variant = (len(pc.analyzer._tail), len(oc.analyzer._tail))
            before = scratch._agg_dispatches
            dt = timed_slot()
            if scratch._agg_dispatches > before:
                seconds.setdefault(f"agg{agg}_{variant[0]}_{variant[1]}", dt)
        if agg > 1 and scratch._agg_dispatches < 2:
            raise RuntimeError(
                f"prepare(): expected >= 2 aggregate dispatches in phase 2, "
                f"saw {scratch._agg_dispatches}")
        scratch.flush_analysis()
        if include_sequential:
            slot = np.zeros(self.buffer_size, np.float32)
            pa2 = PitchAnalyzer(self.sample_rate, device=self.torch_device)
            oa2 = OnsetAnalyzer(self.sample_rate, device=self.torch_device)
            for i in range(len(seen) + 1):
                t0 = _time.perf_counter()
                pa2.process(slot, global_floor_db=-96.0)
                oa2.process(slot, global_floor_db=-96.0,
                            tick_suppressed=np.zeros(
                                num_frames(len(oa2._tail) + len(slot),
                                           oa2.window, oa2.hop), bool),
                            calibration_hold=False)
                seconds[f"sequential_slot{i}"] = _time.perf_counter() - t0
        return {"variants": seen, "seconds": seconds,
                "total_s": _time.perf_counter() - t_all}

    # ── spawns (ref lib.rs:448-624, mod.rs:944-1129) ─────────────────────

    def _take_handle(self, component: str) -> int:
        if not self._available_handles:
            raise SpawnFailed(component,
                              "All 255 audio consumer slots are already in use")
        return self._available_handles.pop()

    def create_metronome(self, bpm: float, pattern: List[int],
                         polys: List[List[int]], volume: float,
                         restart: bool) -> Metronome:
        if self.active_metronome is not None:
            raise SpawnFailed("metronome", "Already active")
        self.start_output()
        source = MetronomeSource(self.sample_rate, self.transport, bpm=bpm,
                                 pattern=_pattern_from_ints(pattern),
                                 polys=[list(p) for p in polys],
                                 volume=volume, restart=restart)
        self.mixer.add_source(source)
        self.active_metronome = Metronome(source)
        return self.active_metronome

    def create_synth(self) -> Synth:
        if self.active_synth is not None:
            raise SpawnFailed("synth", "Already active")
        self.start_output()
        source = Synthesizer(self.sample_rate, self.transport)
        if self.active_metronome is not None:
            source.send("LinkMetronome", self.active_metronome._source)
        self.mixer.add_source(source)
        self.active_synth = Synth(source)
        return self.active_synth

    def create_player(self) -> Player:
        if self.active_player is not None:
            raise SpawnFailed("player", "Already active")
        self.start_output()
        source = AudioPlayer(self.sample_rate)
        self.mixer.add_source(source)
        self.active_player = Player(PlayerController(source))
        return self.active_player

    def start_recording(self, path: str) -> Recording:
        if self.active_recording is not None:
            raise SpawnFailed("recorder", "Already active")
        self.start_input()
        handle = self._take_handle("recorder")
        rec = Recording(path, int(self.sample_rate))
        rec._handle = handle
        self._consumers[handle] = rec
        self.active_recording = rec
        return rec

    def start_tuner(self) -> Tuner:
        if self.active_tuner is not None:
            raise SpawnFailed("tuner", "Already active")
        self.start_input()
        handle = self._take_handle("tuner")
        consumer = _PitchConsumer(self)
        self._consumers[handle] = consumer
        tuner = Tuner(consumer.tuner_core)
        tuner._handle = handle
        self.active_tuner = tuner
        return tuner

    def attach_debug_recorder(self, recorder) -> None:
        """Attach a devtools recorder (DebugRecorder / JsonlStreamRecorder)
        to the live analysis: per-frame spectrum/floor/pitch records from
        the active tuner (ref stft.rs:674-747) and per-frame onset decision
        telemetry (ref onset.rs:458-533).  A JsonlStreamRecorder makes the
        stream tail-able while the engine runs.  While one is attached the
        engine runs the sequential consumers, the pitch flow at full width
        (K1 and K5 over all window//2+1 bins)."""
        self._flush_fused()
        self.debug_recorder = recorder
        for consumer in self._consumers.values():
            if isinstance(consumer, _PitchConsumer):
                consumer.analyzer.debug_recorder = recorder

    def start_onset_detection(self) -> OnsetDetection:
        if self.active_onset is not None:
            raise SpawnFailed("onset detector", "Already active")
        self.start_input()
        self.start_output()
        handle = self._take_handle("onset detector")
        detection = OnsetDetection(self)
        consumer = _OnsetConsumer(self, detection)
        self._consumers[handle] = consumer
        detection._handle = handle
        # Round-trip latency self-calibration (ref mod.rs:1055-1087).
        needs_calibration = (not self.transport.is_calibrated()
                             or self.transport.get_calibration_offset() == 0)
        if needs_calibration:
            delay = int(self.sample_rate) // 5   # ~200 ms ahead
            click = CalibrationClick(self.transport, self.sample_rate, delay,
                                     volume=0.8)
            self._calibration_click = click
            click_engine = self

            class _TargetPublishingClick:
                def process(self, buf, ch):
                    click.process(buf, ch)
                    if click.fired:
                        click_engine.calibration_target = click.actual_frame

                def is_finished(self):
                    return click.is_finished()

            self.mixer.add_source(_TargetPublishingClick())
        self.active_onset = detection
        return detection

    # ── stops (ref lib.rs:626-788) ───────────────────────────────────────

    def _release(self, obj) -> None:
        handle = getattr(obj, "_handle", None)
        if handle is not None and handle in self._consumers:
            del self._consumers[handle]
            self._available_handles.append(handle)

    def stop_metronome(self) -> None:
        if self.active_metronome is not None:
            self.active_metronome._source.send("Stop")
            self.active_metronome = None
        self.clean_output()

    def stop_synth(self) -> None:
        if self.active_synth is not None:
            self.active_synth._source.send("Stop")
            self.active_synth._source.send("End")
            self.active_synth = None
        self.clean_output()

    def stop_player(self) -> None:
        if self.active_player is not None:
            self.active_player._controller.stop()
            self.active_player._controller._player.finished = True
            self.active_player = None
        self.clean_output()

    def stop_recording(self) -> None:
        if self.active_recording is not None:
            self.active_recording.stop()
            self._release(self.active_recording)
            self.active_recording = None
        self.clean_input()

    def stop_onset_detection(self) -> None:
        self._flush_fused()
        if self.active_onset is not None:
            self.active_onset.stop()
            self._release(self.active_onset)
            self.active_onset = None
        self.clean_input()

    def stop_tuner(self) -> None:
        self._flush_fused()
        if self.active_tuner is not None:
            self.active_tuner.send("End")
            self._release(self.active_tuner)
            self.active_tuner = None
        self.clean_input()

    # ── practice session (ref lib.rs:684-777) ────────────────────────────

    def create_practice_session(self, midi_path: str, instrument: str,
                                countoff_beats: int, mode: str,
                                ability_level: str, bpm: float
                                ) -> PracticeSession:
        if self.active_practice_session is not None:
            raise SpawnFailed("practice session", "Already active")
        level_map = {"beginner": "Beginner", "intermediate": "Intermediate",
                     "advanced": "Advanced", "pro": "Pro"}
        level = level_map.get(ability_level.lower())
        if level is None:
            raise InternalError(
                f"Unknown ability level '{ability_level.lower()}'. Expected "
                f"one of: Beginner, Intermediate, Advanced, Pro")
        practice_mode = practice_mode_from_str(mode)
        if practice_mode is None:
            raise InternalError(
                f"Unknown practice mode '{mode}'. Expected one of: "
                f"FollowAlong, Performance, Rubato")
        tuner = self.start_tuner()
        try:
            onset = self.start_onset_detection()
        except Exception:
            # The tuner just started above would otherwise leak (no handle
            # returned), blocking every retry with "Already active".
            self.stop_tuner()
            raise
        try:
            instrument_from(instrument)
            core = PracticeCore(
                transport=self.transport,
                tuner=tuner.output_handle(),
                onset=onset,
                dynamics_output=lambda: self.dynamics_out["level"],
                midi_path=midi_path, instrument=instrument,
                countoff_beats=countoff_beats, mode=practice_mode,
                ability_level=level, bpm=bpm)
        except (OSError, ValueError) as e:
            self.stop_tuner()
            self.stop_onset_detection()
            raise FileError(str(e))
        session = PracticeSession(core)
        self.active_practice_session = session
        return session

    def stop_practice_session(self) -> None:
        if self.active_practice_session is not None:
            self.active_practice_session.stop()
            self.active_practice_session = None
        self.stop_tuner()
        self.stop_onset_detection()

    # ── polling surfaces (ref lib.rs:790-816) ────────────────────────────

    def poll_dynamics(self) -> str:
        d = self.dynamics_out
        level = LEVEL_NAMES[int(d["level"]) + 1]
        return (f'{{"level":"{level}","rms_db":{d["rms_db"]:.1f},'
                f'"gain_db":{d["gain_db"]:.1f},'
                f'"session_median_db":{d["session_median_db"]:.1f},'
                f'"noise_floor_db":{d["noise_floor_db"]:.1f}}}')

    def poll_transport(self) -> str:
        return json.dumps(self.transport.snapshot().to_dict())
