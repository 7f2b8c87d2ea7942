"""CLI simulation harness — the reference's debug REPL, offline-batch.

The reference gates an interactive tester behind debug builds
(ref src/main.rs:1-53, src/testing.rs:321-824): met / tuner / synth / player
/ rec / onset / practice commands, with a practice runner mimicking the
React-Native 60 Hz poll loop (count-off, measure and beat logging, metric
pretty-print).  This CLI drives the same flows hardware-free through the
virtual device — deterministically, from files.

Usage:
  python -m audio_analyzer_rs_tpu_torch.cli tuner <audio> [--debug-jsonl PATH]
  python -m audio_analyzer_rs_tpu_torch.cli onset <audio> [--debug-jsonl PATH]
      # --debug-jsonl streams per-frame telemetry live (tail -f PATH)
  python -m audio_analyzer_rs_tpu_torch.cli debug-view <debug.jsonl> [--once 1]
      # live terminal viewer for a --debug-jsonl stream (tail -f with
      # rendering: pitch labels, floor, onset decisions; Ctrl-C to stop)
  python -m audio_analyzer_rs_tpu_torch.cli analyze <audio> [out.jsonl]
      [--segments N|auto]  # bulk offline analysis -> JSONL per-frame features
  python -m audio_analyzer_rs_tpu_torch.cli rec <in.wav> <out.wav>
  python -m audio_analyzer_rs_tpu_torch.cli met <bpm> <seconds> <out.wav>
  python -m audio_analyzer_rs_tpu_torch.cli play <in-audio> <out.wav> [--seek S]
  python -m audio_analyzer_rs_tpu_torch.cli synth <midi> <out.wav> [instrument]
  python -m audio_analyzer_rs_tpu_torch.cli practice <midi> [wav]
      [--mode FollowAlong|Performance|Rubato]
      [--ability Beginner|Intermediate|Advanced|Pro] [--countoff N]
  python -m audio_analyzer_rs_tpu_torch.cli repl

Every command takes --device cuda|cpu (default cuda): the torch device
the engine and the analyzers run on.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .api.device import ArraySource
from .api.engine import AudioEngine
from .models import generators as gen
from .utils import wav
from .utils.midi import load_midi_file


def _load_mono(path: str):
    try:
        data, sr, ch = wav.read_wav_float(path)
    except (ValueError, OSError):
        from . import runtime
        return runtime.decode_file(path)  # mp3/flac/ogg/... already mono
    return wav.downmix_mono(data, ch), float(sr)


def _attach_debug(e, debug_jsonl):
    """--debug-jsonl PATH: stream per-frame debug telemetry live (tail -f
    the file while analyzing — the reference's Rerun viewer analog,
    ref stft.rs:674-747, onset.rs:559-651)."""
    if debug_jsonl:
        from .devtools import JsonlStreamRecorder
        e.attach_debug_recorder(JsonlStreamRecorder(debug_jsonl))
        print(f"streaming debug telemetry to {debug_jsonl} (tail -f it)",
              file=sys.stderr)


def cmd_tuner(path: str, debug_jsonl: str | None = None,
              device: str = "cuda") -> None:
    audio, sr = _load_mono(path)
    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,
                    device=device)
    _attach_debug(e, debug_jsonl)
    tuner = e.start_tuner()
    # Round the step to whole device buffers so no audio tail is dropped.
    step_s = max(round(0.25 * sr / e.buffer_size), 1) * e.buffer_size / sr
    total = len(audio) / sr + step_s
    print(f"analyzing {len(audio) / sr:.2f}s of {path} at {sr:.0f} Hz")
    t = 0.0
    last = ""
    while t < total:
        e.advance(step_s)
        t += step_s
        out = json.loads(tuner.poll_output())
        line = f"{out['label']} {out['cents']:+.1f}c {out['notes']}"
        if out["label"] and line != last:
            print(f"  t={t:5.2f}s  {line}")
            last = line
    print("dynamics:", e.poll_dynamics())


def cmd_onset(path: str, debug_jsonl: str | None = None,
              device: str = "cuda") -> None:
    audio, sr = _load_mono(path)
    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,
                    device=device)
    e.transport.set_calibration_offset(1)   # offline: skip self-calibration
    _attach_debug(e, debug_jsonl)
    onset = e.start_onset_detection()
    e.advance(len(audio) / sr + 0.1)
    events = json.loads(onset.poll_onsets())
    print(f"{len(events)} onsets detected:")
    bps = e.transport.get_bpm() / 60.0
    for ev in events:
        print(f"  beat {ev['beat_position']:8.3f} "
              f"(~{ev['beat_position'] / bps:6.3f}s) "
              f"velocity {ev['velocity']:.2f}")


def cmd_analyze(path: str, out_path: str | None = None,
                segments: int | None = 1, device: str = "cuda") -> None:
    """Bulk offline analysis → JSONL (one line per frame + one onset list).

    --segments N (or `auto`) uses the segment-parallel pipelines for the
    stable pitches and onsets (the TPU bulk path; ~>99% frame agreement
    with sequential; `auto` scales the count to the recording length).
    """
    from . import analysis

    audio, sr = _load_mono(path)
    if segments is None or segments > 1:
        # Segment-parallel bulk path: never runs the sequential scans.
        arr = analysis.analyze_buffer_segmented(audio, sr, segments=segments,
                                                device=device)
    else:
        arr = analysis.analyze_buffer(audio, sr, as_arrays=True,
                                      device=device)
    sink = open(out_path, "w") if out_path else sys.stdout
    try:
        sink.write(json.dumps({"sample_rate": sr, "frames": len(arr.rms),
                               "onsets": arr.onsets}) + "\n")
        for i in range(len(arr.rms)):
            stable = [[float(f), float(s)] for f, s, v in
                      zip(arr.stable_freqs[i], arr.stable_scores[i],
                          arr.stable_valid[i]) if v]
            sink.write(json.dumps({
                "t": round(float(arr.time_s[i]), 4),
                "rms": float(arr.rms[i]),
                "centroid_hz": round(float(arr.centroid_hz[i]), 1),
                "rolloff_hz": round(float(arr.rolloff_hz[i]), 1),
                "flux": float(arr.flux[i]),
                "yin_f0_hz": round(float(arr.yin_f0_hz[i]), 2),
                "yin_voiced": bool(arr.yin_voiced[i]),
                "stable_pitches": stable}) + "\n")
    finally:
        if out_path:
            sink.close()
            print(f"wrote {len(arr.rms)} frames to {out_path}",
                  file=sys.stderr)


def cmd_debug_view(path: str, follow: bool = True,
                   out=None, poll_s: float = 0.2, stop=None) -> None:
    """Live terminal viewer for the JSONL debug stream (the reference's
    Rerun GUI analog, ref stft.rs:674-747, onset.rs:559-651).

    Tails `path` (as written by `--debug-jsonl` / JsonlStreamRecorder),
    scrolls an event line per fired onset / pitch-set change, and keeps a
    live status line (latest pitch labels, floor, onset decision, counts).
    `follow=False` renders the existing file once and exits (scriptable).
    Run e.g.:  cli.py tuner take.wav --debug-jsonl d.jsonl   (one shell)
               cli.py debug-view d.jsonl                     (another)
    """
    import time

    from .devtools import DebugStreamView

    out = out or sys.stdout
    is_tty = getattr(out, "isatty", lambda: False)()
    view = DebugStreamView()

    def emit_status():
        if is_tty:
            out.write("\r\x1b[2K" + view.status_line())
            out.flush()

    try:
        with open(path) as f:
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    if not follow or (stop is not None and stop()):
                        break
                    emit_status()
                    time.sleep(poll_s)
                    continue
                if follow and not line.endswith("\n"):
                    # Partial line mid-write: rewind and wait for the rest.
                    f.seek(pos)
                    time.sleep(poll_s)
                    continue
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue   # malformed line; skip
                event = view.feed(rec)
                if event:
                    if is_tty:
                        out.write("\r\x1b[2K")
                    out.write(event + "\n")
                emit_status()
    except KeyboardInterrupt:
        pass
    if is_tty:
        out.write("\n")
    out.write(f"stream ended: {view.n_pitch} pitch frames, "
              f"{view.n_onset} onset frames, {view.n_fired} onsets fired\n")
    out.flush()


def cmd_rec(in_path: str, out_path: str, device: str = "cuda") -> None:
    """Record the (virtual) microphone through the conditioning chain."""
    audio, sr = _load_mono(in_path)
    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,
                    device=device)
    e.start_recording(out_path)
    e.advance(len(audio) / sr + 0.1)
    e.stop_recording()
    print(f"recorded {len(audio) / sr:.2f}s (conditioned) to {out_path}")


def cmd_met(bpm: float, seconds: float, out_path: str,
            device: str = "cuda") -> None:
    e = AudioEngine(device=device)
    e.create_metronome(bpm, [3, 1, 1, 1], [], 1.0, False)
    chunks = []
    orig = e._output_callback

    def capture(buf):
        orig(buf)
        chunks.append(buf.copy())
    e.device.output_callback = capture
    e.advance(seconds)
    audio = np.concatenate(chunks)
    wav.write_wav(out_path, audio, int(e.sample_rate))
    print(f"wrote {seconds}s of {bpm} BPM metronome to {out_path}")


def cmd_synth(midi_path: str, out_path: str, instrument: str = "Piano",
              device: str = "cuda") -> None:
    measures = load_midi_file(midi_path, instrument)
    total_beats = (measures[-1].global_start_beat
                   + measures[-1].duration_beats())
    e = AudioEngine(device=device)
    synth = e.create_synth()
    synth._source.send("LoadMeasures", measures)
    synth.play(0)
    chunks = []
    orig = e._output_callback

    def capture(buf):
        orig(buf)
        chunks.append(buf.copy())
    e.device.output_callback = capture
    bpm = measures[0].bpm
    count_in = measures[0].duration_beats()
    seconds = (total_beats + count_in) * 60.0 / bpm + 1.0
    e.advance(seconds)
    audio = np.concatenate(chunks)
    wav.write_wav(out_path, audio, int(e.sample_rate))
    print(f"rendered {len(measures)} measures ({seconds:.1f}s incl. count-in) "
          f"to {out_path}")


def cmd_play(in_path: str, out_path: str, seek: float = 0.0,
             device: str = "cuda") -> None:
    """Drive the AudioPlayer (decode → resample → mixer) offline and write
    the rendered output — the batch analog of the reference CLI's player
    command (ref testing.rs player; decode covers mp3/flac/ogg/... via the
    native FFmpeg module when available)."""
    e = AudioEngine(device=device)
    player = e.create_player()
    player.load_track(in_path)
    if seek:
        player.seek(seek)
    player.play()
    chunks = []
    total = 0
    orig = e._output_callback

    def capture(buf):
        nonlocal total
        orig(buf)
        chunks.append(buf.copy())
        total += len(buf)
    e.device.output_callback = capture
    e.advance(0.25)   # processes the Play command before polling state
    # is_playing() drops when the cursor passes the decoded track end.
    while (e.active_player is not None
           and player.is_playing()
           and total <= int(e.sample_rate) * 3600):
        e.advance(0.25)
    e.stop_player()
    audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    wav.write_wav(out_path, audio, int(e.sample_rate))
    print(f"played {in_path} -> {out_path} "
          f"({len(audio) / e.sample_rate:.2f}s at {int(e.sample_rate)} Hz)")


def render_performance(midi_path: str, instrument: str, sr: float,
                       bpm_override: float | None = None) -> np.ndarray:
    """Render an 'ideal student' performance as harmonic tones."""
    measures = load_midi_file(midi_path, instrument, bpm_override)
    bpm = measures[0].bpm
    spb = 60.0 / bpm
    total_beats = measures[-1].global_start_beat + measures[-1].duration_beats()
    out = np.zeros(int((total_beats * spb + 1.0) * sr), dtype=np.float32)
    for m in measures:
        for n in m.notes:
            start_beat = m.global_start_beat + n.start_beat_in_measure
            tone = gen.tone_with_harmonics(
                n.freq, max(n.duration_beats * spb * 0.9, 0.1), sr,
                harmonics=6, amplitude=0.35 * max(n.velocity, 0.2))
            s = int(start_beat * spb * sr)
            out[s:s + len(tone)] += tone[:max(len(out) - s, 0)]
    return out


def cmd_practice(midi_path: str, wav_path: str | None = None,
                 mode: str = "Performance", ability: str = "Intermediate",
                 countoff: int = 0, instrument: str = "Piano",
                 bpm: float = 120.0, device: str = "cuda") -> None:
    sr = 48000.0
    if wav_path:
        audio, sr = _load_mono(wav_path)
        print(f"performance: {wav_path}")
    else:
        audio = render_performance(midi_path, instrument, sr, bpm)
        print("performance: auto-rendered ideal student")

    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,
                    device=device)
    e.transport.set_calibration_offset(1)
    e.transport.set_input_latency(0)
    e.transport.set_output_latency(0)
    session = e.create_practice_session(midi_path, instrument, countoff,
                                        mode, ability, bpm)
    measures = load_midi_file(midi_path, instrument, bpm)
    session.start(0, len(measures) - 1)
    print(f"practice: {len(measures)} measures, mode={mode}, "
          f"ability={ability}, countoff={countoff}")

    # Mimic the RN poll loop: advance in ~16 ms steps, log measure/beat
    # transitions and live feedback (ref testing.rs:396-520).
    last_measure, last_beat = -1, -1
    step = max(int(0.016 * sr) // e.buffer_size, 1) * e.buffer_size / sr
    for _ in range(int(120.0 / step)):
        e.advance(step)
        snap = json.loads(session.poll_transport())
        if snap["in_countoff"] and last_beat != int(snap["beat_position"]):
            last_beat = int(snap["beat_position"])
            print(f"  count-off beat {last_beat}")
        if snap["current_measure_idx"] != last_measure:
            last_measure = snap["current_measure_idx"]
            print(f"  ▸ measure {last_measure}")
        for err in json.loads(session.poll_errors()):
            tag = err["error_type"]
            if tag == "None":
                print(f"    ✓ m{err['measure']}#{err['note_index']} "
                      f"{err['received']}")
            else:
                print(f"    ✗ {tag}: expected {err['expected']} — "
                      f"{err['received']}")
        if not session.is_running():
            break
    print("\n── metrics " + "─" * 40)
    metrics = json.loads(session.get_metrics())
    if not metrics:
        print("  (no completed measures)")
        return
    print(f"  accuracy        {metrics['accuracy_percent']:.1f}%  "
          f"({metrics['num_notes_missed']} missed)")
    print(f"  avg cents dev   {metrics['avg_cent_dev']:.1f}")
    print(f"  onset accuracy  {metrics['note_onset_accuracy']:.3f} beats "
          f"(skew {metrics['microtiming_skew']:+.3f})")
    print(f"  timing σ        {metrics['timing_consistency']:.3f}")
    print(f"  tempo stability {metrics['tempo_stability']:.2f}  "
          f"map {['%.0f' % t for t in metrics['measure_tempo_map']]}")
    print(f"  dynamics        acc {metrics['dynamics_accuracy']:.0f}%, "
          f"range {metrics['dynamics_range_used']}")
    print(f"  error measures  {metrics['error_measures']}")


def repl() -> None:
    print("audio_analyzer_rs_tpu_torch CLI — commands: tuner <wav> | "
          "onset <wav> | "
          "met <bpm> <s> <out> | play <in> <out> | synth <midi> <out> | "
          "rec <in> <out> | analyze <wav> [out] | practice <midi> [wav] | "
          "debug-view <jsonl> | quit")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line or line in ("quit", "exit", "q"):
            break
        try:
            main(line.split())
        except Exception as exc:  # REPL resilience, like the reference CLI
            print(f"error: {exc}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] == "repl":
        repl()
        return
    cmd, args = argv[0], argv[1:]
    kwargs = {}
    pos = []
    i = 0
    while i < len(args):
        if args[i].startswith("--"):
            kwargs[args[i][2:]] = args[i + 1]
            i += 2
        else:
            pos.append(args[i])
            i += 1
    try:
        _dispatch(cmd, pos, kwargs)
    except IndexError:
        print(f"error: missing argument(s) for '{cmd}' — see usage:\n")
        print(__doc__)
        sys.exit(2)


def _dispatch(cmd, pos, kwargs) -> None:
    device = kwargs.get("device", "cuda")
    if cmd == "tuner":
        cmd_tuner(pos[0], debug_jsonl=kwargs.get("debug-jsonl"),
                  device=device)
    elif cmd == "onset":
        cmd_onset(pos[0], debug_jsonl=kwargs.get("debug-jsonl"),
                  device=device)
    elif cmd == "debug-view":
        cmd_debug_view(pos[0], follow=not kwargs.get("once"))
    elif cmd == "analyze":
        seg = kwargs.get("segments", "1")
        cmd_analyze(pos[0], pos[1] if len(pos) > 1 else None,
                    segments=None if seg == "auto" else int(seg),
                    device=device)
    elif cmd == "rec":
        cmd_rec(pos[0], pos[1], device=device)
    elif cmd == "met":
        cmd_met(float(pos[0]), float(pos[1]), pos[2], device=device)
    elif cmd == "play":
        cmd_play(pos[0], pos[1], seek=float(kwargs.get("seek", 0.0)),
                 device=device)
    elif cmd == "synth":
        cmd_synth(pos[0], pos[1], *(pos[2:3]), device=device)
    elif cmd == "practice":
        cmd_practice(pos[0], pos[1] if len(pos) > 1 else None,
                     mode=kwargs.get("mode", "Performance"),
                     ability=kwargs.get("ability", "Intermediate"),
                     countoff=int(kwargs.get("countoff", 0)),
                     instrument=kwargs.get("instrument", "Piano"),
                     bpm=float(kwargs.get("bpm", 120.0)), device=device)
    else:
        print(__doc__)
        sys.exit(2)


if __name__ == "__main__":
    main()
