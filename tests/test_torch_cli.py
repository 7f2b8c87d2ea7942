"""The port's CLI (`python -m audio_analyzer_rs_tpu_torch.cli`) on the CPU.

`cli.py` is the JAX package's CLI with the rewrites listed in
`CLI_REWRITES` (the module name, and `--device cuda|cpu` passed to every
`AudioEngine` and analysis call); `test_cli_is_the_jax_cli_rewritten`
holds it to the JAX text, so a drift in either shows.  Then the JAX
package's tests/test_cli.py cases with `--device cpu`, `tuner
--debug-jsonl`, and the analyze JSONL against the JAX CLI's on the same
WAV: the same frames and onset frames, valid stable pitches at rtol 1e-5
(tests/test_torch_segmented.py's tolerance), onset velocities and the
per-frame features at rtol 1e-5 (printed values; flux at 1e-5 of its
max).
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu import cli as jcli
from audio_analyzer_rs_tpu_torch import cli
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.utils import wav
from audio_analyzer_rs_tpu_torch.utils.midi import write_midi_file

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
RTOL = 1e-5

# (text in the JAX package's cli.py, its replacement in the port's): each
# old text occurs exactly once.
CLI_REWRITES = [
    ("python -m audio_analyzer_rs_tpu.cli tuner",
     "python -m audio_analyzer_rs_tpu_torch.cli tuner"),
    ("python -m audio_analyzer_rs_tpu.cli onset",
     "python -m audio_analyzer_rs_tpu_torch.cli onset"),
    ("python -m audio_analyzer_rs_tpu.cli debug-view",
     "python -m audio_analyzer_rs_tpu_torch.cli debug-view"),
    ("python -m audio_analyzer_rs_tpu.cli analyze",
     "python -m audio_analyzer_rs_tpu_torch.cli analyze"),
    ("python -m audio_analyzer_rs_tpu.cli rec",
     "python -m audio_analyzer_rs_tpu_torch.cli rec"),
    ("python -m audio_analyzer_rs_tpu.cli met",
     "python -m audio_analyzer_rs_tpu_torch.cli met"),
    ("python -m audio_analyzer_rs_tpu.cli play",
     "python -m audio_analyzer_rs_tpu_torch.cli play"),
    ("python -m audio_analyzer_rs_tpu.cli synth",
     "python -m audio_analyzer_rs_tpu_torch.cli synth"),
    ("python -m audio_analyzer_rs_tpu.cli practice",
     "python -m audio_analyzer_rs_tpu_torch.cli practice"),
    ("  python -m audio_analyzer_rs_tpu.cli repl\n",
     "  python -m audio_analyzer_rs_tpu_torch.cli repl\n"
     "\n"
     "Every command takes --device cuda|cpu (default cuda): the torch device\n"
     "the engine and the analyzers run on.\n"),
    ("def cmd_tuner(path: str, debug_jsonl: str | None = None) -> None:\n"
     "    audio, sr = _load_mono(path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr)\n",
     "def cmd_tuner(path: str, debug_jsonl: str | None = None,\n"
     "              device: str = \"cuda\") -> None:\n"
     "    audio, sr = _load_mono(path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,\n"
     "                    device=device)\n"),
    ("def cmd_onset(path: str, debug_jsonl: str | None = None) -> None:\n"
     "    audio, sr = _load_mono(path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr)\n",
     "def cmd_onset(path: str, debug_jsonl: str | None = None,\n"
     "              device: str = \"cuda\") -> None:\n"
     "    audio, sr = _load_mono(path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,\n"
     "                    device=device)\n"),
    ("                segments: int | None = 1) -> None:\n",
     "                segments: int | None = 1, device: str = \"cuda\") -> None:\n"),
    ("        arr = analysis.analyze_buffer_segmented(audio, sr, segments=segments)\n"
     "    else:\n"
     "        arr = analysis.analyze_buffer(audio, sr, as_arrays=True)\n",
     "        arr = analysis.analyze_buffer_segmented(audio, sr, segments=segments,\n"
     "                                                device=device)\n"
     "    else:\n"
     "        arr = analysis.analyze_buffer(audio, sr, as_arrays=True,\n"
     "                                      device=device)\n"),
    ("def cmd_rec(in_path: str, out_path: str) -> None:\n"
     "    \"\"\"Record the (virtual) microphone through the conditioning chain.\"\"\"\n"
     "    audio, sr = _load_mono(in_path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr)\n",
     "def cmd_rec(in_path: str, out_path: str, device: str = \"cuda\") -> None:\n"
     "    \"\"\"Record the (virtual) microphone through the conditioning chain.\"\"\"\n"
     "    audio, sr = _load_mono(in_path)\n"
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,\n"
     "                    device=device)\n"),
    ("def cmd_met(bpm: float, seconds: float, out_path: str) -> None:\n"
     "    e = AudioEngine()\n",
     "def cmd_met(bpm: float, seconds: float, out_path: str,\n"
     "            device: str = \"cuda\") -> None:\n"
     "    e = AudioEngine(device=device)\n"),
    ("def cmd_synth(midi_path: str, out_path: str, instrument: str = \"Piano\") -> None:\n",
     "def cmd_synth(midi_path: str, out_path: str, instrument: str = \"Piano\",\n"
     "              device: str = \"cuda\") -> None:\n"),
    ("    e = AudioEngine()\n"
     "    synth = e.create_synth()\n",
     "    e = AudioEngine(device=device)\n"
     "    synth = e.create_synth()\n"),
    ("def cmd_play(in_path: str, out_path: str, seek: float = 0.0) -> None:\n",
     "def cmd_play(in_path: str, out_path: str, seek: float = 0.0,\n"
     "             device: str = \"cuda\") -> None:\n"),
    ("    e = AudioEngine()\n"
     "    player = e.create_player()\n",
     "    e = AudioEngine(device=device)\n"
     "    player = e.create_player()\n"),
    ("                 bpm: float = 120.0) -> None:\n",
     "                 bpm: float = 120.0, device: str = \"cuda\") -> None:\n"),
    ("    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr)\n"
     "    e.transport.set_calibration_offset(1)\n"
     "    e.transport.set_input_latency(0)\n",
     "    e = AudioEngine(input_source=ArraySource(audio), sample_rate=sr,\n"
     "                    device=device)\n"
     "    e.transport.set_calibration_offset(1)\n"
     "    e.transport.set_input_latency(0)\n"),
    ("    print(\"audio_analyzer_rs_tpu CLI — commands: tuner <wav> | onset <wav> | \"\n",
     "    print(\"audio_analyzer_rs_tpu_torch CLI — commands: tuner <wav> | \"\n"
     "          \"onset <wav> | \"\n"),
    ("def _dispatch(cmd, pos, kwargs) -> None:\n"
     "    if cmd == \"tuner\":\n"
     "        cmd_tuner(pos[0], debug_jsonl=kwargs.get(\"debug-jsonl\"))\n"
     "    elif cmd == \"onset\":\n"
     "        cmd_onset(pos[0], debug_jsonl=kwargs.get(\"debug-jsonl\"))\n",
     "def _dispatch(cmd, pos, kwargs) -> None:\n"
     "    device = kwargs.get(\"device\", \"cuda\")\n"
     "    if cmd == \"tuner\":\n"
     "        cmd_tuner(pos[0], debug_jsonl=kwargs.get(\"debug-jsonl\"),\n"
     "                  device=device)\n"
     "    elif cmd == \"onset\":\n"
     "        cmd_onset(pos[0], debug_jsonl=kwargs.get(\"debug-jsonl\"),\n"
     "                  device=device)\n"),
    ("                    segments=None if seg == \"auto\" else int(seg))\n"
     "    elif cmd == \"rec\":\n"
     "        cmd_rec(pos[0], pos[1])\n"
     "    elif cmd == \"met\":\n"
     "        cmd_met(float(pos[0]), float(pos[1]), pos[2])\n"
     "    elif cmd == \"play\":\n"
     "        cmd_play(pos[0], pos[1], seek=float(kwargs.get(\"seek\", 0.0)))\n"
     "    elif cmd == \"synth\":\n"
     "        cmd_synth(pos[0], pos[1], *(pos[2:3]))\n",
     "                    segments=None if seg == \"auto\" else int(seg),\n"
     "                    device=device)\n"
     "    elif cmd == \"rec\":\n"
     "        cmd_rec(pos[0], pos[1], device=device)\n"
     "    elif cmd == \"met\":\n"
     "        cmd_met(float(pos[0]), float(pos[1]), pos[2], device=device)\n"
     "    elif cmd == \"play\":\n"
     "        cmd_play(pos[0], pos[1], seek=float(kwargs.get(\"seek\", 0.0)),\n"
     "                 device=device)\n"
     "    elif cmd == \"synth\":\n"
     "        cmd_synth(pos[0], pos[1], *(pos[2:3]), device=device)\n"),
    ("                     bpm=float(kwargs.get(\"bpm\", 120.0)))\n",
     "                     bpm=float(kwargs.get(\"bpm\", 120.0)), device=device)\n"),
]


def test_cli_is_the_jax_cli_rewritten():
    want = (REPO / "audio_analyzer_rs_tpu" / "cli.py").read_text()
    for old, new in CLI_REWRITES:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (REPO / "audio_analyzer_rs_tpu_torch" / "cli.py").read_text() \
        == want


@pytest.fixture
def midi_file(tmp_path):
    path = str(tmp_path / "ref.mid")
    # Two measures so the first ages out and metrics are non-empty.
    write_midi_file(path, [(60, 0.0, 0.9, 90), (64, 1.0, 0.9, 90),
                           (67, 2.0, 0.9, 90), (72, 3.0, 0.9, 90),
                           (72, 4.0, 0.9, 90), (67, 5.0, 0.9, 90)],
                    bpm=120.0)
    return path


def test_cli_met_renders_wav(tmp_path, capsys):
    out = str(tmp_path / "met.wav")
    cli.main(["met", "120", "2", out] + CPU)
    data, sr, ch = wav.read_wav(out)
    assert len(data) > 0 and np.abs(data).max() > 0.1
    assert "wrote" in capsys.readouterr().out


def test_cli_synth_renders_midi(tmp_path, midi_file, capsys):
    out = str(tmp_path / "synth.wav")
    cli.main(["synth", midi_file, out] + CPU)
    data, sr, ch = wav.read_wav(out)
    assert np.abs(data).max() > 0.05
    assert "rendered" in capsys.readouterr().out


def test_cli_play_renders_file(tmp_path, capsys):
    src = str(tmp_path / "tone.wav")
    out = str(tmp_path / "played.wav")
    x = gen.tone_with_harmonics(440.0, 1.0, 44100.0, amplitude=0.4)
    wav.write_wav(src, x, 44100)
    cli.main(["play", src, out] + CPU)
    data, sr, ch = wav.read_wav(out)
    assert np.abs(data).max() > 0.2
    assert len(data) < sr * 5, len(data) / sr
    assert "played" in capsys.readouterr().out


def _clicks(tmp_path):
    path = str(tmp_path / "clicks.wav")
    x = np.zeros(int(48000 * 1.5), np.float32)
    click = gen.calibration_click(48000.0, volume=0.8)
    for t in (0.3, 0.9):
        x[int(t * 48000):int(t * 48000) + len(click)] += click
    wav.write_wav(path, x, 48000)
    return path


def test_cli_onset_lists_events(tmp_path, capsys):
    cli.main(["onset", _clicks(tmp_path)] + CPU)
    out = capsys.readouterr().out
    assert "onsets detected" in out and "velocity" in out


def test_cli_onset_streams_debug_jsonl(tmp_path, capsys):
    debug = str(tmp_path / "onset.jsonl")
    cli.main(["onset", _clicks(tmp_path), "--debug-jsonl", debug] + CPU)
    out = capsys.readouterr().out
    n_events = int(out.split(" onsets detected")[0].split()[-1])
    records = [json.loads(line) for line in open(debug)]
    onset = [r for r in records if r["kind"] == "onset"]
    assert onset and all(r["kind"] == "onset" for r in records)
    assert sum(r["fired"] for r in onset) == n_events >= 1


def test_cli_tuner_streams_debug_jsonl(tmp_path, capsys):
    """tuner --debug-jsonl: a pitch record a frame at full width, the
    tuner's notes in its labels; debug-view renders the file."""
    path = str(tmp_path / "a3.wav")
    wav.write_wav(path, gen.tone_with_harmonics(220.0, 1.0, 44100.0,
                                                harmonics=6, amplitude=0.4),
                  44100)
    debug = str(tmp_path / "tuner.jsonl")
    cli.main(["tuner", path, "--debug-jsonl", debug] + CPU)
    out = capsys.readouterr()
    assert "A3" in out.out and "streaming debug telemetry" in out.err
    records = [json.loads(line) for line in open(debug)]
    assert {r["kind"] for r in records} == {"pitch"}
    frames = [r["frame"] for r in records]
    assert frames == list(range(len(frames))) and len(frames) > 60
    labels = {p["label"] for r in records for p in r["stable_pitches"]}
    assert any(lbl.startswith("A3") for lbl in labels), labels
    view = io.StringIO()
    cli.cmd_debug_view(debug, follow=False, out=view)
    assert f"{len(records)} pitch frames, 0 onset frames" in view.getvalue()


def test_cli_practice_full_flow(midi_file, capsys):
    cli.main(["practice", midi_file, "--mode", "Performance",
              "--ability", "Advanced"] + CPU)
    out = capsys.readouterr().out
    assert "measure 0" in out
    assert "✓" in out                       # matched notes logged
    assert "accuracy" in out


def test_cli_unknown_command_exits(capsys):
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"] + CPU)


def test_cli_missing_args_usage(capsys):
    with pytest.raises(SystemExit):
        cli.main(["analyze"] + CPU)
    out = capsys.readouterr().out
    assert "missing argument" in out and "--device cuda|cpu" in out


def test_cli_debug_view_renders_stream(tmp_path):
    path = str(tmp_path / "d.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "pitch", "frame": 1, "bin_width": 21.5,
                            "stable_pitches": [{"freq": 261.6, "score": 2.0,
                                                "label": "C4"}]}) + "\n")
        f.write(json.dumps({"kind": "onset", "frame": 2, "flux": 9.0,
                            "burst_count": 5, "detected": True,
                            "fired": True, "status": "DETECTED"}) + "\n")
    out = io.StringIO()
    cli.cmd_debug_view(path, follow=False, out=out)
    text = out.getvalue()
    assert "C4" in text and "ONSET" in text
    assert "1 pitch frames, 1 onset frames, 1 onsets fired" in text


@pytest.fixture(scope="module")
def analyzed(tmp_path_factory):
    """One 2 s WAV (a melody at 44.1 kHz) through both CLIs' analyze
    --segments 2."""
    d = tmp_path_factory.mktemp("analyze")
    path = str(d / "scene.wav")
    wav.write_wav(path, gen.mixed_scene(2.0, 44100.0, seed=11), 44100)
    outs = {}
    for name, main, extra in (("port", cli.main, CPU), ("jax", jcli.main,
                                                         [])):
        out = str(d / f"{name}.jsonl")
        main(["analyze", path, out, "--segments", "2"] + extra)
        outs[name] = [json.loads(line) for line in open(out)]
    return outs


def test_cli_analyze_jsonl(analyzed):
    header, frames = analyzed["port"][0], analyzed["port"][1:]
    assert header["frames"] == len(frames) == 169
    assert header["sample_rate"] == 44100.0
    assert any(f["stable_pitches"] for f in frames)
    assert all(np.isfinite(f["rms"]) for f in frames)


def test_cli_analyze_matches_the_jax_cli(analyzed):
    (th, *tf), (jh, *jf) = analyzed["port"], analyzed["jax"]
    assert th["frames"] == jh["frames"] == len(tf) == len(jf)
    assert [o["frame"] for o in th["onsets"]] == \
        [o["frame"] for o in jh["onsets"]]
    np.testing.assert_allclose([o["velocity"] for o in th["onsets"]],
                               [o["velocity"] for o in jh["onsets"]],
                               rtol=RTOL)
    flux_scale = max(abs(f["flux"]) for f in jf)
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert a["t"] == b["t"] and a["yin_voiced"] == b["yin_voiced"], i
        assert len(a["stable_pitches"]) == len(b["stable_pitches"]), i
        for (af, asc), (bf, bsc) in zip(a["stable_pitches"],
                                        b["stable_pitches"]):
            assert af == pytest.approx(bf, rel=RTOL), i
            assert asc == pytest.approx(bsc, rel=RTOL), i
        assert a["rms"] == pytest.approx(b["rms"], rel=RTOL), i
        assert abs(a["flux"] - b["flux"]) <= RTOL * flux_scale, i
        for key in ("centroid_hz", "rolloff_hz", "yin_f0_hz"):
            assert a[key] == pytest.approx(b[key], rel=RTOL, abs=0.1), \
                (i, key)
    assert any(f["stable_pitches"] for f in tf)


def test_cli_runs_as_a_module_on_the_cpu(tmp_path):
    out = str(tmp_path / "met.wav")
    res = subprocess.run([sys.executable, "-m",
                          "audio_analyzer_rs_tpu_torch.cli", "met", "100",
                          "1", out] + CPU, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "wrote" in res.stdout and wav.read_wav(out)[0].size > 0
