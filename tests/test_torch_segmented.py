"""PyTorch port, the segmented pitch pipeline end to end against the JAX
package, plus the port's guards.

The audio is a 20 s `mixed_scene(seed=1)` at segments=2, chunk_frames=64,
warmup_frames=128.  The JAX runs are computed once (module fixture).

Agreement criteria:
- decisions are exact: every stable slot's valid flag, frame by frame;
- stable freqs and scores within rtol 1e-5 where valid;
- frame agreement of the stable sets at 0.1 Hz (as tests/test_segmented.py
  measures it): every frame agrees except the one known straddle, frame 881
  of the 20 s scene (113.749985 Hz in the port, 113.75001 Hz in JAX), whose
  freqs must also lie within rtol 1e-5 of a 0.05 Hz rounding boundary;
- with the magnitudes equalized (the port's floor, extraction and tracker
  fed the JAX STFT), frame agreement at 0.1 Hz is exactly 100%: what is left
  of a difference comes from the STFT's summation order, which is precision
  (the method of tests/test_divergence_proof.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import segmented as jseg
from audio_analyzer_rs_tpu.models.analyzer import PitchAnalyzer as JaxAnalyzer
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models import segmented as tseg
from audio_analyzer_rs_tpu_torch.models.analyzer import PitchAnalyzer
from audio_analyzer_rs_tpu_torch.ops import noisefloor, pitch, tracker

torch.set_num_threads(1)

SR = 44100.0
HALF = 1025
GEOMETRY = dict(chunk_frames=64, warmup_frames=128)
RTOL = 1e-5
KNOWN_STRADDLES = {881}      # frames of the 20 s scene, see the docstring
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audio_analyzer_rs_tpu_torch"


def _takes(x):
    i16 = np.clip(x[int(5 * SR):int(9.5 * SR)] * 32768.0, -32768,
                  32767).astype(np.int16)
    return [x[:int(7 * SR)], x[int(3 * SR):int(15 * SR)], i16]


@pytest.fixture(scope="module")
def scene():
    x = gen.mixed_scene(20.0, SR, seed=1)
    return dict(
        x=x,
        seg=jseg.segmented_pitch_analysis(x, SR, segments=2, **GEOMETRY),
        seq=JaxAnalyzer(SR).process(x),
        batch=jseg.segmented_pitch_analysis_batch(_takes(x), SR, **GEOMETRY),
    )


def _rounded(freqs, valid, i):
    return sorted(np.round(freqs[i][valid[i]], 1))


def _near_rounding_boundary(f):
    """f within rtol 1e-5 of a 0.05 Hz boundary (where 0.1 Hz rounding
    flips)."""
    f = np.asarray(f, np.float64)
    return np.abs(f * 10.0 - np.floor(f * 10.0) - 0.5) * 0.1 <= RTOL * f


def _assert_agrees(got, ref, straddles=frozenset(), score_atol=0.0):
    """got/ref: (freqs, scores, valid) [N, 8] — see the module docstring.
    Only the frames in `straddles` may differ at 0.1 Hz."""
    (gf, gs, gv), (rf, rs, rv) = got, ref
    assert gf.shape == rf.shape and gv.shape == rv.shape
    np.testing.assert_array_equal(gv, rv)
    assert rv.any()
    np.testing.assert_allclose(gf[rv], rf[rv], rtol=RTOL)
    np.testing.assert_allclose(gs[rv], rs[rv], rtol=RTOL, atol=score_atol)
    flips = [i for i in range(len(rf))
             if _rounded(gf, gv, i) != _rounded(rf, rv, i)]
    assert set(flips) <= straddles, f"frames {flips} differ at 0.1 Hz"
    for i in flips:
        differ = np.round(gf[i][gv[i]], 1) != np.round(rf[i][rv[i]], 1)
        assert _near_rounding_boundary(rf[i][rv[i]][differ]).all(), (
            f"frame {i}: {gf[i][gv[i]]} vs {rf[i][rv[i]]} is not a 0.1 Hz "
            "rounding-boundary straddle")


def test_segmented_matches_jax(scene):
    got = tseg.segmented_pitch_analysis(scene["x"], SR, segments=2,
                                        device="cpu", **GEOMETRY)
    _assert_agrees(got, scene["seg"], KNOWN_STRADDLES)


def test_pitch_analyzer_matches_jax(scene):
    ref = scene["seq"]
    got = PitchAnalyzer(SR, device="cpu").process(scene["x"])
    np.testing.assert_array_equal(got.raw_valid, ref.raw_valid)
    np.testing.assert_allclose(got.mags, ref.mags, rtol=0,
                               atol=1e-5 * float(np.abs(ref.mags).max()))
    _assert_agrees(
        (got.stable_freqs, got.stable_scores, got.stable_valid),
        (ref.stable_freqs, ref.stable_scores, ref.stable_valid),
        KNOWN_STRADDLES)


def test_equalized_precision_agreement_is_100pct(scene):
    """The port's floor scan, extraction and tracker fed the JAX magnitudes
    agree with the JAX run on every frame at 0.1 Hz."""
    ref = scene["seq"]
    mags = torch.from_numpy(np.array(ref.mags))          # [N, kc+1]
    n = mags.shape[0]
    bin_width = float(np.float32(SR) / np.float32(2048))
    kc = pitch.candidate_band(bin_width, HALF)
    gf = torch.full((1, n), float(noisefloor.global_floor_linear(-96.0,
                                                                 HALF)))
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, "cpu", (1,)), mags[None], gf, kc)
    pf = pitch.extract_pitches(mags, eff[0], bin_width, true_half=HALF)
    np.testing.assert_array_equal(pf.valid.numpy(), ref.raw_valid)
    _, (sf, ss, sv) = tracker.tracker_scan(
        tracker.init_state("cpu"), pf.freqs, pf.scores, pf.valid,
        torch.zeros(n, dtype=torch.bool))
    sf, sv = sf.numpy(), sv.numpy()
    np.testing.assert_array_equal(sv, ref.stable_valid)
    agree = sum(_rounded(sf, sv, i)
                == _rounded(ref.stable_freqs, ref.stable_valid, i)
                for i in range(n))
    assert agree == n, f"{n - agree} of {n} frames differ"


def test_batch_matches_jax(scene):
    got = tseg.segmented_pitch_analysis_batch(_takes(scene["x"]), SR,
                                              device="cpu", **GEOMETRY)
    assert len(got) == len(scene["batch"]) == 3
    for g, r in zip(got, scene["batch"]):
        _assert_agrees(g, r)


def test_short_and_empty_inputs():
    x = gen.mixed_scene(3.0, SR, seed=2)
    sf, ss, sv = tseg.segmented_pitch_analysis(x, SR, segments=16,
                                               device="cpu", chunk_frames=64)
    seq = PitchAnalyzer(SR, device="cpu").process(x)
    np.testing.assert_array_equal(sv, seq.stable_valid)
    np.testing.assert_allclose(sf, seq.stable_freqs, rtol=RTOL)
    sf, ss, sv = tseg.segmented_pitch_analysis(np.zeros(100, np.float32), SR,
                                               device="cpu")
    assert sf.shape == (0, 8) and sv.dtype == bool
    assert tseg.segmented_pitch_analysis_batch([], SR, device="cpu") == []


@pytest.mark.parametrize("n_total,warmup", [(1719, 128), (310_000, 128),
                                            (5_000, 64), (100, 128)])
def test_stream_plan_matches_jax(n_total, warmup):
    s = tseg.auto_segments(n_total, warmup)
    assert s == jseg.auto_segments(n_total, warmup)
    got = tseg._plan_streams(n_total, s, warmup, 64, 2048, 512)
    ref = jseg._plan_streams(n_total, s, warmup, 64, 2048, 512)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert tseg._batch_plan([n_total, n_total // 2], None, warmup, 64, 2048,
                            512).segments == \
        jseg._batch_plan([n_total, n_total // 2], None, warmup, 64, 2048,
                         512).segments


def test_unported_options_raise():
    x = np.zeros(int(SR), np.float32)
    # mesh is ported: a DeviceMesh (tests/test_torch_mesh.py), or None.
    with pytest.raises(TypeError, match="mesh"):
        tseg.segmented_pitch_analysis(x, SR, mesh=object(), device="cpu")
    # device_audio is ported: a float32 tensor of len(audio) samples.
    with pytest.raises(ValueError):
        tseg.segmented_pitch_analysis(x, SR, device_audio=x, device="cpu")
    tseg.segmented_pitch_analysis(x, SR, device_audio=torch.from_numpy(x),
                                  device="cpu")
    # warmup_mode="floor" is ported: on a clip this short it runs "full".
    for a, b in zip(tseg.segmented_pitch_analysis(x, SR, warmup_mode="floor",
                                                  device="cpu"),
                    tseg.segmented_pitch_analysis(x, SR, device="cpu")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tseg.segmented_pitch_analysis(x, SR, warmup_mode="half",
                                      device="cpu")
    with pytest.raises(ValueError):
        tseg.segmented_pitch_analysis(x, SR, transfer="tunnel", device="cpu")
    # transfer is ported: every mode gives the resident bits.
    want = tseg.segmented_pitch_analysis(x, SR, transfer="resident",
                                         device="cpu")
    for transfer in ("auto", "pipelined"):
        for a, b in zip(tseg.segmented_pitch_analysis(
                x, SR, transfer=transfer, device="cpu"), want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_pipelined_transfer_matches_resident_and_jax(dtype):
    """transfer="pipelined" (two staging buffers, a block a step) gives the
    resident path's bits, over 4 steps, so that both buffers are refilled;
    and agrees with the JAX package's own pipelined run by this module's
    criteria (decisions exact, floats within rtol 1e-5).  A score is
    log2(0.5 + s) times the structure factor, so a score near 0 carries
    the log's float32 error near log2(1), which is absolute: scores are
    held within 4 ulps of 1.0 besides rtol 1e-5 (this scene has a valid
    score of 0.0070, 1.0e-7 off JAX's)."""
    x = gen.mixed_scene(5.0, SR, seed=1)
    if dtype == "int16":     # scaled and clipped as JAX's transfer test
        x = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    kw = dict(segments=2, warmup_frames=64, chunk_frames=64)
    n_total = tseg.num_frames(len(x), 2048, 512)
    assert tseg._plan_streams(n_total, 2, 64, 64, 2048, 512).steps >= 3
    got = tseg.segmented_pitch_analysis(x, SR, transfer="pipelined",
                                        device="cpu", **kw)
    want = tseg.segmented_pitch_analysis(x, SR, transfer="resident",
                                         device="cpu", **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    _assert_agrees(got, jseg.segmented_pitch_analysis(
        x, SR, transfer="pipelined", **kw), score_atol=4 * 2.0 ** -23)


def test_resolve_transfer_auto_policy():
    """JAX's test_resolve_transfer_auto_policy, on the port's constant (the
    crossover measured on the card, 10 minutes)."""
    limit = tseg.AUTO_PIPELINED_MIN_SECONDS
    resolve = tseg._resolve_transfer
    assert limit == 600.0
    long_n, short_n = int(limit * SR) + 1, int(limit * SR) - 1
    assert resolve("auto", "pitch", long_n, SR, None) == "pipelined"
    assert resolve("auto", "pitch", short_n, SR, None) == "resident"
    # A shared device upload is on the device already: never pipeline.
    assert resolve("auto", "pitch", long_n, SR, object()) == "resident"
    # Onset steps cannot hide a copy.
    assert resolve("auto", "onset", long_n, SR, None) == "resident"
    # Explicit modes pass through.
    assert resolve("resident", "pitch", long_n, SR, None) == "resident"
    assert resolve("pipelined", "onset", short_n, SR, None) == "pipelined"
    for bad in ("Auto", "pipeline", "", "stream"):
        with pytest.raises(ValueError, match="transfer="):
            resolve(bad, "pitch", long_n, SR, None)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tseg.segmented_pitch_analysis(gen.mixed_scene(3.0, SR, seed=2), SR)


def test_port_runs_without_jax_in_a_fresh_process():
    code = (
        "import sys, numpy as np\n"
        "from audio_analyzer_rs_tpu_torch.models import generators as gen\n"
        "from audio_analyzer_rs_tpu_torch.models.segmented import "
        "segmented_pitch_analysis\n"
        "x = gen.mixed_scene(3.0, 44100.0, seed=1)\n"
        "f, s, v = segmented_pitch_analysis(x, 44100.0, device='cpu')\n"
        "assert f.shape[1] == 8 and np.isfinite(f).all()\n"
        "from audio_analyzer_rs_tpu_torch import analyze_buffer_segmented\n"
        "a = analyze_buffer_segmented(x, 44100.0, device='cpu')\n"
        "assert len(a.rms) == len(f) and np.isfinite(a.spectrogram).all()\n"
        "from audio_analyzer_rs_tpu_torch import AudioEngine\n"
        "from audio_analyzer_rs_tpu_torch.api.device import ArraySource\n"
        "e = AudioEngine(input_source=ArraySource(x[:48000]), "
        "sample_rate=48000.0, device='cpu')\n"
        "t, o = e.start_tuner(), e.start_onset_detection()\n"
        "e.advance(0.5)\n"
        "assert e._fused_slots > 0 and t.poll_output() and o.poll_onsets()\n"
        "from audio_analyzer_rs_tpu_torch import EnginePool, checkpoint\n"
        "from audio_analyzer_rs_tpu_torch.api.rpc import RpcServer\n"
        "p = EnginePool([e], pipeline_depth=1)\n"
        "p.advance(0.1)\n"
        "import tempfile, os\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    checkpoint.save_engine(os.path.join(d, 'e.npz'), e)\n"
        "assert RpcServer(device='cpu').handle({'method': 'ping'})"
        "['result'] == 'pong'\n"
        "from audio_analyzer_rs_tpu_torch import (init_stream_states, "
        "make_batched_full_step)\n"
        "step = make_batched_full_step(None, 48000.0, device='cpu')\n"
        "st, out = step(init_stream_states(1, device='cpu'), "
        "x[None, :4096])\n"
        "assert out.stable_freqs.shape == (1, 5, 8)\n"
        "from audio_analyzer_rs_tpu_torch import cli, devtools\n"
        "rec = devtools.DebugRecorder()\n"
        "e.attach_debug_recorder(rec)\n"
        "e.advance(0.1)\n"
        "assert rec.pitch_frames and rec.onset_frames\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_names(path):
    """Every module name an import statement of `path` brings in (absolute
    imports; `from m import a, b` yields m.a and m.b)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


def test_source_scan():
    """No jax, no torch.compile, and nothing of the JAX package, in the port,
    in chip_smoke.py and in port_tools/."""
    files = sorted(p for p in PORT.rglob("*.py")
                   if "_build" not in p.relative_to(PORT).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 15
    files += sorted((REPO / "port_tools").glob("*.py"))
    for new in ("api/pool.py", "api/rpc.py", "checkpoint.py",
                "parallel/sharding.py", "ops/hopper_reducer.py",
                "ops/hopper_dynamics.py", "devtools.py", "cli.py",
                "parallel/mesh.py", "parallel/dryrun.py", "ops/gather.py",
                "ops/hopper_gather.py", "ops/hopper_extract.py",
                "ops/hopper_rfft.py"):
        assert PORT / new in files, new
    assert REPO / "port_tools" / "gather_probe.py" in files
    assert REPO / "port_tools" / "k1_k10_probe.py" in files
    for path in files:
        assert "torch.compile" not in path.read_text(), path
        for name in _imported_names(path):
            assert name.split(".")[0] not in ("jax", "audio_analyzer_rs_tpu"), \
                (path, name)
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == \
        ["comb.cu", "dynamics.cu", "extract.cu", "gather.cu", "noisefloor.cu",
         "onset.cu", "reducer.cu", "rfft_mag.cu", "stft.cu", "tracker.cu"]
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cuh")) == \
        ["comb.cuh"]
