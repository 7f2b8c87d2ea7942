"""PyTorch port, the NumPy oracles: the port's copies of the JAX package's
float64/float32 loop transcriptions of the Rust reference.

The machine with the card has no JAX, so the port carries its own copy of
each oracle (`frame_signal_np`, `rfft_mag_np`, `_fma32`, `noise_floor_np`,
`extract_pitches_np`, `PitchTrackerNp`, `onset_np`, `yin_pitch_np`,
`feature_pack_np`, `full_chain_np`).  Each is held to the JAX package's two
ways:
- "source": the port's function has the same syntax tree (`ast.dump`) as
  the JAX package's, import statements excepted; the JAX module is read as
  text, not imported, for this; and the copy names nothing of torch;
- "bits": on seeded numpy inputs its outputs equal the JAX oracle's bit for
  bit.
Sizes stay tiny (<= 64 frames, 2 s for the full chain): the oracles are
Python loops.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.ops import (features as jfeatures, fft as jfft,
                                       noisefloor as jnoisefloor,
                                       onset as jonset, pitch as jpitch,
                                       tracker as jtracker, yin as jyin)
from audio_analyzer_rs_tpu.parallel import sharding as jsharding
from audio_analyzer_rs_tpu.utils import framing as jframing
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import (features, fft, noisefloor, onset,
                                             pitch, tracker, yin)
from audio_analyzer_rs_tpu_torch.ops.stft import stft_mags_np
from audio_analyzer_rs_tpu_torch.parallel import sharding
from audio_analyzer_rs_tpu_torch.utils import framing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 44100.0
BIN_WIDTH = float(np.float32(SR) / np.float32(2048))

# name -> (module path under either package, port module, JAX module)
ORACLES = {
    "frame_signal_np": ("utils/framing.py", framing, jframing),
    "rfft_mag_np": ("ops/fft.py", fft, jfft),
    "_fma32": ("ops/noisefloor.py", noisefloor, jnoisefloor),
    "noise_floor_np": ("ops/noisefloor.py", noisefloor, jnoisefloor),
    "extract_pitches_np": ("ops/pitch.py", pitch, jpitch),
    "PitchTrackerNp": ("ops/tracker.py", tracker, jtracker),
    "onset_np": ("ops/onset.py", onset, jonset),
    "yin_pitch_np": ("ops/yin.py", yin, jyin),
    "feature_pack_np": ("ops/features.py", features, jfeatures),
    "full_chain_np": ("parallel/sharding.py", sharding, jsharding),
}


class _NoImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _definition(package: str, rel: str, name: str) -> ast.AST:
    tree = ast.parse((REPO / package / rel).read_text())
    node = next(n for n in tree.body if getattr(n, "name", None) == name)
    return _NoImports().visit(node)


def _tone_mags(n_frames: int, seed: int) -> np.ndarray:
    """[n_frames, 1025] float32 magnitudes of two harmonic tones in noise."""
    rng = np.random.default_rng(seed)
    n = 2048 + (n_frames - 1) * 512
    x = (gen.tone_with_harmonics(196.0, n / SR + 0.1, SR, amplitude=0.3)[:n]
         + gen.tone_with_harmonics(523.25, n / SR + 0.1, SR,
                                   amplitude=0.2)[:n]
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
    return stft_mags_np(x, 2048, 512).astype(np.float32)


def _same(a, b) -> None:
    """Bit for bit: arrays by dtype, shape and bytes (NaNs by position);
    lists, tuples and dicts element by element; Python floats exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert a.tobytes() == b.tobytes() or np.isnan(a).any()
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def _run(name: str, mod):
    """The oracle `name` of module `mod` on this test's seeded inputs."""
    rng = np.random.default_rng(sum(map(ord, name)))
    fn = getattr(mod, name)
    if name == "frame_signal_np":
        x = rng.standard_normal(256 + 63 * 64).astype(np.float32)
        return fn(x, 256, 64), fn(x[:1000], 256, 64)
    if name == "rfft_mag_np":
        return fn(rng.standard_normal((16, 256)).astype(np.float32))
    if name == "_fma32":
        a, b, c = rng.standard_normal((3, 4096)).astype(np.float32)
        return fn(a, b, c), fn(a * 1e-20, b * 1e-20, c * 1e-38)
    if name == "noise_floor_np":
        mags = np.abs(rng.standard_normal((64, 65)) * 3.0).astype(np.float32)
        mags[20:24] *= 40.0             # a rising section: the floor chases
        mags[40:] = 0.0                 # then digital silence
        gfloor = np.full(64, 0.02, np.float32)
        return fn(mags, gfloor), fn(mags, gfloor, fma=True)
    if name in ("extract_pitches_np", "PitchTrackerNp"):
        mags = _tone_mags(24, seed=5)
        eff = noisefloor.noise_floor_np(mags, np.full(24, 0.05, np.float32),
                                        fma=True)
        raws = [pitch.extract_pitches_np(m, f, BIN_WIDTH)
                for m, f in zip(mags, eff)]
        if name == "extract_pitches_np":
            return [fn(m, f, BIN_WIDTH) for m, f in zip(mags, eff)] + [
                fn(mags[3], eff[3], BIN_WIDTH, min_freq=100.0,
                   max_freq=400.0)]
        tr = fn()
        onsets = rng.random(len(raws) + 8) < 0.2
        return [tr.process(r, onset=bool(o))
                for r, o in zip(raws + raws[:8][::-1], onsets)]
    if name == "onset_np":
        mags = np.abs(rng.standard_normal((64, 129))).astype(np.float32)
        mags[10:12] *= 30.0             # two bursts: bins rise past 2.5x
        mags[30:33] *= 50.0
        gfloor = np.full(64, 0.05, np.float32)
        ticks = rng.random(64) < 0.1
        hold = rng.random(64) < 0.1
        return fn(mags, gfloor, ticks), fn(mags, gfloor, ticks, hold)
    if name == "yin_pitch_np":
        tone = gen.tone_with_harmonics(220.0, 0.1, SR,
                                       amplitude=0.4)[:2048]
        noise = rng.standard_normal(2048).astype(np.float32)
        return fn(tone, SR), fn(noise, SR), fn(tone, SR, fmin=300.0)
    if name == "feature_pack_np":
        frames = rng.standard_normal((16, 256)).astype(np.float32)
        mags = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)
        return fn(frames, mags, SR, 256)
    assert name == "full_chain_np"
    # Seconds 10-12 of the canonical scene (it opens with 10 s of silence).
    x = gen.mixed_scene(12.0, 48000.0, seed=3)[480_000:]
    x = x[:(len(x) // 1024) * 1024]
    return fn(x, 48000.0)


@pytest.mark.parametrize("check", ["source", "bits"])
@pytest.mark.parametrize("name", sorted(ORACLES))
def test_oracle_is_the_jax_one(name, check):
    rel, port_mod, jax_mod = ORACLES[name]
    if check == "source":
        got = _definition("audio_analyzer_rs_tpu_torch", rel, name)
        want = _definition("audio_analyzer_rs_tpu", rel, name)
        assert ast.dump(got) == ast.dump(want)
        assert not any(isinstance(n, ast.Name) and n.id == "torch"
                       for n in ast.walk(got))
        return
    got, want = _run(name, port_mod), _run(name, jax_mod)
    _same(got, want)
    if name == "full_chain_np":
        assert any(got["stable"]) and got["onset_fired"].any()
    if name == "extract_pitches_np":
        assert sum(map(len, got)) > 24
