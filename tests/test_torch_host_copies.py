"""The port's copies of the JAX package's host modules.

The live engine stands on host code that imports no JAX: the theory,
transport, tracing, MIDI and WAV modules, the audio sources and the tuner
core, the practice package, the virtual audio device and the runtime
binding; beside them the dev tools' recorders (`devtools.py`).  The port keeps its own copies at the same paths, so that it
imports nothing of the JAX package, and this file holds each copy to the
original: the same source, line for line, apart from the rewrites listed
here (relative imports resolve inside each package, so none is needed for
an import).  The numpy host pieces of two JAX modules, `ops/dynamics.py`
and `ops/reducer.py`, are copied class by class, and run bit-equal to the
originals on a 5 s scene.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

from audio_analyzer_rs_tpu.ops import dynamics as jdyn
from audio_analyzer_rs_tpu.ops import reducer as jred
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import dynamics as tdyn
from audio_analyzer_rs_tpu_torch.ops import reducer as tred

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "audio_analyzer_rs_tpu"
PORT = REPO / "audio_analyzer_rs_tpu_torch"
SR = 48000.0
ONE_SECOND = int(SR)

COPIES = (
    "theory.py", "transport.py", "tracing.py", "runtime.py", "devtools.py",
    "utils/midi.py", "utils/wav.py",
    "models/sources.py", "models/calibration.py", "models/metronome.py",
    "models/synth.py", "models/player.py", "models/tuner.py",
    "api/__init__.py", "api/device.py",
    "practice/__init__.py", "practice/buffer.py", "practice/clock.py",
    "practice/conditioner.py", "practice/matcher.py", "practice/metrics.py",
    "practice/mode.py", "practice/session.py", "practice/types.py",
)

# (JAX package object, port object, [(line in the JAX source, line in the
# port's)]): the host pieces copied out of modules that import JAX.
PIECES = {
    "DynamicsTrackerNp": (jdyn.DynamicsTrackerNp, tdyn.DynamicsTrackerNp,
                          []),
    "biquad_coeffs": (jred.biquad_coeffs, tred.biquad_coeffs, []),
    "HostReducer": (jred.HostReducer, tred.HostReducer, [(
        "    a dedicated thread, ref mod.rs:336-511); the TPU takes the "
        "batched FFT",
        "    a dedicated thread, ref mod.rs:336-511); the GPU takes the "
        "batched FFT")]),
    "reduce_signal_np": (jred.reduce_signal_np, tred.reduce_signal_np, []),
}


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_jax_module(path):
    assert (PORT / path).read_text() == (JAX / path).read_text(), path


def test_practice_package_is_copied_whole():
    names = sorted(p.name for p in (JAX / "practice").glob("*.py"))
    assert len(names) == 9
    assert sorted(p.name for p in (PORT / "practice").glob("*.py")) == names
    assert all(f"practice/{n}" in COPIES for n in names)


def test_host_constants_are_the_jax_ones():
    for name in ("LEVEL_NAMES", "LONG_LEN", "PLAY_LEN", "TARGET_DB",
                 "MAX_BOOST_DB", "SMOOTH_SECS", "SILENCE_DECAY_SECS",
                 "ACTIVE_SNR_DB", "BOOTSTRAP_FLOOR_DB", "PEAK_HEADROOM"):
        assert getattr(tdyn, name) == getattr(jdyn, name), name
    for name in ("GATE_THRESHOLD_DB", "GATE_RELEASE_S", "GATE_HOLD_S",
                 "HPF_FREQ", "LPF_FREQ"):
        assert getattr(tred, name) == getattr(jred, name), name


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_host_piece_is_the_jax_code(piece):
    jax_obj, port_obj, rewrites = PIECES[piece]
    want = inspect.getsource(jax_obj).splitlines()
    for old, new in rewrites:
        assert want.count(old) == 1, old
        want[want.index(old)] = new
    assert inspect.getsource(port_obj).splitlines() == want


@pytest.fixture(scope="module")
def scene():
    x = gen.mixed_scene(5.0, SR, seed=3)
    x[int(2.0 * SR):int(2.5 * SR)] = 0.0          # digital silence
    return x


def test_host_reducer_and_dynamics_run_bit_equal(scene):
    """Slot by slot over a 5 s scene: the reducer's output and the
    dynamics tracker's fields and gained slot, bit for bit."""
    jr, tr = jred.HostReducer(SR), tred.HostReducer(SR)
    jd, td = (jdyn.DynamicsTrackerNp(SR, 1024),
              tdyn.DynamicsTrackerNp(SR, 1024))
    for i in range(len(scene) // 1024):
        slot = scene[i * 1024:(i + 1) * 1024]
        a, b = jr.process(slot), tr.process(slot)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        da, db = jd.process_slot(a), td.process_slot(b)
        np.testing.assert_array_equal(da.pop("slot").view(np.uint32),
                                      db.pop("slot").view(np.uint32))
        assert da == db, i
    np.testing.assert_array_equal(
        jred.reduce_signal_np(scene[:ONE_SECOND], SR).view(np.uint32),
        tred.reduce_signal_np(scene[:ONE_SECOND], SR).view(np.uint32))
