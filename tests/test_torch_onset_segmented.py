"""PyTorch port, the segmented onset path against the JAX package, on a
20 s `mixed_scene(seed=1)` at segments=4, chunk_frames=1024 (warmup 128).

Agreement criteria:
- fired is equal frame by frame, to JAX's segmented run;
- velocity, flux and energy within rtol 1e-5 of JAX's (the 256-point FFT,
  torch.fft against jnp.fft, and the onset sums' order, see
  tests/test_torch_onset.py);
- segment 0 equals the port's own sequential `OnsetAnalyzer` bit for bit
  (on the CPU, torch.fft gives each frame the same bits in any batch);
- the batch entry point gives each take the bits of a single call, and
  `device_audio` the bits of a host upload.
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import segmented as jseg
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models import segmented as tseg
from audio_analyzer_rs_tpu_torch.models.analyzer import OnsetAnalyzer
from audio_analyzer_rs_tpu_torch.ops.stft import ONSET_HOP, ONSET_WINDOW
from audio_analyzer_rs_tpu_torch.utils.framing import num_frames

torch.set_num_threads(1)

SR = 44100.0
GEOMETRY = dict(segments=4, chunk_frames=1024, warmup_frames=128)
RTOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    x = gen.mixed_scene(20.0, SR, seed=1)
    return dict(x=x,
                jax=jseg.segmented_onset_analysis(x, SR, **GEOMETRY),
                port=tseg.segmented_onset_analysis(x, SR, device="cpu",
                                                   **GEOMETRY))


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_segmented_onsets_match_jax(scene):
    (gf, gv, gx, ge), (rf, rv, rx, re_) = scene["port"], scene["jax"]
    n = num_frames(len(scene["x"]), ONSET_WINDOW, ONSET_HOP)
    assert gf.shape == (n,) and gf.dtype == bool
    np.testing.assert_array_equal(gf, rf)
    assert rf.sum() >= 10, "the scene has percussion"
    np.testing.assert_allclose(gv, rv, rtol=RTOL, atol=0)
    np.testing.assert_allclose(gx, rx, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ge, re_, rtol=RTOL, atol=0)


def test_segment0_equals_sequential(scene):
    x = scene["x"]
    n = num_frames(len(x), ONSET_WINDOW, ONSET_HOP)
    plan = tseg._plan_streams(n, 4, 128, 1024, ONSET_WINDOW, ONSET_HOP)
    seg0 = plan.payload_range(0, n)[1]
    seq = OnsetAnalyzer(SR, device="cpu").process(x)
    got = scene["port"]
    for a, b in zip(got, (seq.fired, seq.velocity, seq.flux, seq.energy)):
        np.testing.assert_array_equal(a[:seg0], b[:seg0])
    # Past segment 0 the warmed-up segments fire on the same frames.
    np.testing.assert_array_equal(got[0], seq.fired)


def test_batch_equals_single_calls(scene):
    """Each take of a batch gets the bits of a single call, for a float32
    batch and an int16 batch.  (A batch that mixes the two converts its
    int16 takes to float32 without the 1/32768 scale, in the JAX package
    and in the port alike; ROADMAP Queue 3.)"""
    x = scene["x"]
    floats = [x[:int(3 * SR)], x[int(8 * SR):int(11 * SR)]]
    ints = [np.clip(t * 32768.0, -32768, 32767).astype(np.int16)
            for t in (x[int(12 * SR):int(15 * SR)],
                      x[int(4 * SR):int(7 * SR)])]
    for takes in (floats, ints):
        got = tseg.segmented_onset_analysis_batch(
            takes, SR, segments_per_recording=2, chunk_frames=512,
            device="cpu")
        assert len(got) == 2
        for g, take in zip(got, takes):
            _assert_same(g, tseg.segmented_onset_analysis(
                take, SR, segments=2, chunk_frames=512, device="cpu"))
        assert any(g[0].any() for g in got)
    assert tseg.segmented_onset_analysis_batch([], SR, device="cpu") == []


def test_device_audio_equals_upload(scene):
    x = scene["x"][:int(6 * SR)]
    dev = torch.from_numpy(x)
    _assert_same(
        tseg.segmented_onset_analysis(x, SR, device="cpu", device_audio=dev,
                                      **GEOMETRY),
        tseg.segmented_onset_analysis(x, SR, device="cpu", **GEOMETRY))
    _assert_same(
        tseg.segmented_pitch_analysis(x, SR, device="cpu", device_audio=dev,
                                      segments=2),
        tseg.segmented_pitch_analysis(x, SR, device="cpu", segments=2))
    with pytest.raises(ValueError):
        tseg.segmented_onset_analysis(x, SR, device="cpu",
                                      device_audio=dev[:-1])
    with pytest.raises(ValueError):
        tseg.segmented_onset_analysis(x, SR, device="cpu",
                                      device_audio=dev.double())


def test_short_empty_and_unported():
    f, v, x, e = tseg.segmented_onset_analysis(np.zeros(100, np.float32), SR,
                                               device="cpu")
    assert f.shape == (0,) and f.dtype == bool and v.dtype == np.float32
    silent = tseg.segmented_onset_analysis(np.zeros(int(SR), np.float32), SR,
                                           chunk_frames=256, device="cpu")
    assert not silent[0].any()
    with pytest.raises(TypeError, match="mesh"):
        tseg.segmented_onset_analysis(np.zeros(int(SR), np.float32), SR,
                                      mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        tseg.segmented_onset_analysis(np.zeros(int(SR), np.float32), SR,
                                      transfer="tunnel", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_pipelined_transfer_matches_resident_and_jax(dtype):
    """transfer="pipelined" gives the resident path's bits over 5 steps (both
    staging buffers refilled), for float32 input and the scene scaled and
    clipped to int16; and agrees with the JAX package's own pipelined run
    by this module's criteria."""
    x = gen.mixed_scene(2.5, SR, seed=1)
    if dtype == "int16":
        x = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    kw = dict(segments=2, warmup_frames=128, chunk_frames=256)
    n = num_frames(len(x), ONSET_WINDOW, ONSET_HOP)
    assert tseg._plan_streams(n, 2, 128, 256, ONSET_WINDOW,
                              ONSET_HOP).steps >= 3
    got = tseg.segmented_onset_analysis(x, SR, transfer="pipelined",
                                        device="cpu", **kw)
    _assert_same(got, tseg.segmented_onset_analysis(
        x, SR, transfer="resident", device="cpu", **kw))
    assert got[0].any()
    (gf, gv, gx, ge) = got
    (rf, rv, rx, re_) = jseg.segmented_onset_analysis(
        x, SR, transfer="pipelined", **kw)
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_allclose(gv, rv, rtol=RTOL, atol=0)
    np.testing.assert_allclose(gx, rx, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ge, re_, rtol=RTOL, atol=0)
