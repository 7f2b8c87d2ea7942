"""`segmented_pitch_analysis(warmup_mode="floor")` and
`analyzer.floor_warmup_frames` of the port against the JAX package's, and
against the port's "full" warmup.

Gates (JAX's, tests/test_segmented.py): "floor" agrees with "full" on every
frame's stable pitch set at 0.1 Hz, and segment 0's prefix (no look-back in
either mode) is bitwise equal; the port's "floor" holds the same notes as
JAX's in every frame, frequencies within 1e-4 relative (the STFT's GEMM
rounds in another order than XLA's, so not bitwise: the noise floors
after the warmup scan differ by up to 1.1e-4 of their largest value, held
at 5e-4).  Where "floor" and "full" differ (a frame of the 30-minute
scene), the port's modes differ on the frames where JAX's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import analyzer as janalyzer
from audio_analyzer_rs_tpu.models import segmented as jseg
from audio_analyzer_rs_tpu.ops import noisefloor as jnf
from audio_analyzer_rs_tpu_torch.models import analyzer as tanalyzer
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.models import segmented as tseg
from audio_analyzer_rs_tpu_torch.ops import noisefloor as tnf
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal, num_frames

torch.set_num_threads(1)

SR = 44100.0
KW = dict(segments=4, chunk_frames=64, warmup_frames=128)


def frame_sets(freqs, valid):
    return [sorted(np.round(freqs[i][valid[i]], 1)) for i in range(len(freqs))]


@pytest.fixture(scope="module")
def scene():
    """30 s of a mixed scene with a melody over it (a note every 1.5 s, so
    the tracker re-warms on notes across the segment boundaries)."""
    x = gen.mixed_scene(30.0, SR, seed=5)
    notes = [220.0, 261.63, 329.63, 392.0, 293.66, 246.94]
    for k in range(20):
        tone = gen.tone_with_harmonics(notes[k % 6], 1.2, SR, harmonics=6,
                                       amplitude=0.25)
        lo = int(k * 1.5 * SR)
        x[lo:lo + len(tone)] += tone[:len(x) - lo]
    return x


def test_floor_warmup_matches_jax_and_full(scene):
    n = num_frames(len(scene), 2048, 512)
    got = tseg.segmented_pitch_analysis(scene, SR, warmup_mode="floor",
                                        device="cpu", **KW)
    full = tseg.segmented_pitch_analysis(scene, SR, device="cpu", **KW)
    want = jseg.segmented_pitch_analysis(scene, SR, warmup_mode="floor",
                                         **KW)
    assert got[0].shape == (n, 8)
    assert frame_sets(got[0], got[2]) == frame_sets(full[0], full[2])
    # Against JAX: the same notes in every frame, their frequencies within
    # 1e-4 (a 0.1 Hz rounding may straddle: measured one frame, 498.15 Hz).
    np.testing.assert_array_equal(got[2].sum(1), want[2].sum(1))
    np.testing.assert_allclose(np.sort(np.where(got[2], got[0], 0), 1),
                               np.sort(np.where(want[2], want[0], 0), 1),
                               rtol=1e-4)
    first = 128 + 64
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a[:first], b[:first])
    assert got[2].any(1).sum() > n // 4


def test_floor_warmup_short_audio_falls_back():
    """Segments too short for a whole look-back fall back to "full"."""
    x = gen.mixed_scene(4.0, SR, seed=2)
    got = tseg.segmented_pitch_analysis(x, SR, warmup_mode="floor",
                                        device="cpu")
    full = tseg.segmented_pitch_analysis(x, SR, device="cpu")
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="warmup_mode"):
        tseg.segmented_pitch_analysis(x, SR, warmup_mode="half", device="cpu")


def test_floor_warmup_frames_matches_jax(scene):
    """The STFT + floor scan alone over 3 streams x 40 frames: the port's
    floor state against JAX's within 5e-4 of each leaf's largest value
    (the GEMMs' order, compounded by the recurrence; measured 1.1e-4 on
    the volatility)."""
    streams = np.stack([scene[i * 200000:i * 200000 + 39 * 512 + 2048]
                        for i in range(3)])
    half = 1025
    gf = np.full((3, 40), np.float32(tnf.global_floor_linear(-96.0, half)))
    st = tanalyzer.floor_warmup_frames(
        tnf.init_state(half, "cpu", (3,)),
        frame_signal(torch.from_numpy(streams), 2048, 512),
        torch.from_numpy(gf), SR)
    for i in range(3):
        jst = janalyzer.floor_warmup_frames(
            jnf.init_state(half),
            jnp.asarray(np.stack([streams[i, k * 512:k * 512 + 2048]
                                  for k in range(40)])),
            jnp.asarray(gf[i]), SR)
        for a, b in zip(st, jst):
            b = np.asarray(b)
            scale = float(np.abs(b).max()) if b.dtype != bool else 0.0
            np.testing.assert_allclose(a[i].numpy(), b, rtol=0,
                                       atol=5e-4 * scale)


def test_floor_warmup_differs_where_jax_differs():
    """"floor" is not bitwise to "full": on the 30-minute scene
    (mixed_scene(1800 s, seed=0), 128 segments) the stable sets differ on
    frame 13,781, 53 frames into a floor segment after its 32-frame
    tracker re-warm.  The JAX package's two modes differ there, and the
    port's differ on the same frames.  Run on the scene's first 14,400
    frames with 12 segments: a plan whose segment lengths, and so the
    segments around that frame, are the 30-minute run's (asserted).  The
    scene draws its 10 s sections in order, so 180 s of it is a prefix of
    the 1,800 s scene."""
    tw = tseg.TRACKER_REWARM_FRAMES

    def plan(n_total, segments):
        full = tseg._plan_streams(n_total, segments, 128, 64, 2048, 512)
        base = -(-n_total // segments)
        return full.payload, full.stream_len, -(-(base + tw) // 64) * 64 - tw

    n_long = num_frames(int(round(1800.0 * SR)), 2048, 512)
    n = 14_400
    assert plan(n, 12) == plan(n_long, tseg.auto_segments(n_long, 128))
    x = gen.mixed_scene(180.0, SR, seed=0)[:(n - 1) * 512 + 2048]

    def differ(floor, full):
        return [i for i, (a, b) in enumerate(zip(frame_sets(floor[0], floor[2]),
                                                 frame_sets(full[0], full[2])))
                if a != b]
    want = differ(*(jseg.segmented_pitch_analysis(x, SR, segments=12,
                                                  warmup_mode=m)
                    for m in ("floor", "full")))
    got = differ(*(tseg.segmented_pitch_analysis(x, SR, segments=12,
                                                 warmup_mode=m, device="cpu")
                   for m in ("floor", "full")))
    assert want == [13781]
    assert got == want
