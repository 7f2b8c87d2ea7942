"""PyTorch port, the offline analysis API (`analyze_buffer`,
`analyze_buffer_segmented`), the feature pack and YIN against the JAX
package.

Tolerances:
- `feature_pack` on the same frames and magnitudes: rms, energy, centroid
  and flux within rtol 1e-5 (float32 sums in another order); the rolloff
  bin, an argmax over a cumsum whose order differs between XLA and torch,
  within one bin, and measured exact on this input;
- `yin_pitch` on the same frames: voiced equal, f0 within rtol 1e-4 (FFT
  autocorrelation through torch.fft against jnp.fft);
- the API on the 2 s tone + click of tests/test_analysis_api.py: frame
  counts, onset frames and stable_valid equal; stable freqs within rtol
  1e-5; the spectrogram within 1e-5 of its peak (torch.fft against
  jnp.fft), and so the flux (a difference of near-equal spectra on a
  steady tone) within 1e-5 of the spectrogram's peak; the other stateless
  columns within the tolerances above.
The port's own contract, as tests/test_analysis_api.py states it for the
JAX package: the segmented path's stateless columns equal the
sequential's bit for bit, int16 input equals its float32 scaling, empty
input gives empty columns.
"""

import numpy as np
import pytest
import torch

import audio_analyzer_rs_tpu as jaat
import jax.numpy as jnp
from audio_analyzer_rs_tpu.ops import features as jfeat
from audio_analyzer_rs_tpu.ops import yin as jyin
from audio_analyzer_rs_tpu.utils.framing import frame_signal as jframe
import audio_analyzer_rs_tpu_torch as aat
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import features, fft, yin
from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal

torch.set_num_threads(1)

SR = 44100.0
W, HOP = 2048, 512
STATELESS = ("time_s", "rms", "energy", "centroid_hz", "rolloff_hz", "flux",
             "yin_f0_hz", "yin_voiced", "spectrogram")


def _probe(seconds=1.0):
    x = gen.tone_with_harmonics(196.0, seconds, SR, harmonics=6,
                                amplitude=0.4)
    rng = np.random.default_rng(4)
    return (x + rng.standard_normal(len(x)).astype(np.float32) * 0.01
            ).astype(np.float32)


def _tone_click():
    """tests/test_analysis_api.py's 2 s tone with a click at 1.1 s."""
    x = gen.tone_with_harmonics(220.0, 2.0, SR, harmonics=8, amplitude=0.4)
    click = gen.calibration_click(SR, volume=0.6)
    x[int(1.1 * SR):int(1.1 * SR) + len(click)] += click
    return x


@pytest.fixture(scope="module")
def api():
    x = _tone_click()
    return dict(
        x=x,
        jseq=jaat.analyze_buffer(x, SR, as_arrays=True),
        jseg=jaat.analyze_buffer_segmented(x, SR, segments=4,
                                           feature_chunk_frames=32),
        seq=aat.analyze_buffer(x, SR, as_arrays=True, device="cpu"),
        seg=aat.analyze_buffer_segmented(x, SR, segments=4,
                                         feature_chunk_frames=32,
                                         device="cpu"))


def test_feature_pack_matches_jax():
    x = _probe()
    frames = np.array(jframe(jnp.asarray(x), W, HOP))
    mags = np.abs(np.fft.rfft(frames * fft.hann_window(W), axis=-1)
                  ).astype(np.float32)
    ref = jfeat.feature_pack(jnp.asarray(frames), jnp.asarray(mags), SR, W)
    got = features.feature_pack(torch.from_numpy(frames),
                                torch.from_numpy(mags), SR, W)
    for name in ("rms", "energy", "centroid_hz", "flux"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5,
                                   err_msg=name)
    bin_hz = np.float32(SR / W)
    diff = np.abs(got.rolloff_hz.numpy() - np.asarray(ref.rolloff_hz))
    assert (diff <= bin_hz).all()
    np.testing.assert_array_equal(got.rolloff_hz.numpy(),
                                  np.asarray(ref.rolloff_hz))
    db = features.rms_db(got.rms).numpy()
    np.testing.assert_allclose(db, np.asarray(jfeat.rms_db(
        jnp.asarray(got.rms.numpy()))), rtol=1e-6)


def test_yin_matches_jax():
    x = _probe()
    frames = np.array(jframe(jnp.asarray(x), W, HOP))
    ref = jyin.yin_pitch(jnp.asarray(frames), SR)
    got = yin.yin_pitch(torch.from_numpy(frames), SR)
    np.testing.assert_array_equal(got.voiced.numpy(), np.asarray(ref.voiced))
    assert got.voiced.all()
    np.testing.assert_allclose(got.f0_hz.numpy(), np.asarray(ref.f0_hz),
                               rtol=1e-4)
    np.testing.assert_allclose(got.f0_hz.numpy(), 196.0, rtol=0.01)
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(ref.confidence), atol=1e-4)


def test_rfft_complex_and_irfft():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    for backend in ("fft", "dft"):
        re, im = fft.rfft_complex(torch.from_numpy(x), backend)
        assert re.shape == im.shape == (3, 129)
        np.testing.assert_allclose(re.numpy(), ref.real, atol=1e-4)
        np.testing.assert_allclose(im.numpy(), ref.imag, atol=1e-4)
        back = fft.irfft(re, im).numpy()
        np.testing.assert_allclose(back, x, atol=1e-5)
    with pytest.raises(ValueError):
        fft.rfft_complex(torch.from_numpy(x), "pallas")


def _assert_columns_close(got, ref):
    assert len(got.rms) == len(ref.rms)
    np.testing.assert_array_equal(got.time_s, ref.time_s)
    peak = float(np.abs(ref.spectrogram).max())
    np.testing.assert_allclose(got.spectrogram, ref.spectrogram, rtol=0,
                               atol=1e-5 * peak)
    for name in ("rms", "energy", "centroid_hz"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # The flux of a steady tone is a difference of near-equal spectra, so
    # it is held to the spectrogram's absolute tolerance.
    np.testing.assert_allclose(got.flux, ref.flux, rtol=0, atol=1e-5 * peak)
    assert (np.abs(got.rolloff_hz - ref.rolloff_hz) <= SR / W).all()
    np.testing.assert_array_equal(got.yin_voiced, ref.yin_voiced)
    np.testing.assert_allclose(got.yin_f0_hz, ref.yin_f0_hz, rtol=1e-4)
    np.testing.assert_array_equal(got.stable_valid, ref.stable_valid)
    v = ref.stable_valid
    assert v.any()
    np.testing.assert_allclose(got.stable_freqs[v], ref.stable_freqs[v],
                               rtol=1e-5)
    assert [o["frame"] for o in got.onsets] == \
        [o["frame"] for o in ref.onsets]
    assert got.onsets, "the click gives an onset"


def test_analyze_buffer_matches_jax(api):
    got, ref = api["seq"], api["jseq"]
    _assert_columns_close(got, ref)
    np.testing.assert_array_equal(got.raw_valid, ref.raw_valid)


def test_analyze_buffer_segmented_matches_jax(api):
    got, ref = api["seg"], api["jseg"]
    _assert_columns_close(got, ref)
    assert got.raw_freqs.shape == (0, 8)


def test_segmented_stateless_columns_equal_sequential(api):
    """The port's own contract: the bulk path's stateless columns (flux
    across the 32-frame feature chunks included) are the sequential path's
    bits; its stable pitches and onsets the same decisions."""
    seq, seg = api["seq"], api["seg"]
    assert len(seq.rms) > 64
    for name in STATELESS:
        np.testing.assert_array_equal(getattr(seg, name), getattr(seq, name),
                                      err_msg=name)
    np.testing.assert_array_equal(seg.stable_valid, seq.stable_valid)
    np.testing.assert_allclose(seg.stable_freqs, seq.stable_freqs, rtol=1e-5,
                               atol=1e-3)
    assert [o["frame"] for o in seg.onsets] == \
        [o["frame"] for o in seq.onsets]


def test_structs_int16_and_empty():
    x = _probe(0.6)
    arr = aat.analyze_buffer(x, SR, as_arrays=True, device="cpu")
    res = aat.analyze_buffer(x, SR, device="cpu")
    assert len(res.frames) == len(arr.rms) == res.spectrogram.shape[0]
    f = res.frames[len(res.frames) // 2]
    assert f.yin_voiced and abs(f.yin_f0_hz - 196.0) < 3.0
    for i in (0, len(res.frames) - 1):
        assert np.float32(res.frames[i].rms) == arr.rms[i]
        assert [p for p, _ in res.frames[i].stable_pitches] == \
            [float(p) for p in arr.stable_freqs[i][arr.stable_valid[i]]]
    assert isinstance(res.to_dicts()[0]["pitches"], list)

    i16 = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    f32 = i16.astype(np.float32) / np.float32(32768.0)
    a = aat.analyze_buffer(f32, SR, as_arrays=True, device="cpu")
    b = aat.analyze_buffer(i16, SR, as_arrays=True, device="cpu")
    c = aat.analyze_buffer_segmented(i16, SR, device="cpu")
    np.testing.assert_array_equal(a.rms, b.rms)
    np.testing.assert_array_equal(a.stable_freqs, b.stable_freqs)
    assert a.onsets == b.onsets
    np.testing.assert_array_equal(c.rms, a.rms)

    for empty in (aat.analyze_buffer(np.zeros(100, np.float32), SR,
                                     as_arrays=True, device="cpu"),
                  aat.analyze_buffer_segmented(np.zeros(100, np.float32), SR,
                                               device="cpu")):
        assert empty.rms.shape == (0,)
        assert empty.spectrogram.shape == (0, W // 2 + 1)
    short = aat.analyze_buffer(np.zeros(100, np.float32), SR, device="cpu")
    assert short.frames == [] and short.onsets == []


def test_package_exports():
    for name in ("analyze_buffer", "analyze_buffer_segmented",
                 "AnalysisResult", "AnalysisArrays", "FrameFeatures",
                 "segmented_pitch_analysis", "segmented_onset_analysis",
                 "segmented_pitch_analysis_batch",
                 "segmented_onset_analysis_batch", "PitchAnalyzer",
                 "OnsetAnalyzer", "AudioEngine", "MusicalTransport",
                 "decode_file", "encode_file", "decode_available"):
        assert getattr(aat, name) is not None
    from audio_analyzer_rs_tpu_torch.api.engine import AudioEngine
    from audio_analyzer_rs_tpu_torch.api.pool import EnginePool
    assert aat.AudioEngine is AudioEngine
    assert aat.EnginePool is EnginePool
    with pytest.raises(AttributeError):
        aat.NoSuchExport


def test_features_on_the_fft_backend_spectrum():
    """feature_pack on the port's own windowed magnitudes (the path the
    API takes) stays within the same tolerances of JAX's."""
    x = _probe(0.5)
    f = frame_signal(torch.from_numpy(x), W, HOP)
    mags = windowed_mags(f, W, "fft")
    got = features.feature_pack(f, mags, SR, W)
    jf = jframe(jnp.asarray(x), W, HOP)
    from audio_analyzer_rs_tpu.ops.stft import windowed_mags as jmags
    ref = jfeat.feature_pack(jf, jmags(jf, W), SR, W)
    for name in ("rms", "energy", "centroid_hz", "flux"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5,
                                   err_msg=name)
