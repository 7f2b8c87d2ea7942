"""PyTorch port, framing + STFT (kernel K1's module) against the JAX package.

Tolerances:
- framing and the constant tables (Hann, rDFT trig): exact;
- banded magnitudes: max |Δ| <= 1e-5 · max |ref| — the GEMM's summation
  order differs between XLA:CPU and torch (measured ~7e-7 of the max);
- both pass the float64 spectral gate, rel MSE < 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops import fft as jfft
from audio_analyzer_rs_tpu.ops import stft as jstft
from audio_analyzer_rs_tpu.ops.pallas_stft import windowed_mags_pallas
from audio_analyzer_rs_tpu.utils import framing as jframing
from audio_analyzer_rs_tpu_torch.ops import fft as tfft
from audio_analyzer_rs_tpu_torch.ops import hopper_stft
from audio_analyzer_rs_tpu_torch.ops import stft as tstft
from audio_analyzer_rs_tpu_torch.utils import framing as tframing

torch.set_num_threads(1)

SR = 44100.0
W, HOP = 2048, 512
BAND = 465          # candidate band kc + 1 at 44.1 kHz / 2048
REL_TOL = 1e-5


def _scene(seconds=1.6, seed=1):
    return gen.mixed_scene(seconds, SR, seed=seed)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [0, 100, 2047, 2048, 2049, 2048 + 513, 9000])
def test_num_frames_and_pad_match(n):
    assert tframing.num_frames(n, W, HOP) == jframing.num_frames(n, W, HOP)
    x = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(tframing.pad_to_frames(x, W, HOP),
                                  jframing.pad_to_frames(x, W, HOP))


def test_frame_signal_matches_and_is_a_view():
    x = _scene(0.5)
    xt = torch.from_numpy(x)
    ft = tframing.frame_signal(xt, W, HOP)
    fj = np.asarray(jframing.frame_signal(jnp.asarray(x), W, HOP))
    np.testing.assert_array_equal(ft.numpy(), fj)
    assert ft.data_ptr() == xt.data_ptr() and ft.stride() == (HOP, 1)


def test_constant_tables_bit_equal():
    np.testing.assert_array_equal(tfft.hann_window(W), jfft.hann_window(W))
    np.testing.assert_array_equal(
        tfft.rdft_trig(W, torch.device("cpu")).numpy(), jfft._rdft_trig(W))
    np.testing.assert_array_equal(tfft.hann(W, torch.device("cpu")).numpy(),
                                  jfft.hann_window(W))


def test_banded_dft_matches_jax():
    x = _scene()
    frames = jframing.frame_signal_np(x, W, HOP)
    win = jfft.hann_window(W)
    ref = np.asarray(jfft.rfft_mag(jnp.asarray(frames * win), backend="dft",
                                   band=BAND))
    got = tfft.rfft_mag(torch.from_numpy(frames * win), backend="dft",
                        band=BAND).numpy()
    assert got.shape == ref.shape == (len(frames), BAND)
    assert _max_rel(got, ref) <= REL_TOL
    got_w = tstft.windowed_mags(torch.from_numpy(frames), W, "dft",
                                BAND).numpy()
    ref_w = np.asarray(jstft.windowed_mags(jnp.asarray(frames), W,
                                           backend="dft", band=BAND))
    assert _max_rel(got_w, ref_w) <= REL_TOL


def test_windowed_mags_matches_pallas_stft_interpret():
    x = _scene(2.0, seed=4)
    frames = jframing.frame_signal_np(x, W, HOP)[:128]
    assert frames.shape == (128, W)
    ref = np.asarray(windowed_mags_pallas(jnp.asarray(frames), W,
                                          interpret=True))[:, :BAND]
    got = tstft.windowed_mags(torch.from_numpy(frames), W, "dft",
                              BAND).numpy()
    assert _max_rel(got, ref) <= REL_TOL


def test_fft_backend_matches_jax():
    x = _scene(0.6)
    frames = jframing.frame_signal_np(x, W, HOP)
    ref = np.asarray(jstft.windowed_mags(jnp.asarray(frames), W,
                                         backend="fft"))
    got = tstft.windowed_mags(torch.from_numpy(frames), W, "fft").numpy()
    assert _max_rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("backend", ["dft_band", "fft"])
def test_spectral_fidelity_gate(backend):
    probe = gen.tone_with_harmonics(220.0, 1.0, SR, harmonics=8,
                                    amplitude=0.5)
    mse = tstft.spectral_rel_mse(probe, W, HOP, backend, device="cpu")
    assert mse < tstft.FIDELITY_MAX_REL_MSE, mse
    ref = np.asarray(jstft.stft_mags(probe, W, HOP, backend=backend))
    oracle = jstft.stft_mags_np(probe, W, HOP)
    ref_mse = float(np.mean((ref - oracle) ** 2) / np.mean(oracle ** 2))
    assert ref_mse < tstft.FIDELITY_MAX_REL_MSE, ref_mse
    np.testing.assert_allclose(tstft.stft_mags_np(probe, W, HOP), oracle,
                               rtol=0, atol=0)


def test_k1_wrapper_takes_plain_version_on_cpu():
    x = _scene(0.4)
    frames = tframing.frame_signal(torch.from_numpy(x), W, HOP)[None]
    trig = tfft.rdft_trig(W, torch.device("cpu"))[:, :2 * BAND]
    win = tfft.hann(W, torch.device("cpu"))
    before = hopper_stft.LAUNCHES
    got = hopper_stft.dft_mag(frames, trig, win)
    assert hopper_stft.LAUNCHES == before
    torch.testing.assert_close(got, hopper_stft.dft_mag_plain(frames, trig,
                                                              win),
                               rtol=0, atol=0)
    assert got.shape == (1, frames.shape[1], BAND)
