"""PyTorch port, the test-signal generators: bit-equal to the JAX package's."""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.models import generators as jgen
from audio_analyzer_rs_tpu_torch.models import generators as tgen

torch.set_num_threads(1)

SR = 44100.0


@pytest.mark.parametrize("duration,seed", [(40.0, 0), (20.0, 1), (7.3, 5)])
def test_mixed_scene_bit_equal(duration, seed):
    got = tgen.mixed_scene(duration, SR, seed=seed)
    ref = jgen.mixed_scene(duration, SR, seed=seed)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("freq,harmonics", [(220.0, 8), (523.25, 6),
                                            (9000.0, 6)])
def test_tone_with_harmonics_bit_equal(freq, harmonics):
    got = tgen.tone_with_harmonics(freq, 1.0, SR, harmonics=harmonics,
                                   amplitude=0.5)
    ref = jgen.tone_with_harmonics(freq, 1.0, SR, harmonics=harmonics,
                                   amplitude=0.5)
    np.testing.assert_array_equal(got, ref)


def test_noise_burst_bit_equal():
    np.testing.assert_array_equal(tgen.noise_burst(0.6, 20.0, SR, seed=997),
                                  jgen.noise_burst(0.6, 20.0, SR, seed=997))


def test_two_pi_equal():
    assert tgen.TWO_PI == jgen.TWO_PI


@pytest.mark.parametrize("freq,decay_ms,duration", [(1000.0, 30.0, None),
                                                    (2500.0, 50.0, 0.1),
                                                    (440.0, 12.5, 0.02)])
def test_tick_bit_equal(freq, decay_ms, duration):
    for sr in (SR, 48000.0):
        got = tgen.tick(freq, 0.7, decay_ms, sr, duration_s=duration)
        ref = jgen.tick(freq, 0.7, decay_ms, sr, duration_s=duration)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sr,volume,n", [(SR, 0.8, None), (48000.0, 0.6, None),
                                         (SR, 0.5, 700)])
def test_calibration_click_bit_equal(sr, volume, n):
    got = tgen.calibration_click(sr, volume=volume, n=n)
    ref = jgen.calibration_click(sr, volume=volume, n=n)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,args", [
    ("sine", (440.0, 0.5, SR)),
    ("sine", (261.63, 0.37, 48000.0, 0.3, 1.1)),
    ("sweep", (80.0, 4000.0, 0.8, SR)),
    ("sweep", (2000.0, 100.0, 0.25, 48000.0, 0.6)),
    ("silence", (0.73, SR)),
    ("adsr_envelope", (30000, SR, 0.01, 0.1, 0.6, 0.2, 9000)),
    ("adsr_envelope", (4000, 48000.0, 0.0, 0.0, 1.0, 0.0, 100)),
])
def test_signal_generator_bit_equal(name, args):
    got = getattr(tgen, name)(*args)
    ref = getattr(jgen, name)(*args)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
