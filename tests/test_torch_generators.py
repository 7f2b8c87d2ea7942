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
