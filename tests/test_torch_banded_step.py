"""The full step's banded pitch STFT (parallel/sharding.py `pitch_mags`):
K11 writes the bins the extraction reads and each stream's first frame at
full width (`hopper_rfft.rfft_mag_first`), and the noise floor seeds a
fresh stream's state above the band from those first frames (`first` in
ops/noisefloor.py).  On the CPU every piece runs its plain version; each is
held bit for bit to the full-width composition it replaces: the same
operations on every bin that is read, so no tolerance.
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import hopper_rfft, noisefloor, pitch
from audio_analyzer_rs_tpu_torch.ops.fft import hann
from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
from audio_analyzer_rs_tpu_torch.parallel import sharding
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal

torch.set_num_threads(1)

SR = 48000.0
W, HOP, HALF = 2048, 512, 1025
KC48 = pitch.candidate_band(SR / W, HALF)                   # 426
KC44 = pitch.candidate_band(float(np.float32(44100.0) / np.float32(W)),
                            HALF)                           # 464
CPU = torch.device("cpu")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return [tree]


def _mags(s: int, n: int, seed: int):
    """The pitch STFT's magnitudes of s streams of a mixed scene, n frames
    each, full width, and per-frame global floors."""
    x = torch.from_numpy(np.stack([
        gen.mixed_scene((n - 1) * HOP / SR + 0.1, SR, seed=seed + i)
        [:(n - 1) * HOP + W] for i in range(s)]))
    mags = windowed_mags(frame_signal(x, W, HOP), W)
    rng = np.random.default_rng(seed)
    gf = torch.from_numpy(rng.uniform(1e-3, 0.05, (s, n)).astype(np.float32))
    return mags, gf


def _state(kind: str, s: int, seed: int) -> noisefloor.NoiseFloorState:
    """Fresh, initialized mid-stream, or mixed (every other stream fresh)."""
    if kind == "fresh":
        return noisefloor.init_state(HALF, CPU, (s,))
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(rng.uniform(0.0, 2.0, (s, HALF)).astype(
        np.float32)) for _ in range(3)]
    init = np.ones(s, bool) if kind == "initialized" else np.arange(s) % 2 == 0
    return noisefloor.NoiseFloorState(*leaves, torch.from_numpy(init))


@pytest.mark.parametrize("band", [KC48, KC44])
@pytest.mark.parametrize("kind", ["fresh", "initialized", "mixed"])
def test_floor_scan_with_first_frames_is_the_full_width_scan(kind, band):
    """The plain scan over magnitudes banded to band + 1 bins with each
    stream's first frame at full width: the effective floors and every
    state leaf across the full width bitwise the scan over full-width
    magnitudes (a fresh stream's tail seeded from its first frame)."""
    mags, gf = _mags(3, 9, seed=band)
    st0 = _state(kind, 3, seed=band + 1)
    want = noisefloor.noise_floor_scan(st0, mags, gf, band)
    banded = mags[..., :band + 1].contiguous()
    got = noisefloor.noise_floor_scan(st0, banded, gf, band,
                                      mags[:, 0].contiguous())
    for a, b in zip((got[1], *got[0]), (want[1], *want[0])):
        assert _same_bits(a, b)
    # Without its first frames a fresh stream's tail stays frozen.
    frozen = noisefloor.noise_floor_scan(st0, banded, gf, band)[0]
    fresh = ~st0.initialized
    assert _same_bits(frozen.floor[:, band:][fresh], st0.floor[:, band:][fresh])
    if kind != "initialized":
        assert not _same_bits(frozen.floor[:, band:][fresh],
                              want[0].floor[:, band:][fresh])


@pytest.mark.parametrize("shape", [(5, W), (3, 7, W)])
def test_rfft_mag_first_is_the_full_widths_slices(shape):
    """On CPU tensors `rfft_mag_first` is the plain full width's band and
    its frame 0 along the frame axis, bit for bit, and K11's numpy
    transcription gives the same split."""
    rng = np.random.default_rng(len(shape))
    frames = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    win = hann(W, CPU)
    full = hopper_rfft.rfft_mag_plain(frames, None, win)
    got, first = hopper_rfft.rfft_mag_first(frames, KC48 + 1, win)
    assert _same_bits(got, full[..., :KC48 + 1])
    assert _same_bits(first, full[..., 0, :])
    assert first.shape == shape[:-2] + (HALF,)
    fixed = hopper_rfft.rfft_mag_fixed_np(frames.numpy(), None, win.numpy())
    assert np.array_equal(
        hopper_rfft.rfft_mag_fixed_np(frames.numpy(), KC48 + 1, win.numpy()),
        fixed[..., :KC48 + 1])


def test_rfft_mag_first_refuses():
    with pytest.raises(ValueError, match="frame axis"):
        hopper_rfft.rfft_mag_first(torch.zeros(W))
    with pytest.raises(ValueError, match="frame axis"):
        hopper_rfft.rfft_mag_first(torch.zeros((2, 0, W)))
    with pytest.raises(ValueError, match="unsupported device"):
        hopper_rfft.rfft_mag_first(torch.zeros((2, 3, W), device="meta"))


def _full_width(frames, band):
    """The step's pitch STFT before the banding: all 1,025 bins, and no
    first frames (the floor seeds from the magnitudes' frame 0)."""
    return windowed_mags(frames, W), None


@pytest.mark.parametrize("b", [2, 3])
def test_banded_step_is_the_full_width_step(b, monkeypatch):
    """Two chained steps of `make_batched_full_step` on the CPU (chunks of
    6 slots: 9 pitch frames), then a third from the second's states with
    stream 1 made fresh again (a mixed batch): every output and state leaf
    bitwise the same step with full-width pitch magnitudes.  Stream 0 is
    silent in its first chunk."""
    t = 6 * 1024
    audio = np.stack([gen.mixed_scene(2 * t / SR + 0.05, SR, seed=30 + i)
                      [:2 * t] + gen.tone_with_harmonics(
                          196.0 * (i + 1), 2 * t / SR + 0.05, SR,
                          amplitude=0.3)[:2 * t]
                      for i in range(b)]).astype(np.float32)
    audio[0, :t] = 0.0
    step = sharding.make_batched_full_step(None, SR, device="cpu")

    def run():
        st = sharding.init_stream_states(b, device="cpu")
        outs = []
        for k in range(2):
            st, out = step(st, audio[:, k * t:(k + 1) * t])
            outs.append(out)
        nf = st.nf._replace(initialized=st.nf.initialized.clone())
        nf.initialized[1] = False
        st, out = step(st._replace(nf=nf), audio[:, t:])
        return outs + [out], st
    banded, st_banded = run()
    assert banded[0].stable_freqs.shape == (b, 9, 8)
    assert bool(banded[-1].stable_valid.any())
    monkeypatch.setattr(sharding, "pitch_mags", _full_width)
    full, st_full = run()
    for got, want in zip(banded, full):
        for name, x, y in zip(sharding.FullStepOut._fields, got, want):
            assert _same_bits(x, y), name
    for x, y in zip(_leaves(st_banded), _leaves(st_full)):
        assert _same_bits(x, y)
