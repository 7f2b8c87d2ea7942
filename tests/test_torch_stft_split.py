"""Kernel K1's 3xTF32 split (ops/hopper_stft.py), on the CPU.

The kernel multiplies TF32 parts on the tensor cores: each operand
x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi), and sums lo·hi +
hi·lo + hi·hi in FP32.  The table's split is built in Python by the wrapper,
so it is tested here:
- hi keeps 10 mantissa bits (its low 13 bits are zero), rounded to nearest
  with ties away from zero, and |x - hi - lo| <= 2^-21 |x|;
- the layout is [hi; lo] rows of [cols_pad, W], columns zero-padded to a
  multiple of 160, samples of each 32-sample slice in `K_ORDER`;
- a float64 emulation of the three split products stays within 1e-5 · max
  of `dft_mag_plain` and under the 1e-6 spectral gate.
"""

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import hopper_stft
from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
from audio_analyzer_rs_tpu_torch.ops.stft import (FIDELITY_MAX_REL_MSE,
                                                  stft_mags_np)
from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal

torch.set_num_threads(1)

SR = 44100.0
W, HOP = 2048, 512
CPU = torch.device("cpu")


def _rna_tf32_np(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, ties away from zero, via float64:
    the oracle for `tf32_round`."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)                       # |x| = m * 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)                # 11 significant bits
    return (np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
            ).astype(np.float32)


def test_tf32_round_is_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)
         ).astype(np.float32)
    bits = x.view(np.int32)
    ties = ((bits & ~0x1FFF) | 0x1000).view(np.float32)   # exact halfway
    x = np.concatenate([x, ties, -ties, np.float32([0.0, 1.0, -1.0])])
    got = hopper_stft.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_tf32_np(x))
    assert not (got.view(np.int32) & 0x1FFF).any()
    # Ties round away from zero in magnitude.
    n = len(ties)
    tie_got = got[20000:20000 + n]
    assert (np.abs(tie_got) > np.abs(ties)).all()


@pytest.fixture(scope="module")
def split():
    trig = rdft_trig(W, CPU)[:, :930]
    table, cols_pad = hopper_stft.split_table(trig)
    return trig, table, cols_pad


def test_split_table_layout(split):
    trig, table, cols_pad = split
    assert cols_pad == 960 and cols_pad % hopper_stft.COL_TILE == 0
    assert table.shape == (2 * cols_pad, W) and table.is_contiguous()
    hi, lo = table[:cols_pad], table[cols_pad:]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert not hi[930:].any() and not lo[930:].any()      # zero padding
    assert sorted(hopper_stft.K_ORDER) == list(range(hopper_stft.K_TILE))
    order = (np.arange(0, W, 32)[:, None] + hopper_stft.K_ORDER).reshape(-1)
    x = trig.T[:, order].double()                         # [930, W]
    err = (x - hi[:930].double() - lo[:930].double()).abs()
    assert bool((err <= 2.0 ** -21 * x.abs()).all())
    np.testing.assert_array_equal(hi[:930].numpy(),
                                  _rna_tf32_np(trig.T[:, order].numpy()))
    # Slot c of slice t is sample 32t + K_ORDER[c]: thread q of the kernel
    # finds its fragment samples 8q .. 8q+7 in slots {8s + q, 8s + q + 4}.
    for q in range(4):
        slots = [8 * s + q + 4 * j for s in range(4) for j in range(2)]
        assert sorted(hopper_stft.K_ORDER[slots]) == list(range(8 * q,
                                                                8 * q + 8))


def _split_mags64(frames, window, trig):
    """The kernel's arithmetic in float64: the Hann multiply in float32,
    both operands split to TF32 parts, lo·hi + hi·lo + hi·hi (lo·lo
    dropped), then the magnitude."""
    table, cols_pad = hopper_stft.split_table(trig)
    order = (np.arange(0, W, 32)[:, None] + hopper_stft.K_ORDER).reshape(-1)
    a = (frames * window)[..., order]
    a_hi = hopper_stft.tf32_round(a)
    a_lo = hopper_stft.tf32_round(a - a_hi)
    cols = trig.shape[1]
    b_hi = table[:cols].double().T
    b_lo = table[cols_pad:cols_pad + cols].double().T
    re_im = (a_lo.double() @ b_hi + a_hi.double() @ b_lo
             + a_hi.double() @ b_hi)
    re_im = re_im.reshape(re_im.shape[:-1] + (cols // 2, 2))
    return torch.sqrt(re_im[..., 0] ** 2 + re_im[..., 1] ** 2)


def test_split_products_match_plain_and_pass_the_gate():
    x = (gen.mixed_scene(0.6, SR, seed=2)
         + gen.tone_with_harmonics(220.0, 0.6, SR, harmonics=8,
                                   amplitude=0.4)).astype(np.float32)
    frames = frame_signal(torch.from_numpy(x), W, HOP)
    win = hann(W, CPU)
    band = rdft_trig(W, CPU)[:, :930]
    got = _split_mags64(frames, win, band)
    ref = hopper_stft.dft_mag_plain(frames, band, win).double()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())

    full = _split_mags64(frames, win, rdft_trig(W, CPU)).numpy()
    oracle = stft_mags_np(x, W, HOP)
    mse = float(np.mean((full - oracle) ** 2) / np.mean(oracle ** 2))
    assert mse < FIDELITY_MAX_REL_MSE, mse


def test_split_table_is_cached_per_table():
    base = rdft_trig(W, CPU).clone()
    first = hopper_stft._cached_split(base[:, :930])
    assert hopper_stft._cached_split(base[:, :930]) is first   # new view
    assert hopper_stft._cached_split(base[:, :2050]) is not first
    base[0, 0] += 1.0                                  # an in-place edit
    again = hopper_stft._cached_split(base[:, :930])
    assert again is not first
    assert not torch.equal(again[0], first[0])
