"""benchmark/work.py against counts worked by hand for the three cells."""

from __future__ import annotations

import pytest

import work

# The full chain at 48 kHz over 468 slots of 1,024 samples: 933 pitch
# frames (window 2,048, hop 512), 7,485 onset frames (256, 64); the pitch
# band 427 bins (kc = floor(10,000 / 23.4375) = 426).  A stream reads its
# 479,232 samples (1,916,928 bytes), writes 933 x 8 notes x 5 bytes +
# 7,485 frames x 5 bytes + 468 levels x 4 = 76,617 bytes, and reads and
# writes 6,912 state words (10 + 5,261 + 1,282 + 97 + 262) = 55,296 bytes.
# Flops: 933 x (56,320 + 2,048 + 1,708) + 7,485 x (5,120 + 256 + 516).
CHAIN_BYTES = 1_916_928 + 76_617 + 55_296
CHAIN_FLOPS = 933 * 60_076 + 7_485 * 5_892


@pytest.mark.parametrize("streams", [128, 2048])
def test_full_step(streams):
    w = work.full_step(streams, 479_232, 48000.0)
    assert w.bytes == CHAIN_BYTES * streams
    assert w.flops == CHAIN_FLOPS * streams
    assert w.bound_s() == pytest.approx(CHAIN_FLOPS * streams / 67e12)
    if streams == 128:
        assert w.bytes == 262_251_648
        assert w.flops == 12_819_523_584
        assert w.bound_s() == pytest.approx(191.336e-6, rel=1e-4)


def test_segmented_pitch_30_min():
    # 79,380,000 samples at 44.1 kHz; 155,036 frames out; 128 segments x
    # 1,344 frames analysed; the band 465 bins (kc = 464).
    w = work.segmented_pitch(79_380_000, 128 * 1344, 155_036, 44100.0)
    assert w.bytes == 79_380_000 * 4 + 155_036 * 8 * 9 == 328_682_592
    assert w.flops == 172_032 * (56_320 + 2_048 + 4 * 465)
    assert w.bound_s() == pytest.approx(10_361_143_296 / 67e12)


def test_frames_and_bands():
    assert work.num_frames(479_232, 2048, 512) == 933
    assert work.num_frames(479_232, 256, 64) == 7485
    assert work.num_frames(2047, 2048, 512) == 0
    assert work.candidate_band(48000.0, 2048) == 427
    assert work.candidate_band(44100.0, 2048) == 465
    assert work.rfft_flops(2048) == 56_320
    assert work.rfft_flops(256) == 5_120


def test_bound_takes_the_larger_side():
    assert work.Work(3.35e12, 0).bound_s() == pytest.approx(1.0)
    assert work.Work(0, 67e12).bound_s() == pytest.approx(1.0)
    assert (work.Work(1, 2) + work.Work(3, 4)) == work.Work(4, 6)
