"""K11 (ops/hopper_rfft.py, csrc/rfft_mag.cu): the windowed real-FFT
magnitude in one fixed order of operations a frame.

On the CPU the kernel cannot run, so its operation sequence is held here in
two numpy forms: `rfft_mag_fixed_np` (vectorized over frames: what the card
tests hold K11 to bit for bit) and `kernel_plan_np` below, the kernel's own
loops (threads, register groups, passes of five stages, the padded frame
buffer) transcribed line for line.  Tolerances:
- against the float64 oracle: the spectral gate, rel MSE < 1e-6;
- against torch.fft (the plain version) and JAX's jnp.fft: max |Δ| <= 1e-5
  of the frame's peak magnitude (two float32 FFTs, summed in other orders;
  measured ~1e-6);
- between the two numpy forms, and a frame alone against it in any batch:
  bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu.ops import fft as jfft
from audio_analyzer_rs_tpu_torch import _build
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.ops import fft as tfft
from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
from audio_analyzer_rs_tpu_torch.ops import stft as tstft
from audio_analyzer_rs_tpu_torch.utils import framing

torch.set_num_threads(1)

SR = 44100.0
HOPS = {256: 64, 2048: 512}
PEAK_TOL = 1e-5


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r = (r << 1) | ((x >> i) & 1)
    return r


def _pad(p: int) -> int:
    return p + (p >> 5)


def kernel_plan_np(frames, band=None, window=None, rr=32):
    """csrc/rfft_mag.cu's loops in numpy, over [N, W] frames, `rr` values a
    thread (the kernel's two forms, 32 and 16): each thread t of a frame
    loads z[t + q·TPF], then each pass from stage s0 runs its stages group
    by group in registers (`stages`) and writes value q of group j to the
    padded buffer at (j >> s0)·Ns0·R + (j mod Ns0) + Ns0·bitrev(q)
    (`fft_passes`); the epilogue reads Z[k], Z[M - k] from the buffer
    (`magnitude`)."""
    x = np.asarray(frames, np.float32)
    width = x.shape[-1]
    half = width // 2
    levels = half.bit_length() - 1
    band = hopper_rfft._band(width, band)
    win = np.ones(width, np.float32) if window is None else window
    stage, post = hopper_rfft.twiddles_np(width)
    rlog = rr.bit_length() - 1
    tpf = half // rr
    buf = np.zeros((len(x), half + half // 32, 2), np.float32)
    regs = []
    for t in range(tpf):
        m = t + np.arange(rr) * tpf
        regs.append([x[:, 2 * m] * win[2 * m], x[:, 2 * m + 1] * win[2 * m + 1]])
    s0 = 0
    while s0 < levels:
        rl = min(levels - s0, rlog)
        r = 1 << rl
        ns0 = 1 << s0
        groups = rr // r
        for t in range(tpf):
            vr, vi = regs[t]
            for g in range(groups):
                j = t + g * tpf
                if s0 > 0:
                    v = buf[:, [_pad(j + q * (half // r)) for q in range(r)]]
                    vr[:, g * r:(g + 1) * r] = v[..., 0]
                    vi[:, g * r:(g + 1) * r] = v[..., 1]
        for t in range(tpf):
            vr, vi = regs[t]
            for g in range(groups):
                c = (t + g * tpf) & (ns0 - 1)
                for s in range(rl):
                    hh = r >> (s + 1)
                    ns = ns0 << s
                    for blk in range(1 << s):
                        wr, wi = stage[ns - 1 + c + ns0 * _bitrev(blk, s)]
                        q = g * r + blk * 2 * hh + np.arange(hh)
                        br, bi = vr[:, q + hh], vi[:, q + hh]
                        tr = br * wr - bi * wi
                        ti = br * wi + bi * wr
                        ar, ai = vr[:, q], vi[:, q]
                        vr[:, q + hh], vi[:, q + hh] = ar - tr, ai - ti
                        vr[:, q], vi[:, q] = ar + tr, ai + ti
            for g in range(groups):
                j = t + g * tpf
                base = ((j >> s0) << (s0 + rl)) + (j & (ns0 - 1))
                for q in range(r):
                    p = _pad(base + (_bitrev(q, rl) << s0))
                    buf[:, p] = np.stack([vr[:, g * r + q],
                                          vi[:, g * r + q]], -1)
        s0 += rl
    k = np.arange(band)
    zk = buf[:, [_pad(i) for i in k % half]]
    zm = buf[:, [_pad(i) for i in (half - k) % half]]
    a, b, c, d = zk[..., 0], zk[..., 1], zm[..., 0], zm[..., 1]
    er, ei, o_r, o_i = a + c, b - d, b + d, c - a
    tr, ti = post[k, 0], post[k, 1]
    xr = er + (tr * o_r - ti * o_i)
    xi = ei + (tr * o_i + ti * o_r)
    big = np.fmax(np.abs(xr), np.abs(xi))
    tiny, huge = big < 2.0 ** -60, big > 2.0 ** 60
    up = np.where(tiny, np.float32(2.0 ** 100),
                  np.where(huge, np.float32(2.0 ** -100), np.float32(1.0)))
    back = np.where(tiny, np.float32(2.0 ** -101),
                    np.where(huge, np.float32(2.0 ** 99), np.float32(0.5)))
    xr, xi = xr * up, xi * up
    return np.sqrt(xr * xr + xi * xi) * back


def _scene(name: str, width: int, seconds: float = 0.5) -> np.ndarray:
    if name == "mixed":            # melody notes over a quiet bed
        return gen.mixed_scene(seconds, SR, seed=11)
    if name == "harmonic":
        return gen.tone_with_harmonics(220.0, seconds, SR, harmonics=8,
                                       amplitude=0.5)
    # A noise bed at silence level: the Hann window's products fall below
    # 2^-126.
    return (gen.mixed_scene(seconds, SR, seed=4)
            * np.float32(2.0 ** -120)).astype(np.float32)


def _frames(x: np.ndarray, width: int) -> np.ndarray:
    return framing.frame_signal_np(x, width, HOPS[width])


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("width", [256, 2048])
@pytest.mark.parametrize("scene", ["mixed", "harmonic", "silence"])
def test_fixed_order_passes_the_spectral_gate(scene, width):
    x = _scene(scene, width)
    frames = _frames(x, width)
    hann = tfft.hann_window(width)
    got = hopper_rfft.rfft_mag_fixed_np(frames, window=hann)
    oracle = tstft.stft_mags_np(x, width, HOPS[width])
    rel = np.mean((got - oracle) ** 2) / np.mean(oracle ** 2)
    assert rel < tstft.FIDELITY_MAX_REL_MSE, rel
    # The same against the bare-frame oracle, with the window applied first.
    bare = tfft.rfft_mag_np(frames * hann)
    assert np.mean((got - bare) ** 2) / np.mean(bare ** 2) < 1e-6
    if scene == "silence":
        prods = frames * hann
        assert ((prods != 0) & (np.abs(prods) < 2.0 ** -126)).any()
        assert got.max() < 2.0 ** -60      # the scaled path ran


@pytest.mark.parametrize("width", [256, 2048])
def test_fixed_order_near_torch_fft_and_jax(width):
    frames = _frames(_scene("mixed", width), width)
    hann = tfft.hann_window(width)
    got = hopper_rfft.rfft_mag_fixed_np(frames, window=hann)
    plain = hopper_rfft.rfft_mag_plain(torch.from_numpy(frames), None,
                                       torch.from_numpy(hann)).numpy()
    ref = np.asarray(jfft.rfft_mag(jnp.asarray(frames * hann), backend="fft"))
    peak = np.abs(plain).max(-1, keepdims=True)
    for other in (plain, ref):
        assert (np.abs(got - other) <= PEAK_TOL * peak).all(), \
            float((np.abs(got - other) / peak).max())


@pytest.mark.parametrize("rr", [16, 32])
@pytest.mark.parametrize("width", hopper_rfft.widths())
def test_kernel_plan_is_the_fixed_order(width, rr):
    """The kernel's threads, groups, passes and padded buffer give the
    transcription's bits, at every width it takes, in both its forms."""
    rng = np.random.default_rng(width)
    frames = rng.standard_normal((3, width)).astype(np.float32)
    frames[1] *= np.float32(2.0 ** -130)     # subnormal samples
    win = tfft.hann_window(width)
    for window in (win, None):
        assert _same_bits(kernel_plan_np(frames, None, window, rr),
                          hopper_rfft.rfft_mag_fixed_np(frames, None, window))
    assert _same_bits(kernel_plan_np(frames, 7, win, rr),
                      hopper_rfft.rfft_mag_fixed_np(frames, 7, win))


@pytest.mark.parametrize("width", hopper_rfft.widths())
def test_twiddles_are_the_float64_formula_rounded(width):
    stage, post = hopper_rfft.twiddles_np(width)
    half = width // 2
    # ops/fft.py `_rdft_trig`'s formula at t = 1, in float64, rounded.
    ang = 2.0 * np.pi * np.float64(1.0) * np.arange(half + 1.0) / width
    assert _same_bits(post[:, 0], np.cos(ang))
    assert _same_bits(post[:, 1], -np.sin(ang))
    if width == 2048:                        # the pitch window's own table
        trig = tfft._rdft_trig(width)
        assert _same_bits(post[:, 0], trig[1, 0::2])
        assert _same_bits(post[:, 1], trig[1, 1::2])
    levels = half.bit_length() - 1
    for s in range(levels):
        ns = 1 << s
        ang = np.pi * np.arange(ns, dtype=np.float64) / ns
        assert _same_bits(stage[ns - 1:2 * ns - 1, 0], np.cos(ang))
        assert _same_bits(stage[ns - 1:2 * ns - 1, 1], -np.sin(ang))
    table = hopper_rfft.twiddle_table(width, torch.device("cpu")).numpy()
    assert table.shape == (2 * half + 1, 2)
    assert _same_bits(table, np.concatenate([stage, post]))


def test_rows_keep_their_bits_in_any_batch():
    rng = np.random.default_rng(5)
    for width in (256, 2048):
        frames = _frames(_scene("mixed", width), width)
        win = tfft.hann_window(width)
        full = hopper_rfft.rfft_mag_fixed_np(frames, window=win)
        perm = rng.permutation(len(frames))
        assert _same_bits(hopper_rfft.rfft_mag_fixed_np(frames[perm],
                                                        window=win),
                          full[perm])
        extra = np.concatenate([frames[:5], rng.standard_normal(
            (9, width)).astype(np.float32), frames[5:]])
        got = hopper_rfft.rfft_mag_fixed_np(extra, window=win)
        assert _same_bits(np.concatenate([got[:5], got[14:]]), full)
        for i in (0, len(frames) // 2, len(frames) - 1):
            assert _same_bits(hopper_rfft.rfft_mag_fixed_np(
                frames[i:i + 1], window=win)[0], full[i])


def test_band_slices_and_strided_views():
    x = torch.from_numpy(_scene("mixed", 2048))
    view = framing.frame_signal(torch.stack([x, x.flip(0)]), 2048, 512)
    assert view.stride()[-2:] == (512, 1)     # an unfold view, read in place
    copy = view.contiguous().numpy()
    win = tfft.hann_window(2048)
    full = hopper_rfft.rfft_mag_fixed_np(view.numpy(), window=win)
    assert _same_bits(full, hopper_rfft.rfft_mag_fixed_np(copy, window=win))
    assert full.shape == copy.shape[:-1] + (1025,)
    assert _same_bits(hopper_rfft.rfft_mag_fixed_np(copy, 465, win),
                      full[..., :465])
    assert _same_bits(hopper_rfft.rfft_mag_fixed_np(copy, 5000, win), full)
    f3, band = hopper_rfft.check_args(view, 465, torch.from_numpy(win))
    assert f3.data_ptr() == view.data_ptr() and band == 465
    assert hopper_rfft.check_args(view[0, 0], None, None)[0].shape == \
        (1, 1, 2048)


@pytest.mark.parametrize("width,band", [(256, None), (2048, 465)])
def test_cpu_path_is_torch_fft(width, band):
    frames = framing.frame_signal(torch.from_numpy(_scene("mixed", width)),
                                  width, HOPS[width])
    hann = tfft.hann(width, torch.device("cpu"))
    want = torch.fft.rfft(frames * hann, dim=-1).abs()
    want = want if band is None else want[..., :band]
    assert _same_bits(tstft.windowed_mags(frames, width, "fft", band), want)
    bare = torch.fft.rfft(frames, dim=-1).abs()
    assert _same_bits(tfft.rfft_mag(frames, "fft"), bare)
    assert _same_bits(tfft.rfft_mag(frames, "fft", band=7), bare[..., :7])


def _args():
    return torch.zeros((2, 3, 256)), None, torch.ones(256)


@pytest.mark.parametrize("case", ["dtype", "width_odd", "width_small",
                                  "width_large", "window", "band",
                                  "stride"])
def test_wrapper_refuses(case):
    frames, band, window = _args()
    err = ValueError
    if case == "dtype":
        frames, err = frames.double(), TypeError
    elif case == "width_odd":
        frames, window = torch.zeros((2, 3, 300)), None
    elif case == "width_small":
        frames, window = torch.zeros((2, 3, 32)), None
    elif case == "width_large":
        frames, window = torch.zeros((1, 1, 8192)), None
    elif case == "window":
        window = torch.ones(128)
    elif case == "band":
        band = 0
    elif case == "stride":
        frames = torch.zeros((2, 256, 3)).transpose(1, 2)
    with pytest.raises(err):
        hopper_rfft.check_args(frames, band, window)
    with pytest.raises(ValueError):
        hopper_rfft.rfft_mag_fixed_np(np.zeros((2, 1000), np.float32))


def test_no_fallback_off_the_cpu(monkeypatch):
    frames, _, window = _args()
    with pytest.raises(ValueError, match="unsupported device"):
        hopper_rfft.rfft_mag(frames.to("meta"), None, window.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tstft.windowed_mags(frames.to("meta"), 256, "fft")

    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "lib", missing)
    before = hopper_rfft.LAUNCHES
    f3, band = hopper_rfft.check_args(frames, None, window)
    with pytest.raises(RuntimeError, match="nvcc"):
        hopper_rfft._launch(f3, band, window, torch.empty((2, 3, band)))
    assert hopper_rfft.LAUNCHES == before
