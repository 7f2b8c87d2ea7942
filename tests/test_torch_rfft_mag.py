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


def kernel_plan_np(frames, band=None, window=None, rr=32, per_row=None,
                   fpw=None):
    """csrc/rfft_mag.cu's loops in numpy, over [N, W] frames, `rr` values a
    thread (the kernel's two forms, 32 and 16).  A group of G = max(32,
    TPF) threads owns FPG = G / TPF frame slots and its padded buffer, and
    takes fpw <= FPG frames a batch (default FPG; thread tg: frame slot
    tg / TPF, t = tg mod TPF; slots from fpw on run zeros); the batches
    (every
    batch at once here, an axis of the arrays: a batch's values do not
    depend on which group takes it) go: the raw loads of z[t + q·TPF]
    (`load_raw`), the window product, each pass from stage s0 running its
    stages register group by register group and writing value q of group j
    to (j >> s0)·Ns0·R + (j mod Ns0) + Ns0·bitrev(q) (`fft_passes`); then
    the epilogue, thread tg writing elements tg + G·i of the batch's run
    of rows × band floats, its (row, bin) stepped by G = qb·band + rb
    (`bin_of`); and, with `per_row`, each frame r·per_row of the batch at
    full width → out [N, band] (and first [N / per_row, W/2 + 1])."""
    x = np.asarray(frames, np.float32)
    n, width = x.shape
    half = width // 2
    levels = half.bit_length() - 1
    band = hopper_rfft._band(width, band)
    win = np.ones(width, np.float32) if window is None else window
    stage, post = hopper_rfft.twiddles_np(width)
    rlog = rr.bit_length() - 1
    tpf = half // rr
    g_threads = max(32, tpf)
    fpg = g_threads // tpf
    fpw = fpg if fpw is None else fpw
    mp = half + half // 32
    batches = -(-n // fpw)
    # Frame slot f < fpw of batch b is frame b·fpw + f; zeros past n and
    # in the slots from fpw on.
    xb = np.zeros((batches, fpg, width), np.float32)
    xw = np.zeros((batches * fpw, width), np.float32)
    xw[:n] = x
    xb[:, :fpw] = xw.reshape(batches, fpw, width)
    gbuf = np.zeros((batches, fpg * mp, 2), np.float32)
    regs = []
    for tg in range(g_threads):
        f, t = tg // tpf, tg % tpf
        m = t + np.arange(rr) * tpf
        vr, vi = xb[:, f, 2 * m].copy(), xb[:, f, 2 * m + 1].copy()
        regs.append([vr * win[2 * m], vi * win[2 * m + 1]])
    s0 = 0
    while s0 < levels:
        rl = min(levels - s0, rlog)
        r = 1 << rl
        ns0 = 1 << s0
        groups = rr // r
        for tg in range(g_threads):
            fb, t = (tg // tpf) * mp, tg % tpf
            vr, vi = regs[tg]
            for g in range(groups):
                j = t + g * tpf
                if s0 > 0:
                    v = gbuf[:, [fb + _pad(j + q * (half // r))
                                 for q in range(r)]]
                    vr[:, g * r:(g + 1) * r] = v[..., 0]
                    vi[:, g * r:(g + 1) * r] = v[..., 1]
        for tg in range(g_threads):
            fb, t = (tg // tpf) * mp, tg % tpf
            vr, vi = regs[tg]
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
        for tg in range(g_threads):
            fb, t = (tg // tpf) * mp, tg % tpf
            vr, vi = regs[tg]
            for g in range(groups):
                j = t + g * tpf
                base = ((j >> s0) << (s0 + rl)) + (j & (ns0 - 1))
                for q in range(r):
                    p = fb + _pad(base + (_bitrev(q, rl) << s0))
                    gbuf[:, p] = np.stack([vr[:, g * r + q],
                                           vi[:, g * r + q]], -1)
        s0 += rl

    def bin_of(z0, k):
        """Bin k of each batch's frame at buffer offset z0 (`magnitude`)."""
        zk = gbuf[np.arange(batches), z0 + _pad(k & (half - 1))]
        zm = gbuf[np.arange(batches), z0 + _pad((half - k) & (half - 1))]
        a, b, c, d = zk[..., 0], zk[..., 1], zm[..., 0], zm[..., 1]
        er, ei, o_r, o_i = a + c, b - d, b + d, c - a
        tr, ti = post[k, 0], post[k, 1]
        xr = er + (tr * o_r - ti * o_i)
        xi = ei + (tr * o_i + ti * o_r)
        big = np.fmax(np.abs(xr), np.abs(xi))
        tiny, huge = big < 2.0 ** -60, big > 2.0 ** 60
        up = np.where(tiny, np.float32(2.0 ** 100),
                      np.where(huge, np.float32(2.0 ** -100),
                               np.float32(1.0)))
        back = np.where(tiny, np.float32(2.0 ** -101),
                        np.where(huge, np.float32(2.0 ** 99),
                                 np.float32(0.5)))
        xr, xi = xr * up, xi * up
        return np.sqrt(xr * xr + xi * xi) * back

    f0 = np.arange(batches) * fpw
    count = np.minimum(fpw, n - f0) * band
    dst = np.full((batches, fpw * band), np.nan, np.float32)
    qb, rb = g_threads // band, g_threads % band
    for tg in range(g_threads):
        row, k = tg // band, tg % band
        for idx in range(tg, fpw * band, g_threads):
            live = idx < count
            dst[live, idx] = bin_of(row * mp, k)[live]
            k += rb
            row += qb
            if k >= band:
                k -= band
                row += 1
    out = dst.reshape(-1, band)[:n]
    if per_row is None:
        return out
    first = np.full((n // per_row, half + 1), np.nan, np.float32)
    for bt in range(batches):
        rows = min(fpw, n - f0[bt])
        m = -(-f0[bt] // per_row) * per_row
        while m < f0[bt] + rows:
            for kk in range(half + 1):
                first[m // per_row, kk] = bin_of((m - f0[bt]) * mp, kk)[bt]
            m += per_row
    return out, first


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
    """The kernel's groups, threads, passes, padded buffers and epilogue
    give the transcription's bits, at every width it takes, in both its
    forms: full and banded (7 bins, fewer than a group's threads, and an
    odd band above them), with each outer row's first frame at full width
    beside the band; subnormal, huge, NaN and inf samples.  66 frames:
    several batches at every width, the last one partial where a group
    holds several frames, row starts inside and at the edges of batches.
    The 16-value form also with one and two frames a group's batch (a
    small call's)."""
    rng = np.random.default_rng(width + rr)
    frames = rng.standard_normal((66, width)).astype(np.float32)
    frames[1] *= np.float32(2.0 ** -130)     # subnormal samples
    frames[40] *= np.float32(2.0 ** 70)      # squares above float32's range
    frames[50, 3], frames[60, 7], frames[61, 2] = np.nan, np.inf, -np.inf
    win = tfft.hann_window(width)
    with np.errstate(invalid="ignore", over="ignore"):
        for window in (win, None):
            assert _same_bits(kernel_plan_np(frames, None, window, rr),
                              hopper_rfft.rfft_mag_fixed_np(frames, None,
                                                            window))
        fpg = max(32, width // 2 // rr) // (width // 2 // rr)
        thin = [f for f in (1, 2) if rr == 16 and f < fpg]
        for band, fpw in [(7, None), (width // 4 + 11, None)] + [
                (width // 4 + 11, f) for f in thin]:
            got, first = kernel_plan_np(frames, band, win, rr, per_row=11,
                                        fpw=fpw)
            assert _same_bits(got, hopper_rfft.rfft_mag_fixed_np(
                frames, band, win))
            assert _same_bits(first, hopper_rfft.rfft_mag_fixed_np(
                frames[::11], None, win))


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
