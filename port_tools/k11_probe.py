#!/usr/bin/env python3
"""K11 (the windowed real-FFT magnitude, csrc/rfft_mag.cu) on one GPU: its
bits, its batch independence and its times.

    python3 port_tools/k11_probe.py [check] [--out F]
    python3 port_tools/k11_probe.py times [--out F]
    python3 port_tools/k11_probe.py turns --parent FILE [--out F]

`check`: builds csrc/ and prints ptxas's lines for `rfft_mag_kernel`; then
K11 through its wrappers bit for bit against `rfft_mag_fixed_np` (the
numpy transcription of its operation order) at every width it takes (64
to 4,096), in both its forms (16 values a thread: 66 frames, and just
below the switch; 32: enough frames for 8 warps an SM), on random frames
with a row of subnormal samples, a row scaled past 2^60 and NaN and inf
samples (NaNs compared by position), full width with Hann and rectangular windows, banded (7 bins,
an odd band, the full step's pitch band at 2,048) with each outer row's
first frame at full width (`rfft_mag_first`); at W = 256 and 2,048 on the
48 kHz `mixed_scene(seed=0)`, on random frames and on a silence-level
scene (products below 2^-126), 4 streams of each through unfold views
read with float2 and with scalar loads (an odd sample offset), full and
banded with the first frames; the float64 spectral gate (rel MSE < 1e-6)
and the plain version (torch.fft.rfft(frames x hann).abs(), cuFFT) within
1e-5 of each frame's peak; then each frame's bits in batches of 1, 33 and
128 streams at the full step's calls.

`times`: K11, and its plain version (which is the library call too), at
the shapes of `SHAPES` below, in turns (kernel, plain, kernel, plain),
each beside its bytes bound (each input sample read once, a stream's span,
and each magnitude written once, at 3.35 TB/s; the flops, ~2.5 W log2 W a
frame, at 67 TFLOP/s FP32 are below it at every shape) and the issue
floor of its fixed order (chip_smoke.py `k11_issue_ops`: one float32
instruction a product or sum, 128 lanes an SM a clock, at the SM clock
nvidia-smi samples while the launches run).  Times as chip_smoke.py takes
them: CUDA events around 10 back-to-back launches after a ~2 ms spin,
median of 20 samples.

`turns`: FILE, another rfft_mag.cu with the same `aat_rfft_mag` entry (an
earlier design, e.g. unpacked by `git archive <rev> audio_analyzer_rs_tpu_
torch/csrc | tar -x -C _proof/parent`), built alone by nvcc with the
port's flags (port_tools/kernel_turns.py `build`) and called through the
same wrapper, against the package's K11 at each shape: bitwise to each
other first, then timed in turns (parent, package, package, parent).  At
the banded shape the parent writes the band alone (its entry has no first
frames) and the package the band and the first frames; the parent's full
width at the pitch call is the step's call before the banding.

One JSON object a line; `--out` also writes them to a file.  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FULL_SR = 48000.0
# The full step's pitch band at 48 kHz: the candidate band (the bins the
# noise floor scans) and one more, the extraction's kc + 1.
PITCH_BAND = 427
# name: (streams, frames a stream, width, hop, band); a 1-D feature chunk
# has streams None; band None is the full width, a band comes with each
# stream's first frame at full width (`hopper_rfft.rfft_mag_first`).
SHAPES = {
    "full step, pitch, banded": (128, 933, 2048, 512, PITCH_BAND),
    "full step, pitch": (128, 933, 2048, 512, None),
    "full step, onset": (128, 7485, 256, 64, None),
    "segmented onsets": (128, 4096, 256, 64, None),
    "live slot, onset": (1, 16, 256, 64, None),
    "pool wave, onset": (33, 16, 256, 64, None),
    "feature chunk": (None, 8192, 2048, 512, None),
}


def _emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def views(audio, shape, dev):
    """(frames view, the audio it reads) for a SHAPES entry: streams of
    the shape's span cut from `audio` one after another."""
    import torch
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    s, f, w, hop = shape[:4]
    span = (f - 1) * hop + w
    rows = 1 if s is None else s
    need = rows * span
    reps = -(-need // len(audio))
    x = torch.from_numpy(audio).to(dev).repeat(reps)[:need]
    x = x.reshape(rows, span)
    frames = frame_signal(x if s is not None else x[0], w, hop)
    return frames, x


def call(frames, win, band):
    """K11 as a SHAPES entry's path calls it: the full width (band None),
    or the band and the first frames."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    if band is None:
        return hopper_rfft.rfft_mag(frames, None, win)
    return hopper_rfft.rfft_mag_first(frames, band, win)


def plain_call(frames, win, band):
    """`call`'s plain version (cuFFT)."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    if band is None:
        return hopper_rfft.rfft_mag_plain(frames, None, win)
    return hopper_rfft.rfft_mag_first_plain(frames, band, win)


def first_rows(frames, band) -> int:
    """The first frames a call writes at full width."""
    return 0 if band is None else frames.numel() // (frames.shape[-1]
                                                      * frames.shape[-2])


def shape_bound(frames, x, band=None) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, the order's issue ops) for one
    call (chip_smoke.py `k11_work`, `k11_issue_ops`)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rows = first_rows(frames, band)
    nbytes, flops = chip_smoke.k11_work(frames, x.numel(), band, rows)
    ms, by = chip_smoke.bound(nbytes, flops, chip_smoke.FP32_FLOPS)
    return ms, by, nbytes, chip_smoke.k11_issue_ops(frames, band, rows)


def form_counts(width: int, sms: int) -> dict:
    """Frame counts (multiples of 11) that take each of K11's forms
    (csrc/rfft_mag.cu `launch`: 32 values a thread from 8 warps an SM):
    the 16-value form at 66 frames (one frame a group's batch) and just
    below the switch (its fullest batches), the 32-value form just above
    it."""
    tpf = width // 64
    group = max(32, tpf)
    need = 8 * sms * (group // tpf) // (group // 32)
    return {"16": 66, "16, fullest": (need - group // tpf) // 11 * 11,
            "32": -(-need // 11) * 11 + 11}


def check(out) -> None:
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import fft, hopper_rfft, stft
    from audio_analyzer_rs_tpu_torch.ops import pitch
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    sys.path.insert(0, str(REPO))
    import chip_smoke
    dev = torch.device("cuda")
    assert PITCH_BAND == pitch.candidate_band(FULL_SR / 2048, 1025) + 1
    _, log = _build.build()
    for line in log.splitlines():
        if "rfft_mag" in line or ("Used" in line and "registers" in line):
            _emit({"ptxas": line.strip()}, out)

    def same(a, b) -> bool:
        return chip_smoke.same_bits_nan(a.contiguous().cpu(),
                                        torch.as_tensor(np.asarray(b)))
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for width in hopper_rfft.widths():
        win = fft.hann_window(width)
        for form, n in form_counts(width, sms).items():
            frames = rng.standard_normal((n, width)).astype(np.float32)
            frames[3] *= np.float32(2.0 ** -130)
            frames[5] *= np.float32(2.0 ** 70)
            frames[7, 9], frames[8, 2], frames[8, 3] = np.nan, np.inf, -np.inf
            fd = torch.from_numpy(frames).to(dev)
            for window in (win, None):
                wd = None if window is None else torch.from_numpy(
                    window).to(dev)
                got = hopper_rfft.rfft_mag(fd, None, wd)
                want = hopper_rfft.rfft_mag_fixed_np(frames, None, window)
                assert same(got, want), ("random", width, form, window is None)
            f3 = fd.reshape(n // 11, 11, width)
            for band in sorted({7, width // 4 + 11,
                                PITCH_BAND if width == 2048 else 7}):
                got, first = hopper_rfft.rfft_mag_first(
                    f3, band, torch.from_numpy(win).to(dev))
                assert same(got.reshape(n, band),
                            hopper_rfft.rfft_mag_fixed_np(frames, band, win)
                            ), ("banded", width, form, band)
                assert same(first, hopper_rfft.rfft_mag_fixed_np(
                    frames[::11], None, win)), ("first", width, form, band)
            _emit({"check": "bitwise to rfft_mag_fixed_np, full and banded "
                   "with the first frames", "width": width, "form": form,
                   "frames": n}, out)
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    quiet = (gen.mixed_scene(30.0, FULL_SR, seed=4)
             * np.float32(2.0 ** -120)).astype(np.float32)
    noise = rng.standard_normal(len(audio)).astype(np.float32)
    for width, hop in ((256, 64), (2048, 512)):
        win = fft.hann(width, dev)
        band = PITCH_BAND if width == 2048 else 57
        for label, x in (("scene", audio), ("random", noise),
                         ("silence", quiet)):
            xd = torch.from_numpy(x).to(dev)
            span = (len(x) - 1) // 4
            for off in (0, 1):          # float2 loads, then scalar loads
                frames = frame_signal(xd[off:off + 4 * span].reshape(
                    4, span), width, hop)
                got = stft.windowed_mags(frames, width, "fft")
                want = hopper_rfft.rfft_mag_fixed_np(
                    frames.cpu().numpy(), None, win.cpu().numpy())
                assert same(got, want), (label, width, off)
                got_b, first = hopper_rfft.rfft_mag_first(frames, band, win)
                assert same(got_b, want[..., :band]), (label, width, off)
                assert same(first, want[:, 0]), (label, width, off)
            plain = hopper_rfft.rfft_mag_plain(frames, None, win)
            peak = plain.abs().amax(-1, keepdim=True)
            err = float(((got - plain).abs() / peak.clamp(min=1e-30))
                        .max())
            assert label == "silence" or err <= 1e-5, (label, width, err)
            rel = None
            if label != "random":
                rel = stft.spectral_rel_mse(x, width, hop, "fft", dev)
                assert rel < stft.FIDELITY_MAX_REL_MSE, (label, width, rel)
            _emit({"check": "bitwise to rfft_mag_fixed_np (aligned and "
                   "odd views, full and banded with the first frames), "
                   "near cuFFT", "width": width, "data": label,
                   "frames": list(frames.shape), "band": band,
                   "max_rel_peak_vs_cufft": err, "spectral_rel_mse": rel},
                  out)
    for name in ("full step, pitch, banded", "full step, onset"):
        frames, _ = views(audio, SHAPES[name], dev)
        band = SHAPES[name][4]
        win = fft.hann(frames.shape[-1], dev)
        full = hopper_rfft.rfft_mag(frames, None, win)
        if band is not None:
            got, first = hopper_rfft.rfft_mag_first(frames, band, win)
            assert chip_smoke.same_bits(got, full[..., :band].contiguous())
            assert chip_smoke.same_bits(first, full[:, 0].contiguous())
        for b in (1, 33):
            assert chip_smoke.same_bits(
                hopper_rfft.rfft_mag(frames[:b], None, win), full[:b]), b
        for i in (0, 77, 127):
            assert chip_smoke.same_bits(
                hopper_rfft.rfft_mag(frames[i:i + 1, 5:9], None, win),
                full[i:i + 1, 5:9]), i
        _emit({"check": "batch-independent bits", "shape": name,
               "frames": list(frames.shape), "band": band}, out)


def times(out) -> None:
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import fft
    sys.path.insert(0, str(REPO))
    import chip_smoke
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    for name, shape in SHAPES.items():
        frames, x = views(audio, shape, dev)
        band = shape[4]
        win = fft.hann(frames.shape[-1], dev)
        with chip_smoke.SmClock() as clock:
            ms, plain_ms, turns = chip_smoke.in_turns(
                lambda: call(frames, win, band),
                lambda: plain_call(frames, win, band),
                chip_smoke.KERNEL_REPS)
        bound_ms, by, nbytes, ops = shape_bound(frames, x, band)
        issue_ms = chip_smoke.issue_floor_ms(ops, clock.mhz, sms)
        _emit({"shape": name, "frames": list(frames.shape), "band": band,
               "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
               "turns": turns, "bound_ms": bound_ms, "bound_by": by,
               "mb": nbytes / 1e6, "of_bound": bound_ms / ms,
               "gb_per_s": nbytes / ms / 1e6, "issue_floor_ms": issue_ms,
               "sm_mhz": clock.mhz, "sm_clock": clock.source}, out)


def turns(out, parent: str) -> None:
    import importlib.util
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import fft, hopper_rfft
    sys.path.insert(0, str(REPO))
    import chip_smoke
    spec = importlib.util.spec_from_file_location(
        "kernel_turns", REPO / "port_tools" / "kernel_turns.py")
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    lib_path, info = kt.build("k11_parent", Path(parent).read_text())
    _emit(info, out)
    own = _build.lib()

    class Parent:
        aat_rfft_mag = kt.load(lib_path, "aat_rfft_mag").aat_rfft_mag
        aat_error_string = own.aat_error_string

    def on(lib, fn, *args):
        real = _build.lib
        _build.lib = lambda: lib
        try:
            return fn(*args)
        finally:
            _build.lib = real
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    for name, shape in SHAPES.items():
        frames, x = views(audio, shape, dev)
        band = shape[4]
        win = fft.hann(frames.shape[-1], dev)
        mine = on(own, call, frames, win, band)
        if band is None:
            assert chip_smoke.same_bits(
                on(Parent, hopper_rfft.rfft_mag, frames, None, win),
                mine), name
        else:
            full = on(Parent, hopper_rfft.rfft_mag, frames, None, win)
            assert chip_smoke.same_bits(
                on(Parent, hopper_rfft.rfft_mag, frames, band, win),
                mine[0]), name
            assert chip_smoke.same_bits(full[:, 0].contiguous(), mine[1])
            del full
        del mine
        fns = {"parent": lambda: on(Parent, hopper_rfft.rfft_mag, frames,
                                    band, win),
               "package": lambda: on(own, call, frames, win, band)}
        with chip_smoke.SmClock() as clock:
            seq = [chip_smoke.cuda_times(fns[k], chip_smoke.KERNEL_REPS)
                   for k in ("parent", "package", "package", "parent")]
        med = [sorted(t)[len(t) // 2] for t in seq]
        parent_ms = sorted(seq[0] + seq[3])[len(seq[0])]
        own_ms = sorted(seq[1] + seq[2])[len(seq[1])]
        bound_ms, by, nbytes, ops = shape_bound(frames, x, band)
        _emit({"shape": name, "frames": list(frames.shape), "band": band,
               "parent_ms": parent_ms, "package_ms": own_ms,
               "turns": med, "bound_ms": bound_ms, "bound_by": by,
               "package_of_bound": bound_ms / own_ms,
               "issue_floor_ms": chip_smoke.issue_floor_ms(ops, clock.mhz,
                                                           sms),
               "sm_mhz": clock.mhz, "sm_clock": clock.source}, out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="check",
                    choices=("check", "times", "turns"))
    ap.add_argument("--out")
    ap.add_argument("--parent")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("k11_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = open(args.out, "a") if args.out else None
    _emit({"card": card}, out)
    if args.mode == "turns":
        turns(out, args.parent)
    else:
        (check if args.mode == "check" else times)(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
