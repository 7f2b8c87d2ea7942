#!/usr/bin/env python3
"""K11 (the windowed real-FFT magnitude, csrc/rfft_mag.cu) on one GPU: its
bits, its batch independence and its times.

    python3 port_tools/k11_probe.py [check] [--out F]
    python3 port_tools/k11_probe.py times [--out F]
    python3 port_tools/k11_probe.py turns --parent FILE [--out F]

`check`: builds csrc/ and prints ptxas's lines for `rfft_mag_kernel`; then
K11 through its wrapper bit for bit against `rfft_mag_fixed_np` (the numpy
transcription of its operation order) at every width it takes (64 to
4,096, random frames with a row of subnormal samples, Hann and
rectangular windows, a band of 7) and at W = 256 and 2,048 on the 48 kHz
`mixed_scene(seed=0)`, on random frames, on a silence-level scene
(products below 2^-126) and through unfold views read with float2 and with
scalar loads (an odd sample offset); the float64 spectral gate (rel MSE <
1e-6) and the plain version (torch.fft.rfft(frames x hann).abs(), cuFFT)
within 1e-5 of each frame's peak; then each frame's bits in batches of 1,
33 and 128 streams at the full step's two calls.

`times`: K11, and its plain version (which is the library call too), at
the shapes of `SHAPES` below, in turns (kernel, plain, kernel, plain),
each beside its bound: each input sample read once (a stream's span) and
each magnitude written once, at 3.35 TB/s; the flops (~2.5 W log2 W a
frame, as a half-length complex FFT) at 67 TFLOP/s FP32 are below it at
every shape.  Times as chip_smoke.py takes them: CUDA events around 10
back-to-back launches after a ~2 ms spin, median of 20 samples.

`turns`: FILE, another rfft_mag.cu with the same C entry (an earlier
design, e.g. unpacked by `git archive <rev> audio_analyzer_rs_tpu_torch/
csrc | tar -x -C _proof/parent`), built alone by nvcc with the port's
flags (port_tools/kernel_turns.py `build`) and called through the same
wrapper, against the package's K11 at each shape: bitwise to each other
first, then timed in turns (parent, package, package, parent).

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
# name: (streams, frames a stream, width, hop); a 1-D feature chunk has
# streams None.
SHAPES = {
    "full step, pitch": (128, 933, 2048, 512),
    "full step, onset": (128, 7485, 256, 64),
    "segmented onsets": (128, 4096, 256, 64),
    "live slot, onset": (1, 16, 256, 64),
    "pool wave, onset": (33, 16, 256, 64),
    "feature chunk": (None, 8192, 2048, 512),
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
    s, f, w, hop = shape
    span = (f - 1) * hop + w
    rows = 1 if s is None else s
    need = rows * span
    reps = -(-need // len(audio))
    x = torch.from_numpy(audio).to(dev).repeat(reps)[:need]
    x = x.reshape(rows, span)
    frames = frame_signal(x if s is not None else x[0], w, hop)
    return frames, x


def shape_bound(frames, x) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes) for one call (chip_smoke.py
    `k11_work`)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    nbytes, flops = chip_smoke.k11_work(frames, x.numel())
    ms, by = chip_smoke.bound(nbytes, flops, chip_smoke.FP32_FLOPS)
    return ms, by, nbytes


def check(out) -> None:
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import fft, hopper_rfft, stft
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    sys.path.insert(0, str(REPO))
    import chip_smoke
    dev = torch.device("cuda")
    _, log = _build.build()
    for line in log.splitlines():
        if "rfft_mag" in line or ("Used" in line and "registers" in line):
            _emit({"ptxas": line.strip()}, out)

    def same(a, b) -> bool:
        return chip_smoke.same_bits(a.contiguous().cpu(),
                                    torch.as_tensor(np.asarray(b)))
    rng = np.random.default_rng(0)
    for width in hopper_rfft.widths():
        frames = rng.standard_normal((67, width)).astype(np.float32)
        frames[3] *= np.float32(2.0 ** -130)
        win = fft.hann_window(width)
        for window, band in ((win, None), (None, None), (win, 7)):
            got = hopper_rfft.rfft_mag(
                torch.from_numpy(frames).to(dev), band,
                None if window is None else torch.from_numpy(window).to(dev))
            want = hopper_rfft.rfft_mag_fixed_np(frames, band, window)
            assert same(got, want), ("random", width, band, window is None)
        _emit({"check": "bitwise to rfft_mag_fixed_np", "width": width,
               "frames": 67}, out)
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    quiet = (gen.mixed_scene(30.0, FULL_SR, seed=4)
             * np.float32(2.0 ** -120)).astype(np.float32)
    noise = rng.standard_normal(len(audio)).astype(np.float32)
    for width, hop in ((256, 64), (2048, 512)):
        win = fft.hann(width, dev)
        for label, x in (("scene", audio), ("random", noise),
                         ("silence", quiet)):
            xd = torch.from_numpy(x).to(dev)
            for off in (0, 1):          # float2 loads, then scalar loads
                frames = frame_signal(xd[off:], width, hop)
                got = stft.windowed_mags(frames, width, "fft")
                want = hopper_rfft.rfft_mag_fixed_np(
                    frames.cpu().numpy(), None, win.cpu().numpy())
                assert same(got, want), (label, width, off)
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
                   "odd views), near cuFFT", "width": width, "data": label,
                   "frames": frames.shape[0], "max_rel_peak_vs_cufft": err,
                   "spectral_rel_mse": rel}, out)
    for name in ("full step, pitch", "full step, onset"):
        frames, _ = views(audio, SHAPES[name], dev)
        w = frames.shape[-1]
        win = fft.hann(w, dev)
        full = hopper_rfft.rfft_mag(frames, None, win)
        for b in (1, 33):
            assert chip_smoke.same_bits(
                hopper_rfft.rfft_mag(frames[:b], None, win), full[:b]), b
        for i in (0, 77, 127):
            assert chip_smoke.same_bits(
                hopper_rfft.rfft_mag(frames[i:i + 1, 5:9], None, win),
                full[i:i + 1, 5:9]), i
        _emit({"check": "batch-independent bits", "shape": name,
               "frames": list(frames.shape)}, out)


def times(out) -> None:
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import fft, hopper_rfft
    sys.path.insert(0, str(REPO))
    import chip_smoke
    dev = torch.device("cuda")
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    for name, shape in SHAPES.items():
        frames, x = views(audio, shape, dev)
        w = frames.shape[-1]
        win = fft.hann(w, dev)
        ms, plain_ms, turns = chip_smoke.in_turns(
            lambda: hopper_rfft.rfft_mag(frames, None, win),
            lambda: hopper_rfft.rfft_mag_plain(frames, None, win),
            chip_smoke.KERNEL_REPS)
        bound_ms, by, nbytes = shape_bound(frames, x)
        _emit({"shape": name, "frames": list(frames.shape), "ms": ms,
               "plain_ms": plain_ms, "library_ms": plain_ms,
               "turns": turns, "bound_ms": bound_ms, "bound_by": by,
               "mb": nbytes / 1e6, "of_bound": bound_ms / ms,
               "gb_per_s": nbytes / ms / 1e6}, out)


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

    def call(lib, frames, win):
        real = _build.lib
        _build.lib = lambda: lib
        try:
            return hopper_rfft.rfft_mag(frames, None, win)
        finally:
            _build.lib = real
    dev = torch.device("cuda")
    audio = gen.mixed_scene(120.0, FULL_SR, seed=0)
    for name, shape in SHAPES.items():
        frames, x = views(audio, shape, dev)
        win = fft.hann(frames.shape[-1], dev)
        assert chip_smoke.same_bits(call(Parent, frames, win),
                                    call(own, frames, win)), name
        seq = [chip_smoke.cuda_times(lambda lib=lib: call(lib, frames, win),
                                     chip_smoke.KERNEL_REPS)
               for lib in (Parent, own, own, Parent)]
        med = [sorted(t)[len(t) // 2] for t in seq]
        parent_ms = sorted(seq[0] + seq[3])[len(seq[0])]
        own_ms = sorted(seq[1] + seq[2])[len(seq[1])]
        bound_ms, by, nbytes = shape_bound(frames, x)
        _emit({"shape": name, "frames": list(frames.shape),
               "parent_ms": parent_ms, "package_ms": own_ms,
               "turns": med, "bound_ms": bound_ms, "bound_by": by,
               "package_of_bound": bound_ms / own_ms}, out)


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
