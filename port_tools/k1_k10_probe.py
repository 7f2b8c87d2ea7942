#!/usr/bin/env python3
"""K10 (the pitch extraction, csrc/extract.cu) and K1's split over the
sample depth (csrc/stft.cu) on one GPU: times.

    python3 port_tools/k1_k10_probe.py [--skip-sweep] [--out probe.jsonl]

(`--skip-sweep` leaves out K1's sweep of frame counts.)

Times (CUDA events around 10 back-to-back launches after a ~2 ms spin,
median of 20 samples, as chip_smoke.py times): K10 and the plain
`ops/pitch.py` `_extract` at 2, 66, 8,192 and 119,424 frames of a 100 s
mixed scene's K1 magnitudes and K5 floors (a live slot, a pool wave, the
main path's call, the full step's call) beside the bound (bytes: the
band's magnitudes and floors read once, the [N, 8] outputs written once);
K1 unsplit, split (`fill_splits`) and cuBLAS FP32 (`torch.matmul` of the
windowed frames by the table) at n from 1 to 1,024 banded and 1 to 256 at
full width, the sweep that sets `hopper_stft.SPLIT_MAX_BLOCKS`.  One JSON
object a line.  The bitwise checks of both kernels are the card tests'
(tests/test_torch_kernels_cuda.py) and chip_smoke.py's phase 3.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (timing helpers; imports no JAX)

SR = 44100.0
W, HOP, HALF = 2048, 512, 1025


def emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_k10_probe: no CUDA device", file=sys.stderr)
        return 1
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import (hopper_extract, hopper_stft,
                                                 noisefloor, pitch)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    out = open(opts.out, "w") if opts.out else None
    dev = torch.device("cuda")
    _, log = _build.build()
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.lib()
    emit(out, card=cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())

    bw = float(np.float32(SR) / np.float32(W))
    kc = pitch.candidate_band(bw, HALF)
    trig_full = rdft_trig(W, dev)
    trig = trig_full[:, :2 * (kc + 1)]
    win = hann(W, dev)
    audio = torch.from_numpy(gen.mixed_scene(100.0, SR, seed=0)).to(dev)
    frames = frame_signal(audio, W, HOP)[:8192]              # [8192, 2048]

    mags = hopper_stft.dft_mag(frames, trig, win)            # [8192, 465]
    gf = torch.full((1, 8192), float(noisefloor.global_floor_linear(
        -96.0, HALF)), device=dev)
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(HALF, dev, (1,)), mags[None], gf, kc)
    eff = eff[0]
    big = mags.repeat(15, 1)[:119424]
    bigf = eff.repeat(15, 1)[:119424]

    # Times: K10 and the plain extraction.
    min_bin, max_bin = pitch._bins(bw, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)
    args = (bw, min_bin, max_bin, pitch.MIN_FREQ, pitch.MAX_FREQ, HALF)
    for n, m, fl in ((2, mags[3000:3002], eff[3000:3002]),
                     (66, mags[5000:5066], eff[5000:5066]),
                     (8192, mags, eff), (119424, big, bigf)):
        k_ms = cs.cuda_ms(lambda: hopper_extract.extract(m, fl, *args),
                          cs.KERNEL_REPS)
        p_ms = cs.cuda_ms(lambda: pitch._extract(m, fl, *args))
        nbytes = n * ((kc + 1) + kc) * 4 + n * 8 * 9
        emit(out, time="K10", frames=n, ms=k_ms, plain_ms=p_ms,
             bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3)

    if opts.skip_sweep:
        return 0
    # Times: K1 unsplit, split, cuBLAS.
    for label, tr, ns in (("banded", trig, (1, 2, 8, 33, 64, 65, 66, 96, 128,
                                            129, 192, 256, 384, 512, 768,
                                            1024)),
                          ("full", trig_full, (1, 2, 66, 128, 129, 256))):
        cols_pad = hopper_stft._cached_split(tr)[1]
        for n in ns:
            f = frames[2000:2000 + n]
            wf = (f * win).contiguous()
            sp = hopper_stft.fill_splits(n, cols_pad, W, 132)
            t1, t2, turns = cs.in_turns(
                lambda: hopper_stft._dft_mag(f, tr, win, splits=1),
                lambda: hopper_stft._dft_mag(f, tr, win, splits=sp),
                cs.KERNEL_REPS)
            lib = cs.cuda_ms(lambda: torch.matmul(wf, tr), cs.KERNEL_REPS)
            emit(out, time="K1", table=label, frames=n, unsplit_ms=t1,
                 split_ms=t2, splits=sp, cublas_ms=lib, turns=turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
