#!/usr/bin/env python3
"""The full step's kernels and card time, profiled in a process of its own.

    python3 port_tools/fullstep_profile.py [--profiles 3] [--stft k11|plain]
        [--streams 2048]

`make_batched_full_step` over chip_smoke.py phase 12's fleet (128 streams
of the 30-minute `mixed_scene(seed=0)` taken as 48 kHz audio, a stream
every 600,000 samples, 468-slot chunks on the card): the first two steps
from fresh states, then the second step again from the states the first
leaves, timed by CUDA events around it (median of 20 steps) and by the
host clock around it and a synchronize (median of 20), and run
`--profiles` times under torch.profiler, each its own session, the step
20 ms into it and bracketed by CUDA events.  `--stft plain` runs the
step's two "fft" STFTs through the plain version instead of K11
(`torch.fft.rfft(frames x hann).abs()`, cuFFT, the pitch call's band and
first frames sliced from its full width: the step as it was before K11),
for the before-and-after of one run.  Prints the card's name and
power limit, then one JSON line: the step's ms (events and host), and for
each profile torch's CUDA kernels and their card ms, the port's
(csrc/*.cu) and theirs, K5's, K11's, cuFFT's, the card's busy ms against
the profiled step's ms, and the top torch kernels.  Exits 2 without a
CUDA device.

torch.profiler has lost kernels in a process that profiled before:
chip_smoke.py's phase 12, after phases 10-11's profiles, saw 22-28 of
the step's 43-50 torch kernels.  chip_smoke.py runs this script for the
step's card time, and port_tools/kernel_turns.py --kernel k5 calls
`profile_step` with each K5 build.  The JSON line also has K4's launches
in the fleet's first two steps and the blocks a SM that its launches kept
resident, by bin width (`ops/hopper_onset.py`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SR44 = 44100.0
# The port's own kernels among the profiler's (csrc/*.cu).
OWN_KERNELS = ("reducer_kernel", "dynamics_", "noise_floor_kernel",
               "onset_kernel", "tracker_select_kernel", "extract_kernel",
               "stft_mag_kernel", "comb_kernel", "rfft_mag_kernel")


def plain_stft(frames, window, backend="fft", band=None):
    """The step's "fft" STFT through the plain version (cuFFT), in place of
    ops/stft.py `windowed_mags`."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    from audio_analyzer_rs_tpu_torch.ops.fft import hann
    assert backend == "fft", backend
    return hopper_rfft.rfft_mag_plain(frames, band,
                                      hann(window, frames.device))


def plain_pitch_mags(frames, band):
    """The step's banded pitch STFT and its first frames through the plain
    version (cuFFT), in place of parallel/sharding.py `pitch_mags`."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    from audio_analyzer_rs_tpu_torch.ops.fft import hann
    from audio_analyzer_rs_tpu_torch.ops.stft import PITCH_WINDOW
    return hopper_rfft.rfft_mag_first_plain(
        frames, band, hann(PITCH_WINDOW, frames.device))


def fleet_step(dev, capture=None, streams=None):
    """The step and chip_smoke.py phase 12's fleet (or `streams` streams,
    a stream every 600,000 samples or closer where the recording runs
    short); runs steps 1 and 2 (`capture`, a list, gets each K5 call's
    arguments) → (the step, the states after step 1, step 2's chunk)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import noisefloor
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    audio = gen.mixed_scene(1800.0, SR44, seed=0)
    t_chunk = chip_smoke.FULL_SLOTS * 1024
    streams = streams or chip_smoke.FULL_B
    gap = min(600_000, (len(audio) - 2 * t_chunk) // streams)
    fleet = np.stack([audio[k * gap:k * gap + 2 * t_chunk]
                      for k in range(streams)])
    chunks = [torch.from_numpy(fleet[:, k * t_chunk:(k + 1) * t_chunk]
                               .copy()).to(dev) for k in range(2)]
    step = sharding.make_batched_full_step(None, chip_smoke.FULL_SR)
    scan = noisefloor.noise_floor_scan

    def record(*args):
        capture.append(args)
        return scan(*args)
    if capture is not None:
        noisefloor.noise_floor_scan = record
    try:
        st1, _ = step(sharding.init_stream_states(streams), chunks[0])
        step(st1, chunks[1])
    finally:
        noisefloor.noise_floor_scan = scan
    torch.cuda.synchronize()
    return step, st1, chunks[1]


def profile_step(step, st, chunk, call=None, profiles: int = 1) -> dict:
    """step(st, chunk) timed by CUDA events, then under torch.profiler
    `profiles` times; `call`, if given, is the step's K5 call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from audio_analyzer_rs_tpu_torch.ops import noisefloor
    real = noisefloor.noise_floor_scan
    if call is not None:
        noisefloor.noise_floor_scan = call
    runs = []
    try:
        step_ms = statistics.median(chip_smoke.cuda_times(
            lambda: step(st, chunk)))
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, chunk)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        for _ in range(profiles):
            torch.cuda.synchronize()
            begin = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.02)
                begin.record()
                step(st, chunk)
                done.record()
                torch.cuda.synchronize()
            runs.append((prof.key_averages(), begin.elapsed_time(done)))
    finally:
        noisefloor.noise_floor_scan = real

    def ms(group):
        return sum(ev.self_device_time_total for ev in group) / 1e3
    out = []
    for averages, span_ms in runs:
        evs = [ev for ev in averages
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        own = [ev for ev in evs if any(k in ev.key for k in OWN_KERNELS)]
        torch_k = [ev for ev in evs if ev not in own]
        top = sorted(torch_k, key=lambda ev: -ev.self_device_time_total)
        k11 = [ev for ev in own if "rfft_mag_kernel" in ev.key]
        cufft = [ev for ev in torch_k if "fft" in ev.key.lower()]
        out.append({
            "saw_stft": bool(k11 or cufft),
            "torch_kernels": sum(ev.count for ev in torch_k),
            "torch_card_ms": ms(torch_k),
            "port_kernels": sum(ev.count for ev in own),
            "port_card_ms": ms(own),
            "k5_card_ms": ms(ev for ev in own
                             if "noise_floor_kernel" in ev.key),
            "k11_kernels": sum(ev.count for ev in k11),
            "k11_card_ms": ms(k11),
            "cufft_kernels": sum(ev.count for ev in cufft),
            "cufft_card_ms": ms(cufft),
            "card_busy_ms": ms(evs), "profiled_step_ms": span_ms,
            "top": [f"{ev.key[:48]} x{ev.count} "
                    f"{ev.self_device_time_total / 1e3:.3f} ms"
                    for ev in top[:6]]})
    return {"step_ms": step_ms, "host_ms": statistics.median(host),
            "profiles": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", type=int, default=3)
    ap.add_argument("--stft", choices=("k11", "plain"), default="k11")
    ap.add_argument("--streams", type=int,
                    help="streams in the fleet (default chip_smoke.py's)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fullstep_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, str(REPO))
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    if args.stft == "plain":
        sharding.windowed_mags = plain_stft
        sharding.pitch_mags = plain_pitch_mags
    from audio_analyzer_rs_tpu_torch.ops import hopper_onset
    step, st, chunk = fleet_step(torch.device("cuda"), streams=args.streams)
    launches = hopper_onset.LAUNCHES
    out = profile_step(step, st, chunk, profiles=args.profiles)
    # K4's launches in the fleet's first two steps, and the blocks a SM its
    # launches kept resident, by bin width.
    out["k4_launches"] = launches
    out["k4_resident_blocks"] = {f"H={h}": n for h, n
                                 in hopper_onset.RESIDENT.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
