#!/usr/bin/env python3
"""K10 (the pitch extraction, csrc/extract.cu) and K1's split over the
sample depth (csrc/stft.cu) on one GPU: times.

    python3 port_tools/k1_k10_probe.py [times] [--skip-sweep] [--out F]
    python3 port_tools/k1_k10_probe.py turns [--parent DIR] [--out F]
    python3 port_tools/k1_k10_probe.py path [--parent DIR] [--rounds R]
    python3 port_tools/k1_k10_probe.py pool [--parent DIR] [--rounds R]

`times` (the default; `--skip-sweep` leaves out K1's sweep): K10 through
its wrapper and the plain `ops/pitch.py` `_extract` at the shapes below,
beside the bound (bytes: the band's magnitudes and floors read
once, the [N, 8] outputs written once); K1 unsplit, split (`fill_splits`)
and cuBLAS FP32 (`torch.matmul` of the windowed frames by the table) at n
from 1 to 1,024 banded and 1 to 256 at full width, the sweep that sets
`hopper_stft.SPLIT_MAX_BLOCKS`.

`turns`: DIR's extract.cu (default `_proof/parent/audio_analyzer_rs_tpu_torch
/csrc`, unpacked from the parent commit by `git archive <rev>
audio_analyzer_rs_tpu_torch/csrc | tar -x -C _proof/parent`; it includes
its own comb.cuh) and the package's, each built alone by nvcc (sm_90a, the
port's flags) and called through its C entry: both held bit for bit to the
plain `_extract` at each shape, then timed in turns (parent, package,
package, parent), with the achieved GB/s and the share of the bound.  Then
a probe build of the package's source (`-DK10_PHASE_CYCLES`: clock64
between the phases) gives the cycles a frame of each phase: the staging
wait (the warp waiting for its frame's copies), the peaks, the per-peak
work (logs, interpolation, comb, gates), the staging issue (starting the
next frame's copies) and the tail (max, candidates, top 32, ghosts, dedup,
outputs), with the grid, the blocks' mean and largest cycles, the launch's
span on the global timer and the candidate counts.  Last, the launch
floor: an empty kernel (one block of 32 threads) launched through ctypes,
timed the same way.

`path`: the 30-minute pitch path (`segmented_pitch_analysis` over
`mixed_scene(1800, seed=0)` at 44.1 kHz, warm, host clock around the
call) with DIR's K10 and the package's swapped in for
`hopper_extract.extract`, in turns (parent, package, package, parent) for
`--rounds` rounds: the end-to-end wall of one kernel against the other in
one process, everything else the same code.

`pool`: chip_smoke.py phase 11's classroom (32 students and one joining at
5 s, capacity 33, depth 1, 20 s) `--rounds` times, its waves taking DIR's
K10 and the package's by turns (parent, package, package, parent, wave by
wave; each round starts one step further into that order): the host ms a
wave of each kernel's waves (p50, p99, waves over the slot's budget), with
each round's onset events and tuner readings.

The shapes: the main path's call (8,192 frames of a 100 s
`mixed_scene(seed=0)` at 44.1 kHz, K1's banded magnitudes [8192, 465] and
K5's floors; and chip_smoke.py phase 3's call, the 30-minute scene's third
pitch step, 128 streams x 64 frames with fresh floor states), a live slot
([2, 427] at 48 kHz), a pool wave of 33 lanes ([66, 427]) and the full
step's call (128 streams x 933 frames at 48 kHz:
the "fft" full-width magnitudes [119424, 1025] read through their stride,
banded floors [119424, 426]), the 48 kHz ones windows of a 120 s
`mixed_scene(seed=1)`.  Times: CUDA events around 10 back-to-back launches
after a ~2 ms spin, median of 20 samples, as chip_smoke.py times.  One
JSON object a line.  The bitwise checks through the wrapper are the card
tests' (tests/test_torch_kernels_cuda.py) and chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (timing helpers; imports no JAX)

SR, SR48 = 44100.0, 48000.0
W, HOP, HALF = 2048, 512, 1025
STREAMS, STREAM_FRAMES = 128, 933      # the full step's call
OUT = REPO / "_proof" / "k10_probe"
CSRC = REPO / "audio_analyzer_rs_tpu_torch" / "csrc"
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int aat_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
PHASES = ("staging wait", "peaks", "per-peak (logs, comb, gates)",
          "staging issue",
          "tail (max, candidates, top 32, ghosts, dedup, outputs)")


def emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def shapes(dev):
    """[(label, mags, floors, (bin width, min bin, max bin, min freq,
    max freq, half))] at the four shapes."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.ops import hopper_stft, noisefloor, pitch
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import (frame_signal,
                                                           num_frames)

    def args_at(sr):
        bw = float(np.float32(sr) / np.float32(W))
        lo, hi = pitch._bins(bw, HALF, pitch.MIN_FREQ, pitch.MAX_FREQ)
        return (bw, lo, hi, pitch.MIN_FREQ, pitch.MAX_FREQ, HALF)

    def floors(mags, kc):
        s, n = mags.shape[:2]
        gf = torch.full((s, n), float(noisefloor.global_floor_linear(
            -96.0, HALF)), device=dev)
        return noisefloor.noise_floor_scan(
            noisefloor.init_state(HALF, dev, (s,)), mags, gf, kc)[1]

    a44 = args_at(SR)
    kc = pitch.candidate_band(a44[0], HALF)
    trig, win = rdft_trig(W, dev)[:, :2 * (kc + 1)], hann(W, dev)
    audio = torch.from_numpy(gen.mixed_scene(100.0, SR, seed=0)).to(dev)
    frames = frame_signal(audio, W, HOP)[:8192]
    mags = hopper_stft.dft_mag(frames, trig, win)            # [8192, 465]
    out = [("main", mags, floors(mags[None], kc)[0], a44)]
    # chip_smoke.py phase 3's call: the 30-min scene's third pitch step,
    # 128 streams x 64 frames, each stream's floors from a fresh state.
    scene = gen.mixed_scene(1800.0, SR, seed=0)
    n_total = num_frames(len(scene), W, HOP)
    plan = segmented._plan_streams(n_total, 128, 128, 64, W, HOP)
    padded = torch.from_numpy(np.pad(
        scene, (0, max(0, plan.max_sample - len(scene))))).to(dev)
    streams = segmented._slice_streams(padded, plan.stream_start * HOP,
                                       plan.stream_samples)
    chunk = streams[:, 2 * 64 * HOP:2 * 64 * HOP + plan.chunk_samples]
    step = hopper_stft.dft_mag(frame_signal(chunk, W, HOP), trig, win)
    out.append(("main (phase 3)", step.reshape(8192, -1),
                floors(step, kc).reshape(8192, -1), a44))

    a48 = args_at(SR48)
    kc48 = pitch.candidate_band(a48[0], HALF)
    x = torch.from_numpy(gen.mixed_scene(120.0, SR48, seed=1)).to(dev)
    length = (STREAM_FRAMES - 1) * HOP + W
    streams = torch.stack([x[i * 41000:i * 41000 + length]
                           for i in range(STREAMS)])
    full = windowed_mags(frame_signal(streams, W, HOP), W, "fft")
    eff = floors(full, kc48)                     # [128, 933, 426]
    band = full[..., :kc48 + 1]
    out += [("live", band[0, 500:502].contiguous(),
             eff[0, 500:502].contiguous(), a48),
            ("pool", band[:33, 500:502].reshape(66, -1).contiguous(),
             eff[:33, 500:502].reshape(66, -1).contiguous(), a48),
            ("full step", full.reshape(-1, HALF), eff.reshape(-1, kc48),
             a48)]
    return out


def bound_of(mags, args):
    """(bytes, bound ms) of one call: the band read once, outputs once."""
    from audio_analyzer_rs_tpu_torch.ops import pitch
    kc = pitch.candidate_band(args[0], args[-1])
    nb = mags.shape[0] * ((kc + 1) + kc) * 4 + mags.shape[0] * 8 * 9
    return nb, nb / cs.HBM_BYTES_PER_S * 1e3


def times(opts, out) -> None:
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.ops import hopper_extract, hopper_stft
    from audio_analyzer_rs_tpu_torch.ops import pitch
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    dev = torch.device("cuda")
    _, log = _build.build()
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.lib()
    emit(out, card=card())

    for label, m, fl, args in shapes(dev):
        k_ms = cs.cuda_ms(lambda: hopper_extract.extract(m, fl, *args),
                          cs.KERNEL_REPS)
        p_ms = cs.cuda_ms(lambda: pitch._extract(m, fl, *args))
        nb, b_ms = bound_of(m, args)
        emit(out, time="K10", shape=label, frames=m.shape[0], ms=k_ms,
             plain_ms=p_ms, bound_ms=b_ms, gb_per_s=nb / k_ms / 1e6)

    if opts.skip_sweep:
        return
    # Times: K1 unsplit, split, cuBLAS.
    kc = pitch.candidate_band(float(SR / W), HALF)
    trig_full = rdft_trig(W, dev)
    trig = trig_full[:, :2 * (kc + 1)]
    win = hann(W, dev)
    audio = torch.from_numpy(gen.mixed_scene(30.0, SR, seed=0)).to(dev)
    frames = frame_signal(audio, W, HOP)
    for label, tr, ns in (("banded", trig, (1, 2, 8, 33, 64, 65, 66, 96, 128,
                                            129, 192, 256, 384, 512, 768,
                                            1024)),
                          ("full", trig_full, (1, 2, 66, 128, 129, 256))):
        cols_pad = hopper_stft._cached_split(tr)[1]
        for n in ns:
            f = frames[:n]
            wf = (f * win).contiguous()
            sp = hopper_stft.fill_splits(n, cols_pad, W, 132)
            t1, t2, turns = cs.in_turns(
                lambda: hopper_stft._dft_mag(f, tr, win, splits=1),
                lambda: hopper_stft._dft_mag(f, tr, win, splits=sp),
                cs.KERNEL_REPS)
            lib = cs.cuda_ms(lambda: torch.matmul(wf, tr), cs.KERNEL_REPS)
            emit(out, time="K1", table=label, frames=n, unsplit_ms=t1,
                 split_ms=t2, splits=sp, cublas_ms=lib, turns=turns)


def build(jobs: dict) -> dict:
    """{label: (source path, extra flags)} -> {label: library}, one nvcc
    each, in parallel; prints ptxas' register lines."""
    from audio_analyzer_rs_tpu_torch import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, flags) in jobs.items():
        lib = OUT / f"lib_{label.replace(' ', '_')}.so"
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{err}")
        for line in err.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {label}: {line.strip()}", flush=True)
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def caller(lib):
    """K10 through a library's C entry: (mags, floors, args) -> outputs."""
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    fn = lib.aat_extract
    fn.argtypes = _build._SIGNATURES["aat_extract"]
    fn.restype = ctypes.c_int

    def run(m, fl, args):
        from audio_analyzer_rs_tpu_torch.ops import pitch
        bw, lo, hi, fmin, fmax, half = args
        kc = pitch.candidate_band(bw, half)
        n = m.shape[0]
        freq = torch.empty((n, 8), device=m.device)
        score = torch.empty((n, 8), device=m.device)
        valid = torch.empty((n, 8), dtype=torch.bool, device=m.device)
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(m.data_ptr(), m.stride(0), fl.data_ptr(), fl.stride(0),
                  freq.data_ptr(), score.data_ptr(), valid.data_ptr(), n, kc,
                  half, lo, hi, bw, fmin, fmax, ctypes.c_void_p(stream))
        if code != 0:
            raise RuntimeError(f"aat_extract: CUDA error {code}")
        return freq, score, valid
    return run


def turns(opts, out) -> None:
    import torch
    from audio_analyzer_rs_tpu_torch.ops import pitch
    parent = Path(opts.parent)
    empty = OUT / "empty.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    empty.write_text(EMPTY_CU)
    libs = build({"parent": (parent / "extract.cu", ()),
                  "package": (CSRC / "extract.cu", ()),
                  "phases": (CSRC / "extract.cu", ("-DK10_PHASE_CYCLES",)),
                  "empty": (empty, ())})
    emit(out, card=card())
    dev = torch.device("cuda")
    run = {k: caller(libs[k]) for k in ("parent", "package", "phases")}
    cases = shapes(dev)
    for label, m, fl, args in cases:
        ref = pitch._extract(m, fl, *args)
        for who in run:
            got = run[who](m, fl, args)
            torch.cuda.synchronize()
            if not all(cs.same_bits(g, r) for g, r in zip(got, ref)):
                raise SystemExit(f"K10 {who} at {label}: not bitwise the "
                                 f"plain extraction")
        nb, b_ms = bound_of(m, args)
        t_parent, t_package, four = cs.in_turns(
            lambda: run["parent"](m, fl, args),
            lambda: run["package"](m, fl, args), cs.KERNEL_REPS)
        emit(out, turns="K10", shape=label, frames=m.shape[0],
             mags=list(m.shape), mag_stride=m.stride(0),
             notes=int(ref[2].sum()), parent_ms=t_parent,
             package_ms=t_package, turn_ms=four, bound_ms=b_ms,
             parent_share=b_ms / t_parent, package_share=b_ms / t_package,
             parent_gb_per_s=nb / t_parent / 1e6,
             package_gb_per_s=nb / t_package / 1e6,
             bitwise_to_plain=True)

    cycles = libs["phases"].aat_extract_phase_cycles
    cycles.argtypes = (ctypes.c_void_p, ctypes.c_int)
    cycles.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 15)()
    for label, m, fl, args in cases:
        with cs.SmClock() as clock:
            probe_ms = cs.cuda_ms(lambda: run["phases"](m, fl, args),
                                  cs.KERNEL_REPS)
        cycles(sums, 1)
        run["phases"](m, fl, args)           # one launch alone: its span
        torch.cuda.synchronize()
        cycles(sums, 1)
        one = list(sums)
        for _ in range(cs.KERNEL_REPS * cs.TIMING_RUNS):
            run["phases"](m, fl, args)
        torch.cuda.synchronize()
        cycles(sums, 1)
        frames = max(int(sums[5]), 1)
        per_frame = [sums[j] / frames for j in range(5)]
        emit(out, phases="K10", shape=label, frames=m.shape[0],
             frames_counted=frames, probe_ms=probe_ms, sm_mhz=clock.mhz,
             cycles_a_frame=dict(zip(PHASES, per_frame)),
             share=dict(zip(PHASES, (c / max(sum(per_frame), 1)
                                     for c in per_frame))),
             grid=one[6], blocks_mean_cycles=one[7] / max(one[6], 1),
             blocks_max_cycles=one[8], span_ns=one[10] - one[9],
             most_peaks=one[12], most_candidates=one[13],
             mean_candidates=one[14] / max(one[5], 1))

    fn = libs["empty"].aat_empty
    fn.argtypes = (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    floor_ms = cs.cuda_ms(lambda: fn(stream), cs.KERNEL_REPS)
    emit(out, launch_floor_ms=floor_ms, how="an empty kernel, one block of "
         "32 threads, 10 back-to-back ctypes launches after a ~2 ms spin, "
         "median of 20 samples")


TURNS = ("parent", "package", "package", "parent")


def swapped(opts, out) -> dict:
    """{"parent", "package"} -> a stand-in for `hopper_extract.extract`
    that launches DIR's K10 or the package's through its C entry (both
    the same way, counted as the wrapper counts)."""
    from audio_analyzer_rs_tpu_torch.ops import hopper_extract, pitch
    libs = build({"parent": (Path(opts.parent) / "extract.cu", ()),
                  "package": (CSRC / "extract.cu", ())})
    emit(out, card=card())

    def kernel(run):
        def extract(mags, floor, bw, lo, hi, fmin, fmax, half):
            hopper_extract.LAUNCHES += 1
            return pitch.PitchFrame(*run(mags, floor,
                                         (bw, lo, hi, fmin, fmax, half)))
        return extract
    return {who: kernel(caller(lib)) for who, lib in libs.items()}


def path(opts, out) -> None:
    import statistics
    import time

    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.ops import hopper_extract
    kernel = swapped(opts, out)
    audio = gen.mixed_scene(1800.0, SR, seed=0)
    walls = {"parent": [], "package": []}
    ref = None
    for r in range(opts.rounds + 1):
        for who in TURNS:
            hopper_extract.extract = kernel[who]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = segmented.segmented_pitch_analysis(audio, SR)
            wall = time.perf_counter() - t0
            ref = got if ref is None else ref
            if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"the 30-min path with {who}'s K10 differs")
            if r > 0:                      # round 0 warms both up
                walls[who].append(wall)
    emit(out, path="30-min pitch path", rounds=opts.rounds,
         parent_s=walls["parent"], package_s=walls["package"],
         parent_median_s=statistics.median(walls["parent"]),
         package_median_s=statistics.median(walls["package"]),
         outputs_equal=True)


def pool(opts, out) -> None:
    import time

    from audio_analyzer_rs_tpu_torch import EnginePool
    from audio_analyzer_rs_tpu_torch.ops import hopper_extract
    kernel = swapped(opts, out)
    slot_s = cs.LIVE_SLOT / cs.LIVE_SR
    n_waves = int(cs.CLASS_SECONDS / slot_s)
    join_at = int(cs.CLASS_JOIN_S / slot_s)
    ms = {"parent": [], "package": []}
    tallies = []
    for r in range(opts.rounds):
        members = [cs.class_member(100 + k, cs.CLASS_SECONDS)
                   for k in range(cs.CLASS_K)]
        pool = EnginePool([m[0] for m in members], pipeline_depth=1,
                          aggregate_slots=1, capacity=cs.CLASS_CAPACITY)
        pool.prepare()
        events, readings = [0] * cs.CLASS_CAPACITY, [0] * cs.CLASS_CAPACITY
        for i in range(n_waves):
            if i == join_at:
                members.append(cs.class_member(
                    100 + cs.CLASS_K, cs.CLASS_SECONDS - cs.CLASS_JOIN_S))
                pool.add(members[-1][0])
            who = TURNS[(i + r) % 4]
            hopper_extract.extract = kernel[who]
            t0 = time.perf_counter()
            pool.step_wave()
            ms[who].append((time.perf_counter() - t0) * 1e3)
            for k, (_, tuner, det) in enumerate(members):
                events[k] += len(json.loads(det.poll_onsets()))
                readings[k] += bool(json.loads(tuner.poll_output())["notes"])
        pool.flush()
        for k, (_, _, det) in enumerate(members):
            events[k] += len(json.loads(det.poll_onsets()))
        tallies.append((sum(events), sum(r > 0 for r in readings)))
        del members, pool

    def stats(v):
        v = sorted(v)
        return dict(waves=len(v), p50_ms=v[len(v) // 2],
                    p99_ms=v[int(0.99 * (len(v) - 1))], max_ms=v[-1],
                    over_budget=sum(t > cs.LIVE_BUDGET_MS for t in v))
    emit(out, pool="classroom", rounds=opts.rounds, waves=n_waves,
         budget_ms=cs.LIVE_BUDGET_MS, parent=stats(ms["parent"]),
         package=stats(ms["package"]),
         events_and_students_with_readings=tallies)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?",
                    choices=("times", "turns", "path", "pool"),
                    default="times")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--parent", default=str(
        REPO / "_proof" / "parent" / "audio_analyzer_rs_tpu_torch" / "csrc"))
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_k10_probe: no CUDA device", file=sys.stderr)
        return 1
    out = open(opts.out, "w") if opts.out else None
    try:
        {"times": times, "turns": turns, "path": path,
         "pool": pool}[opts.mode](opts, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
