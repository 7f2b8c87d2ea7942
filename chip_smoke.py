#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audio_analyzer_rs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each on standard output:
  1. the card's name and power limit (nvidia-smi);
  2. the build of csrc/*.cu (nvcc, sm_90a) and its time;
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the shapes the main path gives it, with CUDA-event times (warm,
     median of 20 samples a turn, a kernel's sample the mean of 10
     back-to-back launches; K1 and K2 in turns with their yardstick:
     kernel, yardstick, kernel, yardstick) and the least time the card
     could take (bound: the larger of bytes over 3.35 TB/s and operations
     over the peak rate of their type):
       K1 stft  [128 streams x 64 frames x 2048] → 465 bins, max|Δ| <= 1e-5·max
            of cuBLAS FP32 (plus the float64 spectral gate, rel MSE < 1e-6);
            yardstick: the cuBLAS FP32 product of the windowed frames;
       K2 comb  [8192, 464] from real spectra, bitwise; yardstick: the plain
            comb (on the paths K2's comb runs inside K10);
       K10 extract [8192, 465] magnitudes and [8192, 464] floors (the step's
            K1 and K5 outputs) -> [8192, 8], bitwise (freqs, scores,
            valid) to the plain extraction `ops/pitch.py` `_extract`;
            yardstick: that plain extraction, in turns; achieved GB/s
            beside the bound;
       K1 at the latency shapes ([1, 2, 2048] and [33, 2, 2048] at the
            48 kHz band, [1, 2, 2048] at full width), split over the sample
            depth: bitwise to the unsplit launch (`_dft_mag(...,
            splits=1)`), within K1's tolerance of the plain version, timed
            in turns with the unsplit launch and beside cuBLAS FP32; its
            bound with the table and with the split table it reads;
       K3 tracker scan + select_stable in one launch, bitwise (bit
            patterns) to the plain scan + select_stable on random and
            main-path raws at S=128 x N=64 and random raws and onsets at
            S=1 x N=4096; timed on the main-path raws, on random raws at
            S=128 x N=256 and on their first 64 frames, and at S=1 x
            N=4096; the per-frame cost as the slope between those N=64 and
            N=256 random raws (ns, and cycles at the SM clock nvidia-smi
            samples while the timed launches run: `SmClock`, as for every
            cycle figure here);
       K4 onset scan, bitwise (bit patterns, every output and the final
            state) to the plain scan on the scene's "fft" magnitudes at
            S=128 x N=1024, at S=1 x N=4096 and at S=2048 x N=256 (more
            blocks than the card holds at once) with tick-suppressed and
            held frames; at least two blocks a SM at 129 bins (the
            occupancy calculator); timed at the segmented step (S=128 x
            N=4096) and its first 1,024 frames, at S=1 x N=131072 (the
            sequential analyzer's chunk), and at the full step's calls
            [128, 7485, 129] and [2048, 7485, 129] (each stream a chunk of
            the scene through K11) beside their bounds; the per-frame cost
            as the slope between N=1024 and N=4096; the plain scan timed
            once at S=128 x N=4096;
       K5 noise-floor scan, bitwise (bit patterns, the effective floors and
            the final state) to the plain scan on the step's K1 magnitudes
            (S=128 x N=64, band 464) from fresh and carried states, at S=1 x
            N=4096 with a full-width state (the sequential analyzer's call)
            and at full width (band=None); timed at S=128 x N=64 alone and
            through the wrapper with the 1,025-wide state (the kernel
            writes the state above the band), and at S=1 x N=4096, with
            its share of the byte bound and at S=1 beside its chain bound
            (port_tools/k5_chain.py, built beside the package: the floor
            recurrence alone, one warp of 32 bins, its frames in shared
            memory); the plain scan timed once at
            S=128 x N=64;
       K11 rfft_mag, the Hann x real-FFT magnitude ("fft") at the shapes of
            port_tools/k11_probe.py SHAPES (the full step's pitch call
            [128, 933, 2048] banded to 427 bins with each stream's first
            frame at full width, and at full width, its onset call [128,
            7485, 256], segmented onsets [128, 4096, 256], the live slot's
            [1, 16, 256], a pool wave's [33, 16, 256], a feature chunk
            [8192, 2048]): bitwise to `rfft_mag_fixed_np` (its operation
            order in numpy) on 4 streams (1,024 frames) of each, within
            1e-5 of each frame's peak of cuFFT (its plain version, which
            is the library call too) on all; the band and the first frames
            bitwise the full width's at the full step's pitch call, and a
            frame's bits alone and at B = 1, 33 and 128 at its calls; the
            spectral gate
            at 2,048 and 256 points; timed in turns with cuFFT beside its
            bytes bound and the issue floor of its order (its float32
            instructions at 128 lanes an SM a clock, at the SM clock
            sampled while it runs), saying which is larger;
  4. the main path: `segmented_pitch_analysis` over a 30-minute mixed scene at
     the default geometry (128 segments x 64-frame chunks; transfer="auto",
     pipelined at this length), cold then warm, with
     the launch counts of K1, K10, K3 and K5 over the warm run (and no plain
     select_stable call, no plain noise-floor step, no plain extraction and
     no K2 launch); then ("feed:" lines) the two host→device feeds,
     `transfer="resident"` (the padded recording uploaded once) and
     `"pipelined"` (page-locked double buffers, a block a step, copied on
     a stream of its own): the pipelined run's launches as resident's,
     then each mode once cold and 3 warm calls each in turns, every
     output bitwise to the resident one: the median wall and its spread,
     the card ms from the call's start to its first step's first kernel
     (CUDA events), the bytes each copies; the 30-minute scene as int16
     (scaled and clipped as JAX's test does); the copies' rates (the
     padded recording from pageable memory, page-locked blocks); the sweep
     at 5, 10, 30 and 60 minutes of float32 input (prefixes of
     `mixed_scene(3600 s, seed=0)`) and its crossover against
     `segmented.AUTO_PIPELINED_MIN_SECONDS`, with `transfer="auto"`
     resolving as the constant says; then
     `segmented_pitch_analysis_batch` over 8 takes of 30 s;
  5. agreement: the sequential `PitchAnalyzer` on the first 5 minutes against
     the segmented run (segment 0 bitwise, >= 99.9% of frames);
  6. `analyze_buffer_segmented` over the 30-minute scene, cold then warm, with
     K1, K10, K3, K4, K5 and K11's launch counts over the warm run (K4's
     row takes its count) and no plain onset, noise-floor or extraction step;
     the warm wall split by pass; `segmented_onset_analysis` with
     `transfer="pipelined"` bitwise to resident (walls and first kernel
     as in phase 4);
  7. `analyze_buffer` over the first minute (per-frame structs);
  8. `segmented_onset_analysis_batch` over the 8 takes;
  9. onset agreement: the sequential `OnsetAnalyzer` on the first 5 minutes
     against `segmented_onset_analysis` (segment 0 bitwise, the fired-frame
     sets identical);
 10. the live engine: `AudioEngine(device="cuda")` in the app's practice
     configuration (tuner and onset detection over a 60 s mixed scene at
     48 kHz, 1,024-sample slots, loopback calibration), `prepare()` first,
     then 2,812 slots, each one fused per-slot program: the host ms a slot
     (p50, p99, max, and the slots over the 21.33 ms budget), K1, K10,
     K3-K5's and K11's launches over the run and a slot, which host reducer ran, and each
     kernel's time at its live shape beside its bound; 200 slots with the
     host ms split by stage (reducer, inputs, dispatch, readback, posts);
     a profiled window of 100 slots (kernel launches and card-busy ms a
     slot); the same first
     10 s with the sequential consumers, bitwise equal slot for slot; the
     same 10 s on the CPU (the plain versions), onset events identical,
     tuner notes equal on >= 99.9% of slots and floats within the CPU
     test's tolerances; and a NaN sample at 5 s, card against CPU the same
     way;
 11. the classroom: `EnginePool` on the card.  Three gates, bitwise on
     every consumer-visible output and every carry (5 s of
     `mixed_scene(seed=100+k)` a student, 48 kHz, tuner and onset
     detection, loopback calibration): 4 pooled students at depth 1
     against 4 solo engines at depth 0 (at capacity 4, and at capacity 33
     with 29 inert pad lanes), one student at depth 1 against 0, and at
     aggregation 4 against 1.  Then the classroom run: 32 students
     at depth 1, capacity 33, `prepare()`, 20 s (937 waves), a 33rd
     student joining at 5 s: host ms a wave (p50/p99/max), ms an
     engine-slot, waves over 21.33 ms, K1, K10, K3-K5's and K11's launches
     a wave over waves 600-699 (1 each, asserted) and over the run, a profiled window of 50
     waves (CUDA kernels and card-busy ms a wave), rollbacks.  Then the
     sweep: K = 1, 8, 16, 32, 64, 128 students for 5 s each, host ms a
     wave p50/p99 and the largest K whose p99 fits 21.33 ms; and each
     kernel at the pool's shape (C = 33) held against its plain version
     at phase 3's tolerances, then timed beside its bound;
 12. the batched full chain ("fullstep:" lines): K6 (the reducer scan,
     exact and gate-only) and K7 (the dynamics scan, hist and exact)
     bitwise to their plain versions on the card at the full step's
     shapes (128 streams x 479,232 samples, then 24,000 more with the
     state carried; 128 x 468 slots fresh, carried and from session
     states), on the fleet's audio with digital silence, a NaN sample and
     quiet sections, each timed there beside its plain version and bound; `make_batched_full_step(None, 48000.0)` over 128 streams x 3
     chained chunks of 9.98 s: host ms a step, seconds of audio a wall
     second, K3-K7 and K10 launched once a step each and K11 twice (both
     STFTs; asserted), no plain scan step, the step (its pitch STFT
     banded to the 427 bins the extraction reads, with each stream's
     first frame at full width) bitwise to the step with full-width pitch
     magnitudes over the chained steps (every output and the states), the
     port's kernels in a step by CUDA events (K11's pitch and onset calls
     apart), and the step's CUDA kernels, card-busy ms and idle
     share under torch.profiler in processes of their own
     (port_tools/fullstep_profile.py), with K11 and, before it, with the
     plain STFT (`--stft plain`, cuFFT): the STFTs' card ms and share
     before and after; K10
     at the step's call (119,424 frames) bitwise to the plain extraction
     and timed beside its bound (and achieved GB/s), the plain
     extraction's card time by
     torch.profiler, and that of the path K10 took over (the same torch
     ops around K2, K2 by CUDA events); K5 at the step's call (128 x 933
     frames of 427-float rows, band 426, the first frames at full width)
     from the first step's fresh state and from the state it leaves,
     bitwise to the plain scan, timed
     beside its bound and its events in the step; the
     gates: one stream's bits equal at B = 1, 33 and 128 with no
     equalization (and K11's magnitudes of each stream alone bitwise the
     batch's), hist against
     exact AGC on the 25 s scene (>= 99.9% of pitch frames, fired
     identical), card against CPU (2 streams x 2 s: with the CPU's FFT on
     the card every decision equal, with K11 the flips within 1%), each of
     8 streams
     detecting its own tone; and `warmup_mode="floor"` on the 30-minute
     pitch path against "full" (differing on exactly the frames where the
     JAX package's two modes differ on this scene, segment 0's prefix
     bitwise), warm wall of each;
 13. the debug surface ("devtools:" lines): K1 at full width (1,025 bins)
     at [1, 2, 2048] and [1, 4096, 2048] within 1e-5·max of its plain
     version, through the float64 spectral gate, its bins [0, 465) bit
     for bit the banded launch's, timed in turns with the cuBLAS FP32
     product; K5 over all 1,025 bins from a state that ran banded (S=1 x
     N=4096), bitwise to the plain scan; `PitchAnalyzer` with a
     `DebugRecorder` over 60 s of the scene (stable outputs bitwise those
     without a recorder, one record a frame, K1/K10/K3/K5 launches, warm
     wall); the live engine of phase 10 with a `JsonlStreamRecorder` for
     20 s (no fused slot, onset events and tuner notes equal to the
     sequential consumers without a recorder, one JSONL record a frame,
     host ms a slot); and `python -m audio_analyzer_rs_tpu_torch.cli`
     analyze (60 s, --segments auto) and tuner --debug-jsonl (10 s) as
     subprocesses on the card (exit 0, outputs parsed, wall);
 14. the probe's gathers and the mesh ("gather:" and "mesh:" lines): K8
     (lane_gather) and K9 (comb_gather12) through port_tools/
     gather_probe.py's five cases and its index edge cases (wrapped
     negative and out-of-range indices, -0.0), bitwise to numpy and to the
     plain versions, with the launch counts of that run; each timed at
     [8, 7296] beside its bound, K8 in turns with torch.gather.  The mesh
     at world size 1 (an NCCL group through a FileStore):
     `segmented_pitch_analysis(mesh=...)` over the 30-minute scene bitwise
     to phase 4's outputs (warm wall, K1/K10/K3/K5 launched), and with
     `transfer="pipelined"` (each rank staging its own rows), one
     `make_batched_full_step(mesh, ...)` step at phase 12's configuration
     bitwise to phase 12's first step, `make_pooled_wave_step` over 33
     lanes x 3 chained waves bitwise to `fused_slot_pool_step`.  Then two
     ranks on the one card (spawned processes, gloo: NCCL refuses two ranks
     on one GPU): the full step at B = 16 (8 a rank) bitwise to world size
     1 (the step as shipped, no equalization), the
     segmented pitch path over the first minute at 8 segments bitwise, and
     the pooled wave (8 lanes x 3 waves) bitwise;
 15. the oracles on the card's machine ("oracle:" lines; the port's float64
     loop transcriptions of the Rust reference, no JAX):
     `make_batched_full_step` over JAX's divergence scene
     (`mixed_scene(25 s, 48 kHz, seed=3)`, whole slots) in lane 0, "hist"
     and "exact", at B = 1 and at B = 128 with phase 12's streams in the
     other lanes and no STFT equalization, lane 0 against `full_chain_np`
     at JAX's gates (stable sets on >= 98% of frames, onset frames on >=
     99.9%, hist against exact >= 99.9% with fired equal) and no flip
     between B = 1 and B = 128; K5 at phase 3's S = 1 call against
     `noise_floor_np(fma=True)` (rtol 1e-6, atol 2^-126) and K4 at its S =
     1 call against `onset_np` (fired equal, velocities within rtol 1e-6).
Phases 4, 6 and 10-14 count the launches of the kernels their paths run
(K2's comb runs inside K10; K11 on the onset and full-step paths) and fail on a plain extraction (`ops/pitch.py`
`_extract`) run on the card.
Then the kernel table as one JSON line, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line; with no CUDA device the script exits 1 and prints no
result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "audio_analyzer_rs_tpu_torch"
SR = 44100.0
TIMING_RUNS = 20
KERNEL_REPS = 10       # back-to-back launches a timing sample (cuda_times)
HOST_AHEAD_CYCLES = 4_000_000   # ~2 ms of card time, > 10 wrapper calls
K1_REL_TOL = 1e-5
# K11 against cuFFT (the plain version): max |d| <= this x the frame's
# peak magnitude (two float32 FFTs summing in other orders).
K11_PEAK_TOL = 1e-5
MIN_AGREEMENT = 0.999
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12        # tensor cores
FP32_FLOPS = 67e12         # CUDA cores


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_times(fn, reps: int = 1) -> list[float]:
    """CUDA-event times of fn() in ms, TIMING_RUNS samples after one warm
    call.  Each sample brackets `reps` back-to-back calls with one pair of
    events and divides by reps.  With reps > 1 the card first spins for
    HOST_AHEAD_CYCLES, so the host has queued all reps calls before the
    first runs: the events time the card, not the wrappers' host time."""
    import torch
    fn()
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if reps > 1:
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


class SmClock:
    """The SM clock (MHz) while a block of timed launches runs: nvidia-smi
    samples it every 20 ms, and `mhz` is the median of the samples taken
    inside the block ("sampled"), or the card's clocks.max.sm where none
    fell inside it ("max").  A cycle figure is a time times this clock;
    the clock read once at an idle moment (345 MHz where the card ran at
    1,980 under the load) is not one to convert with."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        t0 = time.monotonic()
        while not self.samples and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        self.start = time.monotonic()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append((time.monotonic(),
                                     float(line.split()[0])))
            except (ValueError, IndexError):
                pass

    def __exit__(self, *exc):
        end = time.monotonic()
        self.proc.terminate()
        self.proc.wait()
        self.reader.join(timeout=1.0)
        inside = [v for t, v in self.samples if self.start <= t <= end]
        if inside:
            self.mhz, self.source = statistics.median(inside), "sampled"
        else:
            self.mhz, self.source = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0]), "max"
        return False

    def cycles(self, ns: float) -> str:
        """ns as "<ns> ns = <cycles> cycles at <MHz> MHz (<source>)"."""
        return (f"{ns:,.1f} ns = {ns * self.mhz / 1e3:,.0f} cycles at "
                f"{self.mhz:.0f} MHz ({self.source})")


def cuda_ms(fn, reps: int = 1) -> float:
    """Median of cuda_times(fn, reps)."""
    return statistics.median(cuda_times(fn, reps))


def in_turns(kernel, yardstick, yardstick_reps: int):
    """Times kernel and yardstick in turns (kernel, yardstick, kernel,
    yardstick) → (kernel ms, yardstick ms, the four turn medians); each ms
    is the median of both of its turns' samples."""
    k1, y1, k2, y2 = (cuda_times(f, r) for f, r in (
        (kernel, KERNEL_REPS), (yardstick, yardstick_reps),
        (kernel, KERNEL_REPS), (yardstick, yardstick_reps)))
    return (statistics.median(k1 + k2), statistics.median(y1 + y2),
            [statistics.median(t) for t in (k1, y1, k2, y2)])


def same_bits(a, b) -> bool:
    """Equal bit for bit: floats compared as int32 patterns (-0.0 != 0.0)."""
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k11_held(frames, win, label: str) -> float:
    """K11 on `frames` (x win) held bit for bit to `rfft_mag_fixed_np`, its
    operation order transcribed in numpy, and within K11_PEAK_TOL of each
    frame's peak of the plain version (cuFFT) → max |K11 - plain|."""
    import torch
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    got = hopper_rfft.rfft_mag(frames, None, win)
    want = hopper_rfft.rfft_mag_fixed_np(frames.cpu().numpy(), None,
                                         win.cpu().numpy())
    assert same_bits(got.cpu(), torch.from_numpy(want)), \
        f"K11 {label}: differs from rfft_mag_fixed_np"
    return _k11_near_plain(frames, win, label)


def _k11_near_plain(frames, win, label: str) -> float:
    """K11 within K11_PEAK_TOL of each frame's peak of the plain version
    (cuFFT) → max |K11 - plain|."""
    import torch
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    got = hopper_rfft.rfft_mag(frames, None, win)
    plain = hopper_rfft.rfft_mag_plain(frames, None, win)
    torch.cuda.synchronize()
    peak = plain.abs().amax(-1, keepdim=True)
    err = (got - plain).abs()
    assert bool((err <= K11_PEAK_TOL * peak).all()), \
        f"K11 {label}: {float((err / peak.clamp(min=1e-30)).max())} of peak"
    return float(err.max())


def k11_phase(rows, probe, dev) -> None:
    """Phase 3's K11 row: the windowed real-FFT magnitude ("fft") at the
    shapes its paths give it (port_tools/k11_probe.py SHAPES): bit for bit
    its numpy transcription on 4 streams (1,024 frames) of each, within
    K11_PEAK_TOL of cuFFT (its plain version, which is the library call
    too) on all of them; a frame's bits alone and in batches of 1 and 33
    streams at the full step's two calls; the spectral gate at 2,048 and
    256 points on `probe`; timed in turns with cuFFT beside its bound."""
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import hopper_rfft
    from audio_analyzer_rs_tpu_torch.ops.fft import hann
    from audio_analyzer_rs_tpu_torch.ops.stft import (FIDELITY_MAX_REL_MSE,
                                                      spectral_rel_mse)
    import torch
    k11_probe = _tool("k11_probe")
    audio48 = gen.mixed_scene(120.0, FULL_SR, seed=0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k11_err, k11_shapes, k11_parts = 0.0, {}, []
    for name, shape in k11_probe.SHAPES.items():
        fr, src = k11_probe.views(audio48, shape, dev)
        band = shape[4]
        w = fr.shape[-1]
        win_k = hann(w, dev)
        few = fr[:4] if fr.dim() == 3 else fr[:1024]
        k11_err = max(k11_err, k11_held(few, win_k, name),
                      _k11_near_plain(fr, win_k, name))
        if name.startswith("full step"):
            whole = hopper_rfft.rfft_mag(fr, None, win_k)
            if band is not None:
                # The band and the first frames bitwise the full width's.
                got, first = hopper_rfft.rfft_mag_first(fr, band, win_k)
                assert same_bits(got, whole[..., :band].contiguous()), name
                assert same_bits(first, whole[:, 0].contiguous()), name
                del got, first
            for b in (1, 33):
                assert same_bits(hopper_rfft.rfft_mag(fr[:b], None, win_k),
                                 whole[:b]), (name, b)
            for i in (0, 77, 127):
                assert same_bits(hopper_rfft.rfft_mag(fr[i:i + 1, 9:13],
                                                      None, win_k),
                                 whole[i:i + 1, 9:13]), (name, i)
            del whole
        with SmClock() as clock:
            t_ms, lib_ms, turns = in_turns(
                lambda: k11_probe.call(fr, win_k, band),
                lambda: k11_probe.plain_call(fr, win_k, band), KERNEL_REPS)
        rows_first = k11_probe.first_rows(fr, band)
        nb, flops = k11_work(fr, src.numel(), band, rows_first)
        b_ms, b_by = bound(nb, flops, FP32_FLOPS)
        ops = k11_issue_ops(fr, band, rows_first)
        i_ms = issue_floor_ms(ops, clock.mhz, sms)
        k11_shapes[name] = dict(frames=list(fr.shape), band=band, ms=t_ms,
                                plain_ms=lib_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                gb_per_s=nb / t_ms / 1e6,
                                issue_floor_ms=i_ms, sm_mhz=clock.mhz,
                                sm_clock=clock.source)
        k11_parts.append(
            f"{name} {list(fr.shape)}"
            + ("" if band is None else f" band {band} + first frames")
            + f" {t_ms:.4f} ms vs cuFFT {lib_ms:.4f} ms (turns "
            f"{'/'.join(f'{t:.4f}' for t in turns)}), bytes bound "
            f"{b_ms:.4f} ms ({b_by}: {nb / 1e6:.1f} MB; {b_ms / t_ms:.1%} "
            f"of it, {nb / t_ms / 1e6:.0f} GB/s), the order's issue floor "
            f"{i_ms:.4f} ms ({ops / fr[..., 0].numel():,.0f} float32 "
            f"instructions a frame at {clock.mhz:.0f} MHz, {clock.source}; "
            f"{'issue' if i_ms > b_ms else 'bytes'} the larger)")
        del fr, src
    k11_mse = {w: spectral_rel_mse(probe, w, w // 4, "fft", dev)
               for w in (2048, 256)}
    assert all(m < FIDELITY_MAX_REL_MSE for m in k11_mse.values()), k11_mse
    main_k11 = k11_shapes["full step, pitch, banded"]
    say(f"K11 rfft_mag (Hann x real-FFT magnitude, one fixed order a frame): "
        f"bitwise to rfft_mag_fixed_np on 4 streams of each shape, within "
        f"{K11_PEAK_TOL:g}x of each frame's peak of cuFFT on all (max|d| "
        f"{k11_err:.3e}); the full step's band and first frames bitwise "
        f"its full width's; a frame's bits equal alone and at B = 1, 33 "
        f"and 128 at the full step's calls; spectral rel MSE "
        f"{k11_mse[2048]:.3e} (2048) / {k11_mse[256]:.3e} (256) (< "
        f"{FIDELITY_MAX_REL_MSE:g}); " + "; ".join(k11_parts))
    rows.append(dict(name="K11 rfft_mag (windowed real-FFT magnitude; "
                     "port-only, its JAX counterpart left to XLA)",
                     route="cuda", source=f"{PKG}/csrc/rfft_mag.cu",
                     replaces="audio_analyzer_rs_tpu/ops/fft.py:77",
                     max_abs_err=k11_err, ms=main_k11["ms"],
                     plain_ms=main_k11["plain_ms"],
                     bound_ms=main_k11["bound_ms"],
                     bound_by=main_k11["bound_by"],
                     library_ms=main_k11["library_ms"],
                     issue_floor_ms=main_k11["issue_floor_ms"],
                     shapes=k11_shapes, spectral_rel_mse=k11_mse))


def k11_work(frames, span_samples: int, band: int | None = None,
             first_rows: int = 0) -> tuple[int, float]:
    """(bytes, flops) of K11 on [..., N, W] frames read from `span_samples`
    samples into `band` bins (None: W/2 + 1) and `first_rows` frames at
    full width: each sample read once, each magnitude written once, the
    window and the table; ~2.5 W log2 W flops a frame (a half-length
    complex FFT)."""
    w = frames.shape[-1]
    n = frames.numel() // w
    band = w // 2 + 1 if band is None else band
    nb = (span_samples * 4 + (n * band + first_rows * (w // 2 + 1)) * 4
          + w * 4 + (w + 1) * 8)
    return nb, 2.5 * w * (w.bit_length() - 1) * n


# K11's fixed order, in float32 instructions (csrc/rfft_mag.cu, one
# instruction a product or sum: no FMA): a butterfly 4 products and 6 sums;
# a bin 16 products, sums and the max of `magnitude` as
# `rfft_mag_fixed_np` spells them, and ~14 more for its scale's selects and
# __fsqrt_rn's instruction sequence.
K11_BUTTERFLY_OPS = 10
K11_BIN_OPS = 30
SM_FP32_LANES = 128           # float32 lanes an SM issues a clock


def k11_issue_ops(frames, band: int | None = None,
                  first_rows: int = 0) -> float:
    """The float32 instructions of K11's order on [..., N, W] frames into
    `band` bins (None: W/2 + 1) and `first_rows` frames at full width: a
    frame's W window products, its (W/4) log2(W/2) butterflies and its
    bins."""
    w = frames.shape[-1]
    n = frames.numel() // w
    band = w // 2 + 1 if band is None else band
    frame = w + K11_BUTTERFLY_OPS * (w // 4) * (w.bit_length() - 2)
    return (n * (frame + K11_BIN_OPS * band)
            + first_rows * K11_BIN_OPS * (w // 2 + 1))


def issue_floor_ms(ops: float, mhz: float, sms: int) -> float:
    """`ops` float32 instructions over SM_FP32_LANES lanes an SM a clock
    on `sms` SMs at `mhz`."""
    return ops / (sms * SM_FP32_LANES * mhz * 1e6) * 1e3


# The wrapper module of each path kernel, by the tag that starts its row's
# name.
KERNEL_MODULES = {"K1": "hopper_stft", "K2": "hopper_comb",
                  "K3": "hopper_tracker", "K4": "hopper_onset",
                  "K5": "hopper_noisefloor", "K10": "hopper_extract",
                  "K11": "hopper_rfft"}
# The kernels the pitch and onset paths launch (K2's comb runs inside K10;
# K11 is the onset STFT).
PATH_KERNELS = ("K1", "K10", "K3", "K4", "K5", "K11")
# PATH_KERNELS and K2, whose own entry the paths must not launch: a phase
# zeroes and reads K2's count with theirs and holds it at 0.
COUNTED = PATH_KERNELS + ("K2",)


def off_path_zero(launches: list) -> list:
    """The path's counts of a COUNTED-ordered list, K2's (the last) held
    at 0."""
    assert launches[-1] == 0, f"K2 launched {launches[-1]} times outside K10"
    return launches[:-1]


def counters_of(tags) -> tuple:
    """The wrapper modules (each with its LAUNCHES count) of these tags."""
    import importlib
    return tuple(importlib.import_module(f"{PKG}.ops.{KERNEL_MODULES[t]}")
                 for t in tags)


def row_of(rows, tag: str) -> dict:
    """The kernel row whose name starts with `tag` ("K1", "K1-live", ...)."""
    return next(r for r in rows if r["name"].split()[0] == tag)


class PlainExtractions:
    """Counts the plain extraction's calls (ops/pitch.py `_extract`) while
    entered: on CUDA tensors `extract_pitches` must launch K10 instead."""

    def __enter__(self):
        from audio_analyzer_rs_tpu_torch.ops import pitch
        self.calls, self.saved = 0, pitch._extract

        def counted(*args, **kwargs):
            self.calls += 1
            return self.saved(*args, **kwargs)
        pitch._extract = counted
        return self

    def __exit__(self, *exc):
        from audio_analyzer_rs_tpu_torch.ops import pitch
        pitch._extract = self.saved
        return False


def random_raws(rng, s: int, n: int):
    """Random polyphonic raws that often continue (the JAX tracker test's)."""
    import numpy as np
    rf = rng.uniform(50.0, 2000.0, (s, n, 8)).astype(np.float32)
    for i in range(1, n):
        keep = rng.random((s, 8)) < 0.7
        rf[:, i] = np.where(keep, rf[:, i - 1] * (1 + rng.normal(
            0, 0.01, (s, 8)).astype(np.float32)), rf[:, i])
    rs = rng.uniform(0.1, 5.0, (s, n, 8)).astype(np.float32)
    rv = rng.random((s, n, 8)) < 0.6
    on = rng.random((s, n)) < 0.08
    return rf, rs, rv, on


def frame_agreement(a_freqs, a_valid, b_freqs, b_valid) -> float:
    """Share of frames whose stable pitch sets agree at 0.1 Hz."""
    import numpy as np
    n = len(a_freqs)
    agree = sum(sorted(np.round(a_freqs[i][a_valid[i]], 1))
                == sorted(np.round(b_freqs[i][b_valid[i]], 1))
                for i in range(n))
    return agree / max(n, 1)


FEEDS = ("resident", "pipelined")
FEED_REPS = 3                     # warm calls a transfer mode, in turns
SWEEP_MINUTES = (5, 10, 30, 60)   # the transfer="auto" crossover's sweep


def first_kernel_call(fn, step_name: str):
    """fn() → (its result, its host wall in s, the card ms from the call's
    start to its first step's first kernel).  One CUDA event is recorded
    as the call starts, one as its first step (`segmented.<step_name>`) is
    entered, both on the compute stream: the card reaches the second when
    every copy and kernel that step waits on has run."""
    import torch
    from audio_analyzer_rs_tpu_torch.models import segmented
    start = torch.cuda.Event(enable_timing=True)
    first = torch.cuda.Event(enable_timing=True)
    step, marked = getattr(segmented, step_name), []

    def marking(*args, **kwargs):
        if not marked:
            first.record()
            marked.append(1)
        return step(*args, **kwargs)
    torch.cuda.synchronize()
    setattr(segmented, step_name, marking)
    try:
        t0 = time.perf_counter()
        start.record()
        out = fn()
        wall = time.perf_counter() - t0
    finally:
        setattr(segmented, step_name, step)
    assert marked, f"{step_name} was not called"
    first.synchronize()
    return out, wall, start.elapsed_time(first)


def feed_turns(call, step_name: str = "_vmapped_step") -> dict:
    """call(mode) for both transfer modes: once each cold, then FEED_REPS
    warm calls each in turns (resident first, then pipelined first, ...),
    every output bitwise to the first resident one → {mode: {"walls",
    "first_ms"}}, with each mode's median and spread (max - min)."""
    import numpy as np
    want = call("resident")
    for a, b in zip(call("pipelined"), want):
        assert a.dtype == b.dtype and np.array_equal(a, b), "pipelined cold"
    res = {m: {"walls": [], "first_ms": []} for m in FEEDS}
    for rep in range(FEED_REPS):
        for mode in (FEEDS if rep % 2 == 0 else FEEDS[::-1]):
            out, wall, first = first_kernel_call(lambda: call(mode),
                                                 step_name)
            for a, b in zip(out, want):
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    f"{mode} differs from the cold resident run"
            res[mode]["walls"].append(wall)
            res[mode]["first_ms"].append(first)
    for r in res.values():
        r["median"] = statistics.median(r["walls"])
        r["spread"] = max(r["walls"]) - min(r["walls"])
        r["first"] = statistics.median(r["first_ms"])
    return res


def default_plan(n_samples: int, chunk_frames: int = 64, warmup: int = 128,
                 window: int = 2048, hop: int = 512):
    """The stream plan `segmented_pitch_analysis` makes for a recording of
    n_samples at its default segment count."""
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.utils.framing import num_frames
    n_total = num_frames(n_samples, window, hop)
    segs = segmented.auto_segments(n_total, warmup)
    segs = max(1, min(segs, max(n_total // chunk_frames, 1)))
    return segmented._plan_streams(n_total, segs, warmup, chunk_frames,
                                   window, hop)


def fed_bytes(n_samples: int, itemsize: int) -> dict:
    """Bytes each transfer mode copies host→device for the pitch path over
    n_samples: resident the padded recording, pipelined every step's [S,
    chunk_samples] block."""
    plan = default_plan(n_samples)
    return {"resident": max(plan.max_sample, n_samples) * itemsize,
            "pipelined": (plan.segments * plan.steps * plan.chunk_samples
                          * itemsize)}


def feed_text(res: dict, moved: dict) -> str:
    return "; ".join(
        f"{m} {res[m]['median']:.4f} s (spread {res[m]['spread']:.4f}, "
        f"first kernel at {res[m]['first']:.2f} ms, "
        f"{moved[m] / 1e6:.0f} MB copied, "
        f"{moved[m] / res[m]['median'] / 1e9:.2f} GB/s of the wall)"
        for m in FEEDS)


def link_rates(dev, padded, rows: int, chunk_samples: int) -> tuple:
    """The host→device rate of each mode's copy, by CUDA events (median of
    3): the padded recording from pageable memory in one copy (resident),
    and 21 page-locked [rows, chunk_samples] float32 blocks copied with
    non_blocking=True (pipelined) → (pageable GB/s, page-locked GB/s)."""
    import numpy as np
    import torch
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    pageable, pinned = [], []
    host = torch.from_numpy(padded)
    block = torch.empty((rows, chunk_samples), dtype=torch.float32,
                        pin_memory=True)
    block.copy_(torch.from_numpy(np.ascontiguousarray(
        padded[:rows * chunk_samples].reshape(rows, chunk_samples))))
    for _ in range(3):
        torch.cuda.synchronize()
        begin.record()
        on_card = host.to(dev)
        end.record()
        end.synchronize()
        pageable.append(host.nbytes / begin.elapsed_time(end) / 1e6)
        del on_card
        begin.record()
        copies = [block.to(dev, non_blocking=True) for _ in range(21)]
        end.record()
        end.synchronize()
        pinned.append(21 * block.nbytes / begin.elapsed_time(end) / 1e6)
        del copies
    return statistics.median(pageable), statistics.median(pinned)


def feed_phase(card: str, audio, launches_main: list) -> None:
    """Phase 4b: the two transfer modes of the 30-minute pitch path (float32
    and int16), their launches, the link rates of their copies, and the
    sweep that sets segmented.AUTO_PIPELINED_MIN_SECONDS."""
    import math
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.ops import hopper_comb
    t_phase = time.perf_counter()

    def pitch(x):
        return lambda mode: segmented.segmented_pitch_analysis(
            x, SR, transfer=mode)

    # Each mode's launches and plain extractions, as the main path's.
    counters = counters_of(("K1", "K10", "K3", "K5"))
    for mode in FEEDS:
        for mod in counters + (hopper_comb,):
            mod.LAUNCHES = 0
        with PlainExtractions() as plain_x:
            segmented.segmented_pitch_analysis(audio, SR, transfer=mode)
        launches = [mod.LAUNCHES for mod in counters]
        assert launches == launches_main, (mode, launches, launches_main)
        assert not plain_x.calls and hopper_comb.LAUNCHES == 0

    i16 = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    res16 = feed_turns(pitch(i16))
    moved16 = fed_bytes(len(i16), 2)
    plan = default_plan(len(audio))
    padded = np.pad(audio, (0, max(0, plan.max_sample - len(audio))))
    pageable, pinned = link_rates(torch.device("cuda"), padded,
                                  plan.segments, plan.chunk_samples)
    del padded, i16
    say(f"feed: 30 min int16, pipelined bitwise to resident over "
        f"{FEED_REPS} warm calls each in turns: {feed_text(res16, moved16)}; "
        f"launches K1/K10/K3/K5 (float32) {launches} in each mode, as the "
        f"main path's, plain extractions 0; copies: the padded "
        f"recording from pageable memory {pageable:.2f} GB/s, page-locked "
        f"{plan.segments} x {plan.chunk_samples} blocks {pinned:.2f} GB/s "
        f"(CUDA events)")

    # The sweep: prefixes of one 60-minute scene are the shorter scenes.
    scene = gen.mixed_scene(60 * max(SWEEP_MINUTES), SR, seed=0)
    assert np.array_equal(scene[:len(audio)], audio)
    crossover = math.inf
    for minutes in SWEEP_MINUTES:
        x = scene[:int(minutes * 60 * SR)]
        res = feed_turns(pitch(x))
        moved = fed_bytes(len(x), 4)
        gain = res["resident"]["median"] - res["pipelined"]["median"]
        wins = gain > res["resident"]["spread"] + res["pipelined"]["spread"]
        if wins and math.isinf(crossover):
            crossover = minutes * 60.0
        auto = segmented._resolve_transfer("auto", "pitch", len(x), SR, None)
        want = ("pipelined" if len(x) >= segmented.AUTO_PIPELINED_MIN_SECONDS
                * SR else "resident")
        assert auto == want, (minutes, auto, want)
        say(f"feed: {minutes} min float32, pipelined bitwise to resident: "
            f"{feed_text(res, moved)}; resident - pipelined {gain:+.4f} s "
            f"({'beyond' if wins else 'within'} the two spreads); "
            f"transfer=\"auto\" resolves to {auto}")
    del scene
    constant = segmented.AUTO_PIPELINED_MIN_SECONDS
    say(f"feed: the sweep's crossover (the shortest length at which "
        f"pipelined beats resident by more than the two spreads) "
        f"{crossover} s; AUTO_PIPELINED_MIN_SECONDS = {constant} "
        f"({'agrees' if crossover == constant else 'differs'}); {card}; "
        f"phase 4b took {time.perf_counter() - t_phase:.0f} s")


LIVE_SR = 48000.0
LIVE_SLOT = 1024
LIVE_SLOTS = 2812                 # 60 s of 21.33 ms slots
LIVE_BUDGET_MS = LIVE_SLOT / LIVE_SR * 1e3
PARITY_SLOTS = 469                # the first 10 s
CENTS_TOL = 0.02                  # tests/test_torch_engine.py's tolerances
VELOCITY_TOL = 1e-4
TUNER_EXACT = ("label", "mode", "system", "base_freq", "key")


def live_session(scene, device: str, slots: int, fused: bool = True,
                 prepare: bool = False, on_slot=None, recorder=None):
    """The app's practice session on `device`: returns (engine, per-slot
    polls (tuner, onsets, dynamics), per-slot host ms of advance(),
    prepare()'s result or None).  on_slot(i) runs before slot i; a devtools
    `recorder` is attached before the consumers start."""
    from audio_analyzer_rs_tpu_torch import AudioEngine
    from audio_analyzer_rs_tpu_torch.api.device import ArraySource
    e = AudioEngine(input_source=ArraySource(scene), sample_rate=LIVE_SR,
                    buffer_size=LIVE_SLOT, loopback_latency_samples=2048,
                    loopback_gain=1.0, device=device)
    e.fused_streaming = fused
    if recorder is not None:
        e.attach_debug_recorder(recorder)
    prep = e.prepare() if prepare else None
    tuner, onset = e.start_tuner(), e.start_onset_detection()
    slot_s = LIVE_SLOT / LIVE_SR
    polls, host_ms = [], []
    for i in range(slots):
        if on_slot is not None:
            on_slot(i)
        t0 = time.perf_counter()
        e.advance(slot_s)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        polls.append((tuner.poll_output(), onset.poll_onsets(),
                      e.poll_dynamics()))
    return e, polls, host_ms, prep


def card_vs_cpu(card, cpu, label: str) -> str:
    """The card's polled JSON against the CPU run's, slot for slot: dynamics
    and onset events (count, raw sample offset, beat) identical, velocity
    within VELOCITY_TOL; tuner note sets equal on >= MIN_AGREEMENT of the
    slots, and where they are, the rest exact and cents within CENTS_TOL.
    Raises on a failure; returns a summary."""
    assert len(card) == len(cpu)
    same_notes = events = 0
    for k, ((ct, co, cd), (pt, po, pd)) in enumerate(zip(card, cpu)):
        assert cd == pd, f"{label} slot {k}: dynamics {cd} != {pd}"
        co, po = json.loads(co), json.loads(po)
        assert len(co) == len(po), f"{label} slot {k}: onsets {co} != {po}"
        for a, b in zip(co, po):
            assert (a["raw_sample_offset"], a["beat_position"]) == (
                b["raw_sample_offset"], b["beat_position"]), (label, k, a, b)
            assert abs(a["velocity"] - b["velocity"]) <= VELOCITY_TOL, \
                (label, k, a, b)
        events += len(co)
        ct, pt = json.loads(ct), json.loads(pt)
        if ct["notes"] != pt["notes"]:
            continue
        same_notes += 1
        for key in TUNER_EXACT:
            assert ct[key] == pt[key], (label, k, key, ct, pt)
        if ct["notes"]:
            assert abs(ct["cents"] - pt["cents"]) <= CENTS_TOL, (label, k)
            assert max(abs(a - b) for a, b in zip(
                ct["accuracies"], pt["accuracies"])) <= CENTS_TOL, (label, k)
    share = same_notes / len(card)
    assert share >= MIN_AGREEMENT, (label, share)
    return (f"{len(card)} slots, {events} onset events identical, tuner "
            f"notes equal on {share:.4%} of slots")


def live_phase(rows, card: str) -> None:
    """Phase 10, the live engine on the card (see the module docstring)."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import (hopper_comb, hopper_extract,
                                                 hopper_noisefloor,
                                                 hopper_onset, hopper_rfft,
                                                 hopper_stft, hopper_tracker,
                                                 noisefloor, onset, pitch,
                                                 tracker)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    counters = counters_of(COUNTED)
    scene = gen.mixed_scene(60.5, LIVE_SR, seed=11)
    dev = torch.device("cuda")

    # The session: prepare(), then the counts set to 0 just before the
    # 2,812 slots and read just after; the launches a slot over slots
    # 1000-1099.
    marks = {}

    def mark(i):
        if i == 0:
            for mod in counters:
                mod.LAUNCHES = 0
        if i in (1000, 1100):
            marks[i] = [mod.LAUNCHES for mod in counters]

    with PlainExtractions() as plain_x:
        e, polls, host_ms, prep = live_session(scene, "cuda", LIVE_SLOTS,
                                               prepare=True, on_slot=mark)
    launches = [mod.LAUNCHES for mod in counters]
    per_slot = [(b - a) / 100 for a, b in zip(marks[1000], marks[1100])]
    assert all(n > 0 for n in off_path_zero(launches)), launches
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    assert e._fused_slots > 0, "the fused path never engaged"
    events = sum(len(json.loads(o)) for _, o, _ in polls)
    assert events > 0, "no onset event in 60 s with percussion"
    assert sum(bool(json.loads(t)["notes"]) for t, _, _ in polls) > 100
    reducer = "native C++" if e.native_reducer is not None else "Python"
    ms = sorted(host_ms)
    p50, p99 = ms[len(ms) // 2], ms[int(0.99 * (len(ms) - 1))]
    over = sum(t > LIVE_BUDGET_MS for t in host_ms)
    say(f"live: AudioEngine on {card}: prepare() {prep['total_s']:.2f} s, "
        f"variants {prep['variants']}; {LIVE_SLOTS} slots of {LIVE_SLOT} "
        f"samples at {LIVE_SR:.0f} Hz, {e._fused_slots} fused; host ms a "
        f"slot p50 {p50:.3f}, p99 {p99:.3f}, max {ms[-1]:.3f}, "
        f"{over} slots over {LIVE_BUDGET_MS:.2f} ms (first slot "
        f"{host_ms[0]:.3f}); launches K1/K10/K3/K4/K5/K11/K2 over the run "
        f"{launches}, a slot over slots 1000-1099 {per_slot}, plain "
        f"extractions 0; host reducer {reducer}; {events} onset events")
    row_of(rows, "K1-live")["launches"] = launches[0]

    # Where a slot's host time goes: 200 slots with the engine's stages
    # timed on the host clock (the readback is where the host waits for
    # the card).
    from audio_analyzer_rs_tpu_torch import runtime
    from audio_analyzer_rs_tpu_torch.api.engine import AudioEngine
    stages = ((AudioEngine, "_fused_inputs", "inputs"),
              (AudioEngine, "_dispatch_slot", "dispatch"),
              (AudioEngine, "_fused_drain_entry", "readback+posts"),
              (AudioEngine, "_fused_post", "posts"),
              (runtime.NativeReducer, "process_slot", "reducer"))
    spent = {key: 0.0 for _, _, key in stages}

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
            return out
        return run

    saved = [(cls, attr, getattr(cls, attr)) for cls, attr, _ in stages]
    for (cls, attr, key), (_, _, fn) in zip(stages, saved):
        setattr(cls, attr, timed(fn, key))
    try:
        _, _, split_ms, _ = live_session(scene, "cuda", 200)
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    per = {key: v * 1e3 / 200 for key, v in spent.items()}
    per["readback"] = per.pop("readback+posts") - per["posts"]
    total = sum(split_ms) / 200
    say(f"live: host ms a slot by stage over 200 slots (of {total:.3f} in "
        f"advance()): " + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
        + f", the rest {total - sum(per.values()):.3f}")

    # Where a slot's time goes: 100 slots under torch.profiler, the CUDA
    # kernels launched and the card's busy time.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        live_session(scene, "cuda", 100)
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
                  for ev in kern)
    n_kern = sum(ev.count for ev in kern)
    top = sorted(kern, key=lambda ev: -getattr(
        ev, "self_device_time_total", getattr(ev, "self_cuda_time_total",
                                              0)))[:6]
    if busy_us > 0:
        say(f"live: profiled 100 slots: {n_kern / 100:.1f} CUDA kernels a "
            f"slot, card busy {busy_us / 100 / 1e3:.4f} ms a slot; top: "
            + "; ".join(f"{ev.key[:48]} x{ev.count / 100:.0f} "
                        f"{getattr(ev, 'self_device_time_total', 0) / 100:.1f}"
                        f" us" for ev in top))
    else:
        say("live: profiled 100 slots: the profiler saw no device time "
            "(card-busy ms a slot not measured)")

    # Each kernel at its live shape (one stream: 2 pitch frames, 16 onset
    # frames), timed beside its bound; inputs from the scene's slot 1000.
    x = torch.from_numpy(scene).to(dev)
    half = 1025
    bin_w = float(np.float32(LIVE_SR) / np.float32(2048))
    kc = pitch.candidate_band(bin_w, half)
    min_bin, max_bin = pitch._bins(bin_w, half, pitch.MIN_FREQ,
                                   pitch.MAX_FREQ)
    buf = x[1000 * LIVE_SLOT:1000 * LIVE_SLOT + 512 + 2048].clone()
    frames = frame_signal(buf, 2048, 512)[None]               # [1, 2, 2048]
    trig = rdft_trig(2048, dev)[:, :2 * (kc + 1)]
    win = hann(2048, dev)
    mags = hopper_stft.dft_mag(frames, trig, win)
    gf = torch.full((1, 2), 0.002, device=dev)
    st_nf = noisefloor.init_state(kc, dev, (1,))
    _, eff = hopper_noisefloor.noise_floor_scan(st_nf, mags, gf, kc)
    pm, frac, m_c, _, _ = pitch._pre_comb(mags[0], eff[0], min_bin, max_bin,
                                          kc)
    m_c = m_c.contiguous()
    pf = pitch.extract_pitches(mags[0], eff[0], bin_w, true_half=half)
    raws = (pf.freqs[None], pf.scores[None], pf.valid[None],
            torch.zeros((1, 2), dtype=torch.bool, device=dev))
    st_tr = tracker.init_state(dev, (1,))
    o_frames = frame_signal(x[1000 * LIVE_SLOT:1000 * LIVE_SLOT + 15 * 64
                              + 256], 256, 64)[None]           # [1, 16, 256]
    o_mags = windowed_mags(o_frames, 256, "fft")
    o_win = hann(256, dev)
    k11_err = k11_held(o_frames, o_win, "at the live shape")
    o_in = (o_mags, torch.full((1, 16), 0.0016, device=dev),
            torch.zeros((1, 16), dtype=torch.bool, device=dev),
            torch.zeros((1, 16), dtype=torch.bool, device=dev))
    st_on = onset.init_state(onset.HALF, dev, (1,))
    k3_out = hopper_tracker.tracker_scan(st_tr, *raws)
    k4_out = hopper_onset.onset_scan(st_on, *o_in)
    live = {
        "K1": (lambda: hopper_stft.dft_mag(frames, trig, win),
               nbytes(buf, trig, win, mags),
               3 * 2 * 2 * 2048 * trig.shape[1], TF32_FLOPS),
        "K2": (lambda: hopper_comb.comb(pm, frac, m_c, half, max_bin),
               nbytes(pm, frac, m_c) + 3 * pm.numel() * 4, 0, FP32_FLOPS),
        "K3": (lambda: hopper_tracker.tracker_scan(st_tr, *raws),
               nbytes(*raws, *k3_out[1]) + 2 * nbytes(*st_tr), 0,
               FP32_FLOPS),
        "K4": (lambda: hopper_onset.onset_scan(st_on, *o_in),
               nbytes(*o_in, *k4_out[1]) + 2 * nbytes(*st_on),
               30 * o_mags.numel(), FP32_FLOPS),
        "K5": (lambda: hopper_noisefloor.noise_floor_scan(st_nf, mags, gf,
                                                          kc),
               2 * 2 * kc * 4 + nbytes(gf) + 2 * (3 * kc * 4 + 1),
               30 * 2 * kc, FP32_FLOPS),
        "K10": (lambda: hopper_extract.extract(
            mags[0], eff[0], bin_w, min_bin, max_bin, pitch.MIN_FREQ,
            pitch.MAX_FREQ, half),
                2 * (2 * kc + 1) * 4 + nbytes(*pf), 30 * 2 * (kc + 1),
                FP32_FLOPS),
        "K11": (lambda: hopper_rfft.rfft_mag(o_frames, None, o_win),
                *k11_work(o_frames, 15 * 64 + 256), FP32_FLOPS),
    }
    parts = []
    counts = dict(zip(COUNTED, zip(launches, per_slot)))
    for name, (fn, nb, ops, rate) in live.items():
        t_ms = cuda_ms(fn, KERNEL_REPS)
        b_ms, b_by = bound(nb, ops, rate)
        n_run, n_slot = counts[name]
        row_of(rows, name).update(
            launches_live=n_run, launches_live_per_slot=n_slot, live_ms=t_ms,
            live_bound_ms=b_ms, live_bound_by=b_by)
        parts.append(f"{name} {t_ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} "
                     f"us, {b_by})")
    row_of(rows, "K11")["live_max_abs_err"] = k11_err
    say("live: kernels at the live shapes (S=1: K1 [1, 2, 2048], K2 [2, "
        f"{kc}], K3 N=2, K4 [1, 16, 129], K5 [1, 2, {kc}], K10 [2, "
        f"{kc + 1}], K11 [1, 16, 256] bitwise to rfft_mag_fixed_np and "
        f"within {K11_PEAK_TOL:g}x of each frame's peak of cuFFT): "
        + "; ".join(parts))
    del x

    # Fused against sequential on the card, the first 10 s: bitwise.
    _, seq, _, _ = live_session(scene, "cuda", PARITY_SLOTS, fused=False)
    for k, (a, b) in enumerate(zip(polls[:PARITY_SLOTS], seq)):
        assert a == b, f"live slot {k}: fused {a} != sequential {b}"
    say(f"live: fused against sequential on the card, the first "
        f"{PARITY_SLOTS} slots: polled JSON bitwise equal")

    # The card against the CPU (the plain versions), the same 10 s.
    t0 = time.perf_counter()
    _, cpu, _, _ = live_session(scene, "cpu", PARITY_SLOTS)
    cpu_s = time.perf_counter() - t0
    say(f"live: card against CPU ({cpu_s:.1f} s on the CPU): "
        + card_vs_cpu(polls[:PARITY_SLOTS], cpu, "card vs CPU"))

    # One NaN sample at 5 s: the card does what the CPU run does.
    nan_scene = scene[:int(10.5 * LIVE_SR)].copy()
    nan_scene[int(5.0 * LIVE_SR)] = np.nan
    _, nan_card, _, _ = live_session(nan_scene, "cuda", PARITY_SLOTS)
    _, nan_cpu, _, _ = live_session(nan_scene, "cpu", PARITY_SLOTS)
    summary = card_vs_cpu(nan_card, nan_cpu, "NaN card vs CPU")
    first = int(5.0 * LIVE_SR) // LIVE_SLOT
    after = nan_card[first + 1:]
    say(f"live: NaN sample at 5 s, card against CPU: {summary}; after it "
        f"({len(after)} slots): last dynamics {after[-1][2]}, "
        f"{sum('nan' in d for _, _, d in after)} slots with a NaN dynamics "
        f"field, {sum(len(json.loads(o)) for _, o, _ in after)} onset "
        f"events, {sum(bool(json.loads(t)['notes']) for t, _, _ in after)}"
        f" slots with tuner notes (last {json.loads(after[-1][0])['notes']})")


CLASS_K = 32                      # the classroom: 32 students ...
CLASS_CAPACITY = 33               # ... and one seat for a late joiner
CLASS_SECONDS = 20.0
CLASS_JOIN_S = 5.0
CLASS_LAUNCH_WAVES = (600, 700)   # launches a wave counted over these
CLASS_PROFILE_WAVES = (800, 850)  # profiled (left out of the host times)
SWEEP_K = (1, 8, 16, 32, 64, 128)
SWEEP_SECONDS = 5.0
GATE_K = 4
GATE_SECONDS = 5.0


def class_member(seed: int, seconds: float, depth: int = 0, agg: int = 1):
    """A student: tuner and onset detection over mixed_scene(seed) at 48 kHz
    with loopback calibration (2,048 samples, gain 1) on the card →
    (engine, tuner, onset detection)."""
    from audio_analyzer_rs_tpu_torch import AudioEngine
    from audio_analyzer_rs_tpu_torch.api.device import ArraySource
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    e = AudioEngine(input_source=ArraySource(
        gen.mixed_scene(seconds + 0.5, LIVE_SR, seed=seed)),
        sample_rate=LIVE_SR, buffer_size=LIVE_SLOT,
        loopback_latency_samples=2048, loopback_gain=1.0, device="cuda")
    e.pipeline_depth, e.aggregate_slots = depth, agg
    return e, e.start_tuner(), e.start_onset_detection()


def carries_of(e) -> list:
    """Every carry of an engine (fused residency left) as tensors."""
    import numpy as np
    import torch
    pc, oc = (next(c for c in e._consumers.values()
                   if type(c).__name__ == name)
              for name in ("_PitchConsumer", "_OnsetConsumer"))
    return [*pc.analyzer.nf_state, *pc.analyzer.tr_state, *oc.analyzer.state,
            torch.from_numpy(np.array(pc.analyzer._tail)),
            torch.from_numpy(np.array(oc.analyzer._tail)),
            torch.tensor([pc.analyzer.frames_consumed,
                          oc.analyzer.frames_consumed, int(e.onset_pending),
                          int(oc.calibration_done)])]


def drive_polled(members, step, slots: int, flush):
    """Step `slots` times, polling every member after each step, then flush
    and poll once more → per member [(tuner, onsets, dynamics)]."""
    polls = [[] for _ in members]

    def poll_all():
        for k, (e, tuner, det) in enumerate(members):
            polls[k].append((tuner.poll_output(), det.poll_onsets(),
                             e.poll_dynamics()))
    for _ in range(slots):
        step()
        poll_all()
    flush()
    poll_all()
    return polls


def same_session(got, want, label: str) -> int:
    """Two runs of one student, bitwise on every consumer-visible output:
    the onset event stream, every slot's dynamics, the last tuner reading,
    and every carry.  Deferred readback moves when a result is polled, not
    what it is.  Returns the number of events."""
    (eg, pg), (ew, pw) = got, want
    for e in (eg, ew):
        e.flush_analysis()      # hand the carries back (a pool's too)
    ev_g = [ev for _, o, _ in pg for ev in json.loads(o)]
    ev_w = [ev for _, o, _ in pw for ev in json.loads(o)]
    assert ev_g == ev_w, f"{label}: onset events differ"
    assert [d for _, _, d in pg] == [d for _, _, d in pw], \
        f"{label}: dynamics differ"
    assert pg[-1][0] == pw[-1][0], f"{label}: last tuner reading differs"
    for i, (a, b) in enumerate(zip(carries_of(eg), carries_of(ew))):
        assert same_bits(a.cpu(), b.cpu()), f"{label}: carry {i} differs"
    return len(ev_w)


def pool_shape_kernels(rows, lanes: int) -> str:
    """Each kernel at the pool wave's shape, C lanes of one slot (2 pitch
    frames and 16 onset frames a lane, from the classroom's scenes): held
    against its plain version on the same inputs at phase 3's tolerances
    (K1 within K1_REL_TOL of its scale, K2-K5 and K10 bitwise; K3-K5 from fresh
    states and from states carried through the slot before; K11 bitwise to
    its numpy transcription and within K11_PEAK_TOL of cuFFT), then timed
    beside its bound; the rows get pool_max_abs_err / pool_ms /
    pool_bound_ms / pool_bound_by."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import (hopper_comb, hopper_extract,
                                                 hopper_noisefloor,
                                                 hopper_onset, hopper_rfft,
                                                 hopper_stft, hopper_tracker,
                                                 noisefloor, onset, pitch,
                                                 tracker)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    dev = torch.device("cuda")
    half = 1025
    bin_w = float(np.float32(LIVE_SR) / np.float32(2048))
    kc = pitch.candidate_band(bin_w, half)
    min_bin, max_bin = pitch._bins(bin_w, half, pitch.MIN_FREQ,
                                   pitch.MAX_FREQ)
    scenes = [gen.mixed_scene(5.5, LIVE_SR, seed=100 + k)
              for k in range(lanes)]
    trig = rdft_trig(2048, dev)[:, :2 * (kc + 1)]
    win = hann(2048, dev)
    gf = torch.full((lanes, 2), 0.002, device=dev)
    no = torch.zeros((lanes, 16), dtype=torch.bool, device=dev)
    o_gf = torch.full((lanes, 16), 0.0016, device=dev)

    def slot_inputs(slot, st_nf):
        """Slot `slot` of every lane → (x, frames, K1 mags, the floor scan
        from st_nf (plain), tracker raws, onset magnitudes)."""
        at = slot * LIVE_SLOT
        x = torch.from_numpy(np.stack([
            sc[at:at + 512 + 2048] for sc in scenes])).to(dev)
        frames = frame_signal(x, 2048, 512)                   # [C, 2, 2048]
        mags = hopper_stft.dft_mag_plain(frames, trig, win)
        nf = noisefloor.noise_floor_scan_plain(st_nf, mags, gf, kc)
        flat = mags.reshape(2 * lanes, -1)
        pf = pitch.extract_pitches(flat, nf[1].reshape(2 * lanes, -1), bin_w,
                                   true_half=half)
        raws = (pf.freqs.reshape(lanes, 2, 8), pf.scores.reshape(lanes, 2, 8),
                pf.valid.reshape(lanes, 2, 8),
                torch.zeros((lanes, 2), dtype=torch.bool, device=dev))
        o_mags = windowed_mags(frame_signal(x[:, :15 * 64 + 256], 256, 64),
                               256, "fft")                    # [C, 16, 129]
        return x, frames, mags, nf, raws, o_mags

    def k3_plain(st, raws):
        st, emits = tracker.tracker_scan_plain(st, *raws)
        return st, tracker.select_stable(*emits)

    # States carried through slot 199 by the plain scans, contiguous as
    # the kernels leave them for the next wave.
    st_nf0 = noisefloor.init_state(half, dev, (lanes,))
    st_tr0 = tracker.init_state(dev, (lanes,))
    st_on0 = onset.init_state(onset.HALF, dev, (lanes,))
    _, _, _, nf_prev, raws_prev, o_prev = slot_inputs(199, st_nf0)
    carried = tuple(type(st)(*(leaf.contiguous() for leaf in st)) for st in (
        nf_prev[0], k3_plain(st_tr0, raws_prev)[0],
        onset.onset_scan_plain(st_on0, o_prev, o_gf, no, no)[0]))
    x, frames, mags, nf, raws, o_mags = slot_inputs(200, carried[0])
    eff = nf[1]
    flat, eff_flat = mags.reshape(2 * lanes, -1), eff.reshape(2 * lanes, -1)
    pm, frac, m_c, _, _ = pitch._pre_comb(flat, eff_flat, min_bin, max_bin,
                                          kc)
    m_c = m_c.contiguous()
    o_in = (o_mags, o_gf, no, no)
    o_frames = frame_signal(x[:, :15 * 64 + 256], 256, 64)   # [C, 16, 256]
    o_win = hann(256, dev)

    # The checks.
    err = {"K11": k11_held(o_frames, o_win, f"at C={lanes}")}
    got = hopper_stft.dft_mag(frames, trig, win)
    torch.cuda.synchronize()
    err["K1"] = float((got - mags).abs().max())
    scale = float(mags.abs().max())
    assert err["K1"] <= K1_REL_TOL * scale, (
        f"K1 at C={lanes}", err["K1"], scale)
    got = hopper_comb.comb(pm, frac, m_c, half, max_bin)
    ref = pitch._comb(pm, frac, m_c, half, max_bin)
    torch.cuda.synchronize()
    for g, r, name in zip(got, ref, ("score", "longest_run", "total_harms")):
        assert torch.equal(g, r), f"K2 {name} at C={lanes} differs"
    err["K2"] = float((got[0] - ref[0]).abs().max())
    x_args = (bin_w, min_bin, max_bin, pitch.MIN_FREQ, pitch.MAX_FREQ, half)
    got = hopper_extract.extract(flat, eff_flat, *x_args)
    ref = pitch._extract(flat, eff_flat, *x_args)
    torch.cuda.synchronize()
    for g, r, name in zip(got, ref, pitch.PitchFrame._fields):
        assert same_bits(g, r), f"K10 {name} at C={lanes} differs"
    err["K10"] = float((got.scores - ref.scores).abs().max())
    pf_pool = got
    for key in ("K3", "K4", "K5"):
        err[key] = 0.0
    for label, (st_nf, st_tr, st_on) in (
            ("fresh", (st_nf0, st_tr0, st_on0)), ("carried", carried)):
        cases = (
            ("K3", tracker.TrackerState._fields + ("freq", "score", "valid"),
             hopper_tracker.tracker_scan(st_tr, *raws), k3_plain(st_tr, raws)),
            ("K4", onset.OnsetState._fields + onset.OnsetFrameOut._fields,
             hopper_onset.onset_scan(st_on, *o_in),
             onset.onset_scan_plain(st_on, *o_in)),
            ("K5", noisefloor.NoiseFloorState._fields + ("effective",),
             noisefloor.noise_floor_scan(st_nf, mags, gf, kc),
             noisefloor.noise_floor_scan_plain(st_nf, mags, gf, kc)))
        torch.cuda.synchronize()
        for key, names, (st_k, out_k), (st_p, out_p) in cases:
            out_k = out_k if isinstance(out_k, tuple) else (out_k,)
            out_p = out_p if isinstance(out_p, tuple) else (out_p,)
            assert len(names) == len((*st_k, *out_k)) == len((*st_p,
                                                              *out_p)), key
            for name, g, r in zip(names, (*st_k, *out_k), (*st_p, *out_p)):
                assert same_bits(g, r), \
                    f"{key} at C={lanes} ({label} state): {name} differs"
                if g.dtype == torch.float32:
                    err[key] = max(err[key], float((g - r).abs().max()))

    # The times, at a band-wide K5 state (the kernel alone, as phase 3).
    st_nf = noisefloor.init_state(kc, dev, (lanes,))
    st_tr, st_on = carried[1], carried[2]
    k3_out = hopper_tracker.tracker_scan(st_tr, *raws)
    k4_out = hopper_onset.onset_scan(st_on, *o_in)
    shapes = {
        "K1": (lambda: hopper_stft.dft_mag(frames, trig, win),
               nbytes(x, trig, win, mags),
               3 * 2 * 2 * lanes * 2048 * trig.shape[1], TF32_FLOPS),
        "K2": (lambda: hopper_comb.comb(pm, frac, m_c, half, max_bin),
               nbytes(pm, frac, m_c) + 3 * pm.numel() * 4, 0, FP32_FLOPS),
        "K3": (lambda: hopper_tracker.tracker_scan(st_tr, *raws),
               nbytes(*raws, *k3_out[1]) + 2 * nbytes(*st_tr), 0,
               FP32_FLOPS),
        "K4": (lambda: hopper_onset.onset_scan(st_on, *o_in),
               nbytes(*o_in, *k4_out[1]) + 2 * nbytes(*st_on),
               30 * o_mags.numel(), FP32_FLOPS),
        "K5": (lambda: hopper_noisefloor.noise_floor_scan(st_nf, mags, gf,
                                                          kc),
               2 * lanes * 2 * kc * 4 + nbytes(gf)
               + 2 * (3 * lanes * kc * 4 + lanes),
               30 * lanes * 2 * kc, FP32_FLOPS),
        "K10": (lambda: hopper_extract.extract(flat, eff_flat, *x_args),
                2 * lanes * (2 * kc + 1) * 4 + nbytes(*pf_pool),
                30 * 2 * lanes * (kc + 1), FP32_FLOPS),
        "K11": (lambda: hopper_rfft.rfft_mag(o_frames, None, o_win),
                *k11_work(o_frames, lanes * (15 * 64 + 256)), FP32_FLOPS),
    }
    parts = []
    for name, (fn, nb, ops, rate) in shapes.items():
        t_ms = cuda_ms(fn, KERNEL_REPS)
        b_ms, b_by = bound(nb, ops, rate)
        row_of(rows, name).update(
            pool_lanes=lanes, pool_max_abs_err=err[name], pool_ms=t_ms,
            pool_bound_ms=b_ms, pool_bound_by=b_by)
        parts.append(f"{name} {t_ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} "
                     f"us, {b_by})")
    return (f"C={lanes}: K1 [{lanes}, 2, 2048] within {K1_REL_TOL:g}x of "
            f"its scale (max|d| {err['K1']:.3e}), K2 [{2 * lanes}, {kc}], "
            f"K3 S={lanes} N=2, K4 [{lanes}, 16, 129], K5 [{lanes}, 2, "
            f"{kc}] and K10 [{2 * lanes}, {kc + 1}] bitwise to their plain "
            f"versions (K3-K5 from fresh and carried states), K11 [{lanes}, "
            f"16, 256] bitwise to rfft_mag_fixed_np and within "
            f"{K11_PEAK_TOL:g}x of each frame's peak of cuFFT; "
            + "; ".join(parts))


def wave_split(students: int, waves: int = 100, settle: int = 150) -> str:
    """Where a wave's host time goes: a pool of `students` at depth 1 runs
    `settle` waves (calibration done), then `waves` more with its stages
    timed on the host clock."""
    from audio_analyzer_rs_tpu_torch import EnginePool, runtime
    from audio_analyzer_rs_tpu_torch.api import pool as pool_mod
    from audio_analyzer_rs_tpu_torch.api.engine import AudioEngine
    ms_ = [class_member(100 + k, (settle + waves + 2) * LIVE_SLOT / LIVE_SR)
           for k in range(students)]
    spool = EnginePool([m[0] for m in ms_], pipeline_depth=1,
                       capacity=students)
    spool.prepare()
    for _ in range(settle):
        spool.step_wave()
    stages = ((runtime.NativeReducer, "process_slot", "reducer"),
              (AudioEngine, "_fused_inputs", "inputs"),
              (pool_mod, "upload", "upload"),
              (pool_mod, "fused_slot_pool_step", "dispatch"),
              (EnginePool, "_drain_entry", "readback+posts"),
              (AudioEngine, "_fused_post", "posts"))
    spent = {key: 0.0 for _, _, key in stages}

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
            return out
        return run

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for (obj, attr, key), (_, _, fn) in zip(stages, saved):
        setattr(obj, attr, timed(fn, key))
    t0 = time.perf_counter()
    try:
        for _ in range(waves):
            spool.step_wave()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    total = (time.perf_counter() - t0) * 1e3 / waves
    spool.flush()
    per = {key: v * 1e3 / waves for key, v in spent.items()}
    per["readback"] = per.pop("readback+posts") - per["posts"]
    return (f"host ms a wave by stage, {students} students, waves "
            f"{settle}-{settle + waves - 1} (of {total:.3f} in step_wave()): "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
            + f", the rest {total - sum(per.values()):.3f}")


def classroom_phase(rows, card: str) -> None:
    """Phase 11, the classroom: an EnginePool on the card (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from audio_analyzer_rs_tpu_torch import EnginePool
    counters = counters_of(COUNTED)
    slot_s = LIVE_SLOT / LIVE_SR

    # The gates first: bitwise on the card.  Four solo students at depth 0,
    # the same four pooled at depth 1, student 0 at depth 1, and at depth 1
    # with aggregation 4.
    n = int(GATE_SECONDS / slot_s)
    solos = []
    for k in range(GATE_K):
        m = class_member(100 + k, GATE_SECONDS)
        solos.append((m[0], drive_polled([m], lambda m=m: m[0].advance(
            slot_s), n, m[0].flush_analysis)[0]))
    # Pooled at capacity GATE_K (no pad lane), then at the classroom's
    # capacity (its padded shape, CLASS_CAPACITY - GATE_K inert lanes).
    gate_rollbacks = []
    for capacity in (GATE_K, CLASS_CAPACITY):
        pm = [class_member(100 + k, GATE_SECONDS) for k in range(GATE_K)]
        gpool = EnginePool([m[0] for m in pm], pipeline_depth=1,
                           capacity=capacity)
        pooled = drive_polled(pm, gpool.step_wave, n, gpool.flush)
        n_ev = [same_session((pm[k][0], pooled[k]), solos[k],
                             f"pooled {k} at capacity {capacity}")
                for k in range(GATE_K)]
        gate_rollbacks.append(gpool._rollbacks)
    assert sum(n_ev) > 0, "the gate's sessions fired no onset"
    knobs = {}
    for label, depth, agg in (("depth 1", 1, 1), ("aggregate 4", 1, 4)):
        m = class_member(100, GATE_SECONDS, depth, agg)
        polls = drive_polled([m], lambda m=m: m[0].advance(slot_s), n,
                             m[0].flush_analysis)[0]
        same_session((m[0], polls), solos[0], label)
        knobs[label] = (m[0]._spec_rollbacks, m[0]._agg_dispatches)
    say(f"classroom: gates on the card, {n} slots of {GATE_SECONDS:.0f} s: "
        f"{GATE_K} pooled students (depth 1) at capacity {GATE_K} and at "
        f"capacity {CLASS_CAPACITY} ({CLASS_CAPACITY - GATE_K} pad lanes) "
        f"against {GATE_K} solo engines (depth 0) bitwise (events {n_ev}, "
        f"every slot's dynamics, the last reading, every carry; "
        f"{gate_rollbacks} rollbacks); depth 1 "
        f"against 0 bitwise ({knobs['depth 1'][0]} rollback); aggregate 4 "
        f"against 1 bitwise ({knobs['aggregate 4'][1]} aggregate "
        f"dispatches)")
    del solos, pm, gpool, pooled

    # The classroom: 32 students from the first wave, one joining at 5 s.
    n_waves = int(CLASS_SECONDS / slot_s)
    join_at = int(CLASS_JOIN_S / slot_s)
    members = [class_member(100 + k, CLASS_SECONDS) for k in range(CLASS_K)]
    pool = EnginePool([m[0] for m in members], pipeline_depth=1,
                      aggregate_slots=1, capacity=CLASS_CAPACITY)
    prep = pool.prepare()
    host_ms, marks = [], {}
    events, readings = [0] * CLASS_CAPACITY, [0] * CLASS_CAPACITY
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # Python's collector pauses, to tell them from the host's own stalls
    # in the slowest waves.
    gc_pauses, gc_start = [], [0.0]

    def gc_watch(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"],
                              (time.perf_counter() - gc_start[0]) * 1e3))
    gc.callbacks.append(gc_watch)
    for mod in counters:
        mod.LAUNCHES = 0
    plain_x = PlainExtractions().__enter__()
    for i in range(n_waves):
        if i == join_at:
            members.append(class_member(100 + CLASS_K,
                                        CLASS_SECONDS - CLASS_JOIN_S))
            pool.add(members[-1][0])
        if i in CLASS_LAUNCH_WAVES:
            marks[i] = [mod.LAUNCHES for mod in counters]
        if i == CLASS_PROFILE_WAVES[0]:
            prof.__enter__()
        t0 = time.perf_counter()
        pool.step_wave()
        dt = (time.perf_counter() - t0) * 1e3
        if i == CLASS_PROFILE_WAVES[1] - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        if not CLASS_PROFILE_WAVES[0] <= i < CLASS_PROFILE_WAVES[1]:
            host_ms.append(dt)
        for k, (_, tuner, det) in enumerate(members):
            events[k] += len(json.loads(det.poll_onsets()))
            readings[k] += bool(json.loads(tuner.poll_output())["notes"])
    pool.flush()
    plain_x.__exit__(None, None, None)
    gc.callbacks.remove(gc_watch)
    launches = [mod.LAUNCHES for mod in counters]
    off_path_zero(launches)
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    for k, (_, _, det) in enumerate(members):
        events[k] += len(json.loads(det.poll_onsets()))
    span = CLASS_LAUNCH_WAVES[1] - CLASS_LAUNCH_WAVES[0]
    per_wave = [(b - a) / span for a, b in zip(
        marks[CLASS_LAUNCH_WAVES[0]], marks[CLASS_LAUNCH_WAVES[1]])]
    assert per_wave == [1.0] * 6 + [0.0], f"launches a wave {per_wave}"
    for k, (e, tuner, det) in enumerate(members):
        want = n_waves - (join_at if k == CLASS_K else 0)
        assert e._fused_slots == want, (k, e._fused_slots, want)
        assert carries_of(e)[-1][3] == 1, f"student {k} never calibrated"
    assert sum(events) > 0, "no onset in the classroom"
    assert sum(r > 0 for r in readings) >= 0.75 * len(readings), \
        f"students without a tuner note: {readings}"
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
                  for ev in kern)
    n_prof = CLASS_PROFILE_WAVES[1] - CLASS_PROFILE_WAVES[0]
    n_kern = sum(ev.count for ev in kern)
    gc_note = (f"{len(gc_pauses)} garbage collections "
               f"({sum(g == 2 for g, _ in gc_pauses)} full), the longest "
               f"{max((t for _, t in gc_pauses), default=0.0):.1f} ms")
    ms = sorted(host_ms)
    p50, p99 = ms[len(ms) // 2], ms[int(0.99 * (len(ms) - 1))]
    timed_waves = [i for i in range(n_waves)
                   if not CLASS_PROFILE_WAVES[0] <= i < CLASS_PROFILE_WAVES[1]]
    slowest = sorted(zip(host_ms, timed_waves), reverse=True)[:5]
    after = sorted(host_ms[join_at:])
    over = sum(t > LIVE_BUDGET_MS for t in host_ms)
    profiled = (f"{n_kern / n_prof:.1f} CUDA kernels a wave, card busy "
                f"{busy_us / n_prof / 1e3:.4f} ms a wave" if busy_us > 0 else
                "the profiler saw no device time (card-busy ms not measured)")
    say(f"classroom: EnginePool of {CLASS_K} students (+1 joining at "
        f"{CLASS_JOIN_S:.0f} s), capacity {CLASS_CAPACITY}, depth 1, on "
        f"{card}: prepare() {prep['total_s']:.2f} s; {n_waves} waves; host "
        f"ms a wave p50 {p50:.3f}, p99 {p99:.3f}, max {ms[-1]:.3f} ({len(ms)}"
        f" waves; waves {CLASS_PROFILE_WAVES[0]}-{CLASS_PROFILE_WAVES[1] - 1}"
        f" profiled apart; the slowest (wave: ms) "
        + ", ".join(f"{i}: {t:.1f}" for t, i in slowest)
        + f"); ms an engine-slot after the join ({CLASS_CAPACITY} students) "
        f"p50 {after[len(after) // 2] / CLASS_CAPACITY:.4f}; {over} waves "
        f"over {LIVE_BUDGET_MS:.2f} ms; launches K1/K10/K3/K4/K5/K11/K2 a "
        f"wave over waves {CLASS_LAUNCH_WAVES[0]}-{CLASS_LAUNCH_WAVES[1] - 1} "
        f"{per_wave}, over the run {launches}, plain extractions 0; "
        f"profiled {n_prof} waves: "
        f"{profiled}; {pool._rollbacks} rollbacks; {gc_note}; onset events "
        f"a student min {min(events)} max {max(events)}; waves with a tuner "
        f"note a student min {min(readings)} max {max(readings)}")
    for tag, n_run, n_wave in zip(COUNTED, launches, per_wave):
        row_of(rows, tag).update(launches_pool=n_run,
                                 launches_pool_per_wave=n_wave)
    row_of(rows, "K1-pool")["launches"] = launches[0]
    del members, pool
    say("classroom: " + wave_split(CLASS_K))

    # The sweep: K students for 5 s each, prepared, wave host time.
    sweep = []
    for k_students in SWEEP_K:
        ms_ = [class_member(100 + k, SWEEP_SECONDS)
               for k in range(k_students)]
        spool = EnginePool([m[0] for m in ms_], pipeline_depth=1,
                           capacity=k_students)
        spool.prepare()
        waves = []
        for _ in range(int(SWEEP_SECONDS / slot_s)):
            t0 = time.perf_counter()
            spool.step_wave()
            waves.append((time.perf_counter() - t0) * 1e3)
        spool.flush()
        waves.sort()
        sweep.append((k_students, waves[len(waves) // 2],
                      waves[int(0.99 * (len(waves) - 1))]))
        del ms_, spool
    fits = [k for k, _, w99 in sweep if w99 <= LIVE_BUDGET_MS]
    say("classroom: sweep, host ms a wave (p50 / p99) at K students, 5 s "
        "each, depth 1: " + "; ".join(
            f"K={k} {w50:.3f} / {w99:.3f} ({w50 / k:.4f} ms an engine-slot)"
            for k, w50, w99 in sweep)
        + f"; largest K whose p99 fits {LIVE_BUDGET_MS:.2f} ms: "
        + (str(max(fits)) if fits else "none"))
    say("classroom: kernels at the pool shape, " + pool_shape_kernels(
        rows, CLASS_CAPACITY))


FULL_SR = 48000.0
FULL_B = 128                      # the fleet: 128 practice streams ...
FULL_SLOTS = 468                  # ... in chunks of 468 slots (9.98 s)
FULL_STEPS = 3                    # chained, states carried
K6_CARRIED = 24_000               # K6's carried check: samples after a chunk
# The frames of the 30-minute scene (mixed_scene(1800 s, 44.1 kHz, seed=0),
# 128 x 64 geometry) whose stable pitch sets differ between the JAX
# package's warmup_mode="floor" and "full": the floor warmup's re-warmed
# tracker is not the full one.  tests/test_torch_floor_warmup.py
# (test_floor_warmup_differs_where_jax_differs) measures it with the JAX
# package on a prefix of the scene that keeps those frames' segment plan.
FLOOR_WARMUP_DIFFERS = (13781,)

# Onset frames of a full-step chunk (FULL_SLOTS slots of 1,024 samples,
# framed 256 / 64): the full step's K4 call is [streams, 7,485, 129].
FULL_ONSET_FRAMES = (FULL_SLOTS * 1024 - 256) // 64 + 1


def fullstep_onset_mags(audio, streams: int):
    """The full step's onset magnitudes, [streams, 7,485, 129]: each stream
    a chunk of `audio` (a device tensor) from its own offset, framed 256 /
    64 and taken through K11 as `windowed_mags`, 256 streams at a time."""
    import torch
    from audio_analyzer_rs_tpu_torch.ops import onset
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    win, hop = onset.WINDOW, onset.HOP
    need = (FULL_ONSET_FRAMES - 1) * hop + win
    step = (len(audio) - need) // streams
    out = torch.empty((streams, FULL_ONSET_FRAMES, onset.HALF),
                      device=audio.device)
    for lo in range(0, streams, 256):
        part = torch.stack([audio[k * step:k * step + need]
                            for k in range(lo, min(streams, lo + 256))])
        out[lo:lo + len(part)] = windowed_mags(frame_signal(part, win, hop),
                                               win, "fft")
    return out


def reducer_check_streams(fleet, t: int):
    """K6's check input: the fleet's first t samples with four streams
    replaced: 1 digital silence, 2 a NaN sample at t/3, 3 and 4 a tone over
    the scene that drops 80 dB (from t/4, and 100 samples before the first
    chunk's end, so that the hold is carried into the next call), driving
    the gate through hold, release and attenuation."""
    import numpy as np
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    x = fleet[:, :t].copy()
    x[1] = 0.0
    x[2, t // 3] = np.nan
    for i, quiet in ((3, t // 4), (4, FULL_SLOTS * 1024 - 100)):
        x[i] += gen.tone_with_harmonics(196.0 * i, t / FULL_SR + 0.05,
                                        FULL_SR, amplitude=0.2)[:t]
        x[i, quiet:] *= np.float32(1e-4)
    return x


def session_state(b: int, seed: int, dev):
    """A DynamicsState as a long session leaves it (rings part filled or
    wrapped, +inf where unwritten, histograms matching the rings)."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.ops import dynamics
    rng = np.random.default_rng(seed)
    leaves = [t.clone() for t in dynamics.init_state("cpu", (b,))]
    for i in range(b):
        for hist, pos, filled, counts, n in (
                (0, 1, 2, 7, dynamics.LONG_LEN),
                (3, 4, 5, 8, dynamics.PLAY_LEN)):
            full = bool(rng.random() < 0.5)
            k = n if full else int(rng.integers(1, n))
            ring = np.full(n, np.inf, np.float32)
            ring[:k] = np.exp(rng.uniform(-14, -1, k)).astype(np.float32)
            leaves[hist][i] = torch.from_numpy(ring)
            leaves[pos][i] = int(rng.integers(0, n)) if full else k % n
            leaves[filled][i] = full
            leaves[counts][i] = torch.bincount(
                dynamics._bucket_of(torch.from_numpy(ring[:k])),
                minlength=1024).to(torch.int32)
        leaves[6][i] = float(np.float32(rng.uniform(0.5, 20.0)))
    return dynamics.DynamicsState(*(t.to(dev) for t in leaves))


def stable_compare(got, want) -> tuple[int, int, float]:
    """Two full steps' stable top-8 → (slot flips, reordered frames,
    frequency error): the slots whose valid flag differs; the frames whose
    valid flags agree but whose notes sit in other slots (a note that
    turned stable a frame later on one side); and, over the frames whose
    valid flags
    agree, the largest relative error between their valid frequencies
    taken in ascending order."""
    import torch
    differ = got.stable_valid != want.stable_valid
    agree = ~differ.any(-1)
    rel = ((got.stable_freqs - want.stable_freqs).abs()
           / want.stable_freqs.abs().clamp(min=1.0))
    in_place = ((rel <= 1e-4) | ~want.stable_valid).all(-1)
    g, w = (torch.where(o.stable_valid, o.stable_freqs,
                        torch.full_like(o.stable_freqs, float("inf")))
            .sort(-1).values for o in (got, want))
    valid = torch.isfinite(w) & agree[..., None]
    f_err = float(((g - w).abs() / w.abs().clamp(min=1.0))[valid].max())
    return int(differ.sum()), int((agree & ~in_place).sum()), f_err


def same_bits_nan(a, b) -> bool:
    """Bit for bit, NaNs compared by position (any NaN bits)."""
    import torch
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    an, bn = torch.isnan(a), torch.isnan(b)
    return (torch.equal(an, bn)
            and torch.equal(torch.where(an, 0, a.view(torch.int32)),
                            torch.where(bn, 0, b.view(torch.int32))))


def fullstep_phase(rows, card: str, audio44, full_outs):
    """Phase 12: K6 and K7 against their plain versions and timed at the
    full step's shape; the batched full step over 128 streams x 3 chunks;
    its gates; the floor warmup on the 30-minute pitch path.  Returns the
    fleet's first chunk (on the card) and the step's output on it from
    fresh states, for phase 14."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.ops import (dynamics, hopper_comb,
                                                 hopper_extract,
                                                 hopper_dynamics,
                                                 hopper_noisefloor,
                                                 hopper_onset,
                                                 hopper_reducer,
                                                 hopper_rfft,
                                                 hopper_tracker, noisefloor,
                                                 onset, pitch, reducer,
                                                 tracker)
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    dev = torch.device("cuda")
    sr = FULL_SR
    t_chunk = FULL_SLOTS * 1024
    # The fleet: 128 streams, 3 chained chunks of 9.98 s (the 30-min scene's
    # samples as 48 kHz audio, a stream every 600,000 samples).
    span = FULL_STEPS * t_chunk
    fleet = np.stack([audio44[k * 600_000:k * 600_000 + span]
                      for k in range(FULL_B)])
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def plain_ms(fn):
        """One call of a plain version, timed by CUDA events → (out, ms)."""
        begin.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, begin.elapsed_time(end)

    # 1. K6 and K7 against their plain versions at the full step's shapes,
    # bit for bit (NaNs by position), and timed there.  K6 fresh over a
    # whole chunk [128, 479,232], then with the state carried over the next
    # K6_CARRIED samples (the cut: the plain per-sample loop costs ~0.3 ms
    # a sample); K7 on K6's output [128, 468, 1024], fresh, carried from
    # that call, and from session states with wrapped rings.
    t0 = time.perf_counter()
    x = torch.from_numpy(reducer_check_streams(
        fleet, t_chunk + K6_CARRIED)).to(dev)
    k6_err, k6_ms, k6_plain, k6_clock = 0.0, {}, {}, {}
    for gate_only in (False, True):
        st = reducer.reducer_init(dev, (FULL_B,))
        for lo, hi in ((0, t_chunk), (t_chunk, t_chunk + K6_CARRIED)):
            xs = x[:, lo:hi].contiguous()
            st_k, y_k = hopper_reducer.reduce_scan(st, xs, sr, gate_only)
            if gate_only:
                (gate, y_p), ms = plain_ms(
                    lambda: reducer.gate_plain(st.gate, xs, sr))
                st_p = reducer.ReducerState(st.hp, st.lp, gate)
            else:
                (st_p, y_p), ms = plain_ms(
                    lambda: reducer.reduce_exact_plain(st, xs, sr))
            assert same_bits_nan(y_k, y_p), f"K6 gate_only={gate_only} [{lo}"
            for a, b in zip((*st_k.hp, *st_k.lp, *st_k.gate),
                            (*st_p.hp, *st_p.lp, *st_p.gate)):
                assert same_bits_nan(a, b), f"K6 state gate_only={gate_only}"
            k6_err = max(k6_err, float(torch.nan_to_num(
                (y_k - y_p).abs()).max()))
            if lo == 0:
                k6_plain[gate_only] = ms
                with SmClock() as k6_clock[gate_only]:
                    k6_ms[gate_only] = cuda_ms(
                        lambda: hopper_reducer.reduce_scan(st, xs, sr,
                                                           gate_only),
                        KERNEL_REPS)
                if not gate_only:
                    slots = y_k.reshape(FULL_B, FULL_SLOTS, 1024)
            st = st_k
    del x, xs, y_k, y_p
    k6_s, t0 = time.perf_counter() - t0, time.perf_counter()
    k7_err, k7_ms, k7_plain, k7_clock = 0.0, {}, {}, {}
    for mode in ("hist", "exact"):
        states = {"fresh": dynamics.init_state(dev, (FULL_B,)),
                  "session": session_state(FULL_B, 5, dev)}
        for label in ("fresh", "carried", "session"):
            st = states[label]
            st_k, out_k, g_k = hopper_dynamics.dynamics_scan(
                st, slots, sr, 1024, mode)
            (st_p, out_p, g_p), ms = plain_ms(
                lambda: dynamics.dynamics_scan_plain(st, slots, sr, 1024, mode))
            for name, a, b in zip(dynamics.DynamicsOut._fields, out_k,
                                  out_p):
                assert same_bits_nan(a, b), f"K7 {mode} {label} {name}"
            assert same_bits_nan(g_k, g_p), f"K7 {mode} {label} gained"
            for name, a, b in zip(dynamics.DynamicsState._fields, st_k,
                                  st_p):
                assert same_bits_nan(a, b), f"K7 {mode} {label} {name}"
            k7_err = max(k7_err, float(torch.nan_to_num(
                (g_k - g_p).abs()).max()))
            if label == "fresh":
                states["carried"] = st_k
                k7_plain[mode] = ms
                with SmClock() as k7_clock[mode]:
                    k7_ms[mode] = cuda_ms(
                        lambda: hopper_dynamics.dynamics_scan(st, slots, sr,
                                                              1024, mode),
                        KERNEL_REPS)
    k7_s = time.perf_counter() - t0
    k6_bytes = 2 * FULL_B * t_chunk * 4 + 2 * FULL_B * 10 * 4
    k6_bound, k6_by = bound(k6_bytes, 30 * FULL_B * t_chunk, FP32_FLOPS)
    k6_ns = k6_ms[False] / t_chunk * 1e6          # a sample
    k6_cycles = k6_ns * k6_clock[False].mhz / 1e3
    k7_bytes = (2 * nbytes(slots) + 2 * nbytes(*states["fresh"])
                + 6 * FULL_B * FULL_SLOTS * 4)
    k7_bound, k7_by = bound(k7_bytes, 20 * slots.numel(), FP32_FLOPS)
    k7_ns = k7_ms["hist"] / FULL_SLOTS * 1e6       # a slot
    k7_cycles = k7_ns * k7_clock["hist"].mhz / 1e3
    say(f"fullstep: K6 bitwise equal to its plain version (exact and "
        f"gate-only; {FULL_B} streams x {t_chunk} samples fresh, then "
        f"{K6_CARRIED} carried; the fleet's audio with digital silence, a NaN "
        f"sample, quiet sections through hold, release and attenuation); K6 "
        f"{k6_ms[False]:.3f} ms (gate-only {k6_ms[True]:.3f} ms), a sample "
        f"{k6_clock[False].cycles(k6_ns)}; plain "
        f"{k6_plain[False]:.0f} ms (gate-only {k6_plain[True]:.0f} ms); "
        f"bound {k6_bound:.4f} ms ({k6_by}: {k6_bytes / 1e6:.1f} MB); the "
        f"check took {k6_s:.0f} s")
    say(f"fullstep: K7 bitwise equal to its plain version (hist and exact; "
        f"{FULL_B} streams x {FULL_SLOTS} slots of K6's output, fresh, "
        f"carried, and from session states with wrapped rings); hist "
        f"{k7_ms['hist']:.3f} ms, a slot {k7_clock['hist'].cycles(k7_ns)}, "
        f"exact "
        f"{k7_ms['exact']:.3f} ms; plain {k7_plain['hist']:.0f} ms (exact "
        f"{k7_plain['exact']:.0f} ms); bound {k7_bound:.4f} ms ({k7_by}: "
        f"{k7_bytes / 1e6:.1f} MB); the check took {k7_s:.0f} s")
    del slots, states, st, st_k, st_p, out_k, out_p, g_k, g_p

    # 2. The full step over the fleet.
    step = sharding.make_batched_full_step(None, sr)
    states = sharding.init_stream_states(FULL_B)
    t0 = time.perf_counter()
    step(states, fleet[:, :t_chunk])
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    plain_steps = []
    patched = [(noisefloor, "_step"), (onset, "_step"), (dynamics, "_step"),
               (tracker, "select_stable"), (reducer, "_feedback"),
               (reducer, "_envelope")]
    saved = [getattr(m, n) for m, n in patched]
    for (m, n), f in zip(patched, saved):
        setattr(m, n, lambda *a, _f=f, _n=n: plain_steps.append(_n) or _f(*a))
    counters = (hopper_extract, hopper_tracker, hopper_onset,
                hopper_noisefloor, hopper_reducer, hopper_dynamics,
                hopper_rfft, hopper_comb)
    for mod in counters:
        mod.LAUNCHES = 0
    chunks = [torch.from_numpy(fleet[:, k * t_chunk:(k + 1) * t_chunk]
                               .copy()).to(dev) for k in range(FULL_STEPS)]
    step_s, outs = [], []
    st = states
    with PlainExtractions() as plain_x:
        for k in range(FULL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, out = step(st, chunks[k])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            outs.append(out)
    launches = [mod.LAUNCHES for mod in counters]
    for (m, n), f in zip(patched, saved):
        setattr(m, n, f)
    assert not plain_steps, f"plain steps on the card: {set(plain_steps)}"
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    # K11 twice a step: the pitch and the onset STFT.
    assert off_path_zero(launches) == [FULL_STEPS] * 6 + [2 * FULL_STEPS], \
        launches
    last = outs[-1]
    n_p, n_o = last.stable_freqs.shape[1], last.onset_fired.shape[1]
    assert torch.isfinite(last.stable_freqs).all()
    assert bool(last.stable_valid.any()) and bool(last.onset_fired.any())
    assert np.isfinite(float(last.global_noise_floor_db))
    secs = t_chunk / sr
    med = statistics.median(step_s)
    say(f"fullstep: make_batched_full_step {FULL_B} streams x {t_chunk} "
        f"samples ({secs:.2f} s; {n_p} pitch and {n_o} onset frames a "
        f"stream) x {FULL_STEPS} chained steps: cold {cold:.2f} s, warm "
        f"{'/'.join(f'{s * 1e3:.1f}' for s in step_s)} ms a step = "
        f"{FULL_B * secs / med:,.0f} s of audio a wall second; launches "
        f"K10/K3/K4/K5/K6/K7/K11/K2 {launches} ({FULL_STEPS} steps: once a "
        f"step each, K11 twice, K2 0), plain scan steps 0, plain "
        f"extractions 0; global floor "
        f"{float(last.global_noise_floor_db):.2f} dB, "
        f"{int(last.global_onset_count)} onsets in the last step")
    # The banded step against the step with full-width pitch magnitudes
    # (K11 at full width; K5 seeding a fresh stream's tail from them, K10
    # reading their first kc + 1 bins: the step before the banding), each
    # of the chained steps from fresh states: every output and the last
    # states, bit for bit (NaNs by position).
    from audio_analyzer_rs_tpu_torch.ops.fft import hann

    def full_width_pitch(frames, band):
        return hopper_rfft.rfft_mag(frames, None,
                                    hann(frames.shape[-1], dev)), None

    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for part in tree for x in leaves(part)]
        return [tree]
    banded_pitch = sharding.pitch_mags
    sharding.pitch_mags = full_width_pitch
    try:
        st_w = states
        for k in range(FULL_STEPS):
            st_w, out_w = step(st_w, chunks[k])
            for name, a, b in zip(sharding.FullStepOut._fields, out_w,
                                  outs[k]):
                assert same_bits_nan(a, b), \
                    f"banded step {k}: {name} differs from full width"
    finally:
        sharding.pitch_mags = banded_pitch
    for a, b in zip(leaves(st_w), leaves(st)):
        assert same_bits_nan(a, b), "banded step: states differ"
    del st_w, out_w
    # The step's card time.  Each launch call into the port's library is
    # bracketed by a pair of CUDA events over one step (the wrappers' torch
    # ops stay outside them).  torch's kernels come from torch.profiler in
    # a process of its own (port_tools/fullstep_profile.py, the same fleet
    # and step): in this one, after phases 10-11's profiles, it saw only
    # 22-28 of the step's 43-50 torch kernels.
    from audio_analyzer_rs_tpu_torch import _build
    lib = _build.lib()
    ours = {"aat_extract": "extraction", "aat_tracker_select": "tracker",
            "aat_onset_scan": "onset",
            "aat_noise_floor_scan_first": "noise floor",
            "aat_reducer_scan": "reducer", "aat_dynamics_scan": "dynamics",
            "aat_rfft_mag_first": "rfft_mag (pitch)",
            "aat_rfft_mag": "rfft_mag (onset)"}
    spans = []

    def timed(name, fn):
        def launch(*args):
            begin = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            begin.record()
            code = fn(*args)
            done.record()
            spans.append((name, begin, done))
            return code
        return launch
    originals = {fn: getattr(lib, fn) for fn in ours}
    for fn, name in ours.items():
        setattr(lib, fn, timed(name, originals[fn]))
    try:
        step(st, chunks[0])
        torch.cuda.synchronize()
    finally:
        for fn in ours:
            setattr(lib, fn, originals[fn])
    names = sorted(name for name, _, _ in spans)
    assert names == sorted(ours.values()), names
    port_ms = {}
    for name, b, e in spans:
        port_ms[name] = port_ms.get(name, 0.0) + b.elapsed_time(e)
    # The step with K11 and, before it, with the plain STFT (cuFFT), each
    # profiled in a process of its own: the STFT's card ms before is the
    # card time the step loses when K11 takes over, plus K11's own.
    prof = {}
    for mode in ("plain", "k11"):
        proc = subprocess.run(
            [sys.executable, str(REPO / "port_tools" / "fullstep_profile.py"),
             "--profiles", "3", "--stft", mode], capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        prof[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    profile_text, busy_of = {}, {}
    for mode, fresh in prof.items():
        profs = fresh["profiles"]
        n_torch = [p["torch_kernels"] for p in profs]
        # A profile is taken whole where every one saw the STFT's kernels
        # and the same count, and its kernels fit inside the profiled step.
        whole = (all(p["saw_stft"] for p in profs)
                 and len(set(n_torch)) == 1
                 and all(p["card_busy_ms"] <= p["profiled_step_ms"]
                         for p in profs))
        busy = statistics.median(p["card_busy_ms"] for p in profs)
        busy_of[mode] = busy if whole else None
        busy_text = (f"card busy {busy:.2f} ms against the step's "
                     f"{fresh['step_ms']:.2f} ms by CUDA events "
                     f"({1 - busy / fresh['step_ms']:.1%} idle)" if whole
                     else f"card busy not measured (the profiles disagree:"
                     f" torch kernels {n_torch})")
        profile_text[mode] = (
            f"{'/'.join(map(str, n_torch))} torch CUDA kernels, "
            f"{statistics.median(p['torch_card_ms'] for p in profs):.2f} ms "
            f"(cuFFT's {profs[0]['cufft_kernels']}: "
            f"{statistics.median(p['cufft_card_ms'] for p in profs):.3f} "
            f"ms), the port's {profs[0]['port_kernels']}, "
            f"{statistics.median(p['port_card_ms'] for p in profs):.2f} ms "
            f"(K11's {profs[0]['k11_kernels']}: "
            f"{statistics.median(p['k11_card_ms'] for p in profs):.3f} "
            f"ms); {busy_text}; host {fresh['host_ms']:.2f} ms a step; top "
            f"torch kernels: " + "; ".join(profs[0]["top"]))
    k11_prof = statistics.median(p["k11_card_ms"]
                                 for p in prof["k11"]["profiles"])
    if None not in busy_of.values():
        stft_before = busy_of["plain"] - busy_of["k11"] + k11_prof
        stft_text = (f"the STFTs' card ms {stft_before:.2f} before "
                     f"({stft_before / busy_of['plain']:.1%} of the busy "
                     f"card) and {k11_prof:.3f} with K11 "
                     f"({k11_prof / busy_of['k11']:.1%})")
    else:
        stft_text = "the STFTs' share not measured"
    k11_events = port_ms["rfft_mag (pitch)"] + port_ms["rfft_mag (onset)"]
    say(f"fullstep: the banded step bitwise to the step with full-width "
        f"pitch magnitudes ({FULL_STEPS} chained steps from fresh states, "
        f"every output and the states); the port's kernels in one step "
        f"(CUDA events around each library launch) "
        + ", ".join(f"{k} {v:.3f}" for k, v in port_ms.items())
        + f" ms; in fresh processes (port_tools/fullstep_profile.py, 3 "
        f"profiles each): before K11 (--stft plain, cuFFT) "
        f"{profile_text['plain']}; with K11 {profile_text['k11']}; "
        f"{stft_text}; {med * 1e3:.1f} ms a step by this process's host "
        f"clock")
    row_of(rows, "K11").update(
        launches=launches[6], full_step_events_ms=k11_events,
        full_step_pitch_events_ms=port_ms["rfft_mag (pitch)"],
        full_step_onset_events_ms=port_ms["rfft_mag (onset)"],
        full_step_profiled_ms=k11_prof,
        full_step_card_busy_ms=busy_of["k11"],
        full_step_card_busy_ms_before=busy_of["plain"],
        full_step_torch_kernels=prof["k11"]["profiles"][0]["torch_kernels"],
        full_step_torch_kernels_before=prof["plain"]["profiles"][0][
            "torch_kernels"])

    # K10 at the full step's call (128 streams x 933 frames, magnitudes
    # and floors banded), held against the plain extraction and
    # timed; the plain extraction's card time from torch.profiler, and
    # that of the path K10 took over: the same torch ops around K2 (K2 by
    # CUDA events).
    from torch.profiler import ProfilerActivity, profile
    seen, seen_k5 = [], []
    extract_pitches = pitch.extract_pitches
    floor_scan = noisefloor.noise_floor_scan

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return extract_pitches(*args, **kwargs)

    def capture_k5(*args):
        seen_k5.append(args)
        return floor_scan(*args)
    pitch.extract_pitches = capture
    noisefloor.noise_floor_scan = capture_k5
    try:
        step(sharding.init_stream_states(FULL_B), chunks[0])
    finally:
        pitch.extract_pitches = extract_pitches
        noisefloor.noise_floor_scan = floor_scan
    (x_mags, x_floor, x_bw), x_kw = seen[0]
    n_x = x_mags.shape[0]
    half_x = x_kw.get("true_half") or x_mags.shape[-1]
    lo_bin, hi_bin = pitch._bins(x_bw, half_x, pitch.MIN_FREQ, pitch.MAX_FREQ)
    kc_x = pitch.candidate_band(x_bw, half_x)
    x_args = (x_bw, lo_bin, hi_bin, pitch.MIN_FREQ, pitch.MAX_FREQ, half_x)
    got = hopper_extract.extract(x_mags, x_floor, *x_args)
    ref = pitch._extract(x_mags, x_floor, *x_args)
    torch.cuda.synchronize()
    for name, g, r in zip(pitch.PitchFrame._fields, got, ref):
        assert same_bits(g, r), f"K10 at the full step: {name} differs"
    x_ms = cuda_ms(lambda: hopper_extract.extract(x_mags, x_floor, *x_args),
                   KERNEL_REPS)
    def device_ms(events) -> float:
        return sum(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0))
                   for ev in events) / 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pitch._extract(x_mags, x_floor, *x_args)
        torch.cuda.synchronize()
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    x_plain_ms, x_plain_n = device_ms(kern), sum(ev.count for ev in kern)
    comb_spans = []
    comb_fn, plain_comb = lib.aat_comb, pitch._comb

    def comb_timed(*args):
        begin = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        begin.record()
        code = comb_fn(*args)
        done.record()
        comb_spans.append((begin, done))
        return code
    lib.aat_comb, pitch._comb = comb_timed, hopper_comb.comb
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pitch._extract(x_mags, x_floor, *x_args)
            torch.cuda.synchronize()
    finally:
        lib.aat_comb, pitch._comb = comb_fn, plain_comb
    assert len(comb_spans) == 1, f"{len(comb_spans)} K2 launches"
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and "comb_kernel" not in ev.key]
    x_torch_ms = device_ms(kern)
    x_comb_ms = sum(b.elapsed_time(e) for b, e in comb_spans)
    x_bytes = n_x * (2 * kc_x + 1) * 4 + nbytes(*got)
    x_bound, x_by = bound(x_bytes, 30 * n_x * (kc_x + 1), FP32_FLOPS)
    say(f"fullstep: K10 at the step's call ({n_x} frames, magnitudes "
        f"{tuple(x_mags.shape)}, floors {tuple(x_floor.shape)}): bitwise "
        f"equal to the plain extraction ({int(ref.valid.sum())} notes); "
        f"{x_ms:.4f} ms, bound {x_bound:.4f} ms ({x_by}: "
        f"{x_bytes / 1e6:.1f} MB), achieved {x_bytes / x_ms / 1e6:.0f} "
        f"GB/s against {HBM_BYTES_PER_S / 1e9:.0f} ({x_bound / x_ms:.1%} "
        f"of the bound); the plain extraction's card time "
        f"{x_plain_ms:.3f} ms (torch.profiler, {x_plain_n} torch kernels); "
        f"the path K10 took over (the same torch ops around K2) "
        f"{x_torch_ms + x_comb_ms:.3f} ms ({sum(ev.count for ev in kern)} "
        f"torch kernels {x_torch_ms:.3f} ms; K2 {x_comb_ms:.3f} ms by CUDA "
        f"events)")
    row_of(rows, "K10").update(
        full_step_frames=n_x, full_step_ms=x_ms, full_step_bound_ms=x_bound,
        full_step_bound_by=x_by, full_step_gb_per_s=x_bytes / x_ms / 1e6,
        full_step_plain_card_ms=x_plain_ms,
        full_step_plain_kernels=x_plain_n,
        full_step_replaced_card_ms=x_torch_ms + x_comb_ms,
        full_step_replaced_kernels=sum(ev.count for ev in kern) + 1,
        launches_full_step=launches[0])
    row_of(rows, "K2")["launches_full_step"] = launches[-1]
    del prof, kern, got, ref, seen, x_mags, x_floor

    # K5 at the step's call (128 streams x 933 frames of 427-float rows,
    # band 426, the 1,025-wide state, each stream's first frame at full
    # width): the first step's call (a fresh state: the tail seeded from
    # the first frames) and the next one's (its state carried: the tail
    # frozen, as in every later step), each bitwise to the plain scan on
    # the card, then timed alone beside the call's byte bound.
    (f_st, f_mags, f_gf, f_band, f_first), = seen_k5
    c_st, _ = hopper_noisefloor.noise_floor_scan(f_st, f_mags, f_gf, f_band,
                                                 f_first)
    k5_calls = {"fresh": f_st, "carried": c_st}
    k5_step_ms = {}
    for label, st5 in k5_calls.items():
        got5 = hopper_noisefloor.noise_floor_scan(st5, f_mags, f_gf, f_band,
                                                  f_first)
        ref5 = noisefloor.noise_floor_scan_plain(st5, f_mags, f_gf, f_band,
                                                 f_first)
        torch.cuda.synchronize()
        for name, g, r in zip(("effective",) + noisefloor.NoiseFloorState
                              ._fields, (got5[1], *got5[0]),
                              (ref5[1], *ref5[0])):
            assert same_bits(g, r), f"K5 at the full step ({label}): {name}"
        k5_step_ms[label] = cuda_ms(
            lambda: hopper_noisefloor.noise_floor_scan(st5, f_mags, f_gf,
                                                       f_band, f_first),
            KERNEL_REPS)
    del got5, ref5
    s_5, n_5, w_5 = f_mags.shape
    h_5 = f_st.floor.shape[-1]
    k5_step_bytes = (2 * s_5 * n_5 * f_band * 4 + nbytes(f_gf)
                     + 2 * (3 * s_5 * h_5 * 4 + s_5))
    k5_step_bound, k5_step_by = bound(k5_step_bytes,
                                      30 * s_5 * n_5 * f_band, FP32_FLOPS)
    k5_events = port_ms["noise floor"]
    say(f"fullstep: K5 at the step's call (magnitudes {tuple(f_mags.shape)}"
        f", band {f_band}, a {h_5}-wide state, first frames "
        f"{tuple(f_first.shape)}): bitwise equal to the plain "
        f"scan from the first step's fresh state (the tail seeded) and "
        f"from the state it leaves (carried); carried "
        f"{k5_step_ms['carried']:.4f} ms, fresh {k5_step_ms['fresh']:.4f} "
        f"ms; bound {k5_step_bound:.4f} ms ({k5_step_by}: "
        f"{k5_step_bytes / 1e6:.1f} MB), achieved "
        f"{k5_step_bytes / k5_step_ms['carried'] / 1e6:.0f} GB/s "
        f"({k5_step_bound / k5_step_ms['carried']:.1%} of the bound); the "
        f"step's K5 {k5_events:.4f} ms by its events")
    row_of(rows, "K5").update(
        full_step_ms=k5_step_ms["carried"],
        full_step_fresh_ms=k5_step_ms["fresh"],
        full_step_bound_ms=k5_step_bound, full_step_bound_by=k5_step_by,
        full_step_gb_per_s=k5_step_bytes / k5_step_ms["carried"] / 1e6,
        full_step_profiled_ms=k5_events, launches_full_step=launches[3])
    del seen_k5, f_st, f_mags, f_gf, f_first, c_st, k5_calls

    # 3a. One stream's bits do not depend on B: stream 0's first step at
    # B = 1 and 33 against B = 128's, the step as shipped (K11's
    # magnitudes sum in one fixed order a frame); and K11 itself on the
    # fleet's frames, each stream alone against the batch, bit for bit.
    from audio_analyzer_rs_tpu_torch.ops.fft import hann
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    names = ("stable_freqs", "stable_valid", "onset_fired", "onset_velocity",
             "dyn_level")
    for b in (1, 33):
        got = step(sharding.init_stream_states(b), chunks[0][:b])[1]
        for name in names:
            assert same_bits_nan(getattr(got, name)[0],
                                 getattr(outs[0], name)[0]), (b, name)
    for w, hop_w in ((2048, 512), (256, 64)):
        fr = frame_signal(chunks[0], w, hop_w)
        win_w = hann(w, dev)
        batched = hopper_rfft.rfft_mag(fr, None, win_w)
        alone = torch.cat([hopper_rfft.rfft_mag(fr[i:i + 1], None, win_w)
                           for i in range(FULL_B)])
        assert same_bits(alone, batched), f"K11 at {w} points depends on B"
    del got, fr, batched, alone
    # 3b. hist against exact AGC on the canonical 25 s scene.
    scene = gen.mixed_scene(25.0, sr, seed=3)
    scene = scene[None, :(len(scene) // 1024) * 1024]
    sets, fired = {}, {}
    for mode in ("hist", "exact"):
        _, o = sharding.make_batched_full_step(None, sr, dyn_mode=mode)(
            sharding.init_stream_states(1), scene)
        f, v = o.stable_freqs[0].cpu().numpy(), o.stable_valid[0].cpu().numpy()
        sets[mode] = [sorted(int(round(float(q) * 10)) for q in f[i][v[i]])
                      for i in range(len(f))]
        fired[mode] = o.onset_fired[0].cpu().numpy()
    agree = np.mean([a == b for a, b in zip(sets["hist"], sets["exact"])])
    assert agree >= MIN_AGREEMENT, agree
    assert np.array_equal(fired["hist"], fired["exact"])
    # 3c. Card against CPU, 2 streams x 2 s: with the STFT equalized (the
    # CPU's magnitudes on the card) every decision equal; with K11's, the
    # flips counted and the floats held where both agree.
    two = np.stack([gen.mixed_scene(2.0, sr, seed=s)
                    + gen.tone_with_harmonics(262.0 * (s + 1), 2.0, sr,
                                              amplitude=0.2)
                    for s in range(2)]).astype(np.float32)

    windowed, banded = sharding.windowed_mags, sharding.pitch_mags

    def cpu_mags(frames, window, backend="fft", band=None):
        return windowed(frames.cpu(), window, backend, band).to(frames.device)

    def cpu_pitch_mags(frames, band):
        return tuple(t.to(frames.device) for t in banded(frames.cpu(), band))

    def two_streams(device, equalize=False):
        if equalize:
            sharding.windowed_mags = cpu_mags
            sharding.pitch_mags = cpu_pitch_mags
        try:
            _, o = sharding.make_batched_full_step(None, sr, device=device)(
                sharding.init_stream_states(2, device=device), two)
        finally:
            sharding.windowed_mags, sharding.pitch_mags = windowed, banded
        return sharding.FullStepOut(*(t.cpu() for t in o))

    cpu = two_streams("cpu")
    for label, card_out in (("equalized", two_streams("cuda", True)),
                            ("K11", two_streams("cuda"))):
        assert torch.equal(card_out.dyn_level, cpu.dyn_level)
        flips, reordered, f_err = stable_compare(card_out, cpu)
        fired_flips = int((card_out.onset_fired != cpu.onset_fired).sum())
        v_err = float((card_out.onset_velocity - cpu.onset_velocity)
                      .abs().max())
        if label == "equalized":
            assert (flips, reordered, fired_flips) == (0, 0, 0), \
                (flips, reordered, fired_flips)
            assert f_err <= 1e-4 and v_err <= 1e-5, (f_err, v_err)
            eq_err = (f_err, v_err)
        else:
            # The stable top-8 lists notes in the order they turned stable:
            # a note that turns stable a frame later on one side (a flip,
            # counted above) sits in another slot there for the rest of
            # its life, so the frequencies are held as each frame's set
            # (the frames with other slots are counted, not gated).
            assert flips <= 0.01 * cpu.stable_valid.numel(), flips
            assert fired_flips <= 0.01 * cpu.onset_fired.numel(), fired_flips
            assert f_err <= 1e-4, f_err
            raw_err = (flips, fired_flips, f_err, v_err, reordered)
    # 3d. Each stream detects its own tone (JAX tests/test_parallel.py:62).
    tones = [220.0, 261.63, 329.63, 392.0, 440.0, 523.25, 587.33, 659.26]
    tone_audio = np.stack([gen.tone_with_harmonics(
        f, 6 * 1024 / sr, sr, harmonics=6, amplitude=0.3)[:6 * 1024]
        for f in tones])
    st8 = sharding.init_stream_states(len(tones))
    st8, o8 = step(st8, tone_audio)
    st8, o8 = step(st8, tone_audio)
    for b, f in enumerate(tones):
        got = o8.stable_freqs[b, -1][o8.stable_valid[b, -1]].cpu().numpy()
        assert any(abs(g - f) / f < 0.02 for g in got), (b, f, got)
    say(f"fullstep: gates: stream 0's bits equal at B = 1, 33 and {FULL_B} "
        f"(the step as shipped, no equalization), and K11's magnitudes of "
        f"each stream alone bitwise the batch's at 2,048 and 256 points; "
        f"hist against exact AGC on "
        f"the 25 s scene {agree:.6f} of pitch frames (>= {MIN_AGREEMENT}), "
        f"fired identical ({int(fired['hist'].sum())} onsets); card against "
        f"CPU (2 streams x 2 s): with the CPU's FFT on the card every "
        f"decision equal, frequencies within {eq_err[0]:.1e} relative, "
        f"velocities {eq_err[1]:.1e}; with K11 {raw_err[0]} stable-slot "
        f"and {raw_err[1]} fired flips, {raw_err[4]} of "
        f"{cpu.stable_valid.shape[:-1].numel()} frames with their notes in "
        f"other slots, frequencies within {raw_err[2]:.1e} (each frame's "
        f"valid notes in ascending order), velocities "
        f"{raw_err[3]:.1e}; 8 streams each "
        f"detect their own tone")
    first = (chunks[0], outs[0])
    del fleet, chunks, outs, last, states, st

    # 4. The floor warmup on the 30-minute pitch path against "full".
    sf, ss, sv = full_outs
    t0 = time.perf_counter()
    fl = segmented.segmented_pitch_analysis(audio44, SR, warmup_mode="floor")
    floor_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = segmented.segmented_pitch_analysis(audio44, SR, warmup_mode="floor")
    floor_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    segmented.segmented_pitch_analysis(audio44, SR)
    full_warm = time.perf_counter() - t0
    agree_f = frame_agreement(fl[0], fl[2], sf, sv)
    differ = [i for i in range(len(sf))
              if sorted(np.round(fl[0][i][fl[2][i]], 1))
              != sorted(np.round(sf[i][sv[i]], 1))]
    first_n = 128 + 64
    assert tuple(differ) == FLOOR_WARMUP_DIFFERS, differ
    for a, b in zip(fl, (sf, ss, sv)):
        assert np.array_equal(a[:first_n], b[:first_n])
    say(f"fullstep: floor warmup: segmented_pitch_analysis 30 min "
        f"warmup_mode='floor' cold {floor_cold:.2f} s, warm "
        f"{floor_warm:.3f} s against 'full' {full_warm:.3f} s warm; the "
        f"stable sets agree on {agree_f:.6f} of the frames, differing on "
        f"frames {differ}, the frames on which the JAX package's 'floor' and "
        f"'full' differ on this scene; segment 0's first {first_n} frames "
        f"bitwise")

    rows.append(dict(name="K6 reducer (HPF -> LPF -> noise gate scan)",
                     route="cuda", source=f"{PKG}/csrc/reducer.cu",
                     replaces="audio_analyzer_rs_tpu/ops/reducer.py:215",
                     launches=launches[4], max_abs_err=k6_err,
                     ms=k6_ms[False], plain_ms=k6_plain[False],
                     bound_ms=k6_bound, bound_by=k6_by, library_ms=None,
                     gate_only_ms=k6_ms[True], gate_only_plain_ms=k6_plain[True],
                     per_sample_ns=k6_ns, per_sample_cycles=k6_cycles,
                     sm_mhz=k6_clock[False].mhz,
                     sm_clock=k6_clock[False].source))
    rows.append(dict(name="K7 dynamics (the AGC scan)", route="cuda",
                     source=f"{PKG}/csrc/dynamics.cu",
                     replaces="audio_analyzer_rs_tpu/ops/dynamics.py:253",
                     launches=launches[5], max_abs_err=k7_err,
                     ms=k7_ms["hist"], plain_ms=k7_plain["hist"],
                     bound_ms=k7_bound, bound_by=k7_by, library_ms=None,
                     exact_ms=k7_ms["exact"], exact_plain_ms=k7_plain["exact"],
                     per_slot_ns=k7_ns, per_slot_cycles=k7_cycles,
                     sm_mhz=k7_clock["hist"].mhz,
                     sm_clock=k7_clock["hist"].source))
    return first


DEBUG_SECONDS = 60.0              # PitchAnalyzer with a recorder (phase 13)
K1_FULL_FROM_S = 50.0             # the 30-min scene's first melody section
DEBUG_LIVE_SLOTS = 937            # the live debug session: 20 s of slots
DEBUG_TUNER_SECONDS = 10.0        # the CLI's tuner --debug-jsonl
CLI_TIMEOUT_S = 300


def pct(values, q: float) -> float:
    ms = sorted(values)
    return ms[int(q * (len(ms) - 1))]


def devtools_phase(rows, card: str, audio44) -> None:
    """Phase 13, the debug surface on the card (see the module docstring):
    K1 and K5 at full width, `PitchAnalyzer` and the live engine with a
    recorder, and the CLI as subprocesses."""
    import tempfile
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch import devtools
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models.analyzer import PitchAnalyzer
    from audio_analyzer_rs_tpu_torch.ops import (hopper_noisefloor,
                                                 hopper_stft, noisefloor,
                                                 pitch)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.stft import (FIDELITY_MAX_REL_MSE,
                                                      stft_mags_np)
    from audio_analyzer_rs_tpu_torch.utils import wav
    from audio_analyzer_rs_tpu_torch.utils.framing import (frame_signal,
                                                           num_frames)
    dev = torch.device("cuda")
    window, hop, half = 2048, 512, 1025
    bin_w = float(np.float32(SR) / np.float32(window))
    kc = pitch.candidate_band(bin_w, half)
    full = rdft_trig(window, dev)                 # [2048, 2050]: 1,025 bins
    banded = full[:, :2 * (kc + 1)]
    win = hann(window, dev)
    by_name = {row["name"].split()[0]: row for row in rows}

    # K1 at full width against its plain version, the float64 spectral
    # gate and cuBLAS; bins [0, kc] bit for bit the banded launch's.
    first = int(K1_FULL_FROM_S * SR)
    x = torch.from_numpy(
        audio44[first:first + (2 * 4096 - 1) * hop + window]).to(dev)
    full_rows = {}
    for n in (2, 4096):
        frames = frame_signal(x[:(n - 1) * hop + window], window, hop)[None]
        got = hopper_stft.dft_mag(frames, full, win)
        ref = hopper_stft.dft_mag_plain(frames, full, win)
        band_got = hopper_stft.dft_mag(frames, banded, win)
        torch.cuda.synchronize()
        assert got.shape == (1, n, half), got.shape
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        assert err <= K1_REL_TOL * scale, (n, err, scale)
        prefix = got[..., :kc + 1].contiguous()
        if not same_bits(prefix, band_got):
            diff = (prefix.view(torch.int32) != band_got.view(torch.int32))
            f, b = (int(i) for i in diff[0].nonzero()[0])
            raise AssertionError(
                f"K1 full width [1, {n}]: frame {f} bin {b} is "
                f"{float(prefix[0, f, b])!r} at full width and "
                f"{float(band_got[0, f, b])!r} banded")
        oracle = stft_mags_np(x[:(n - 1) * hop + window].cpu().numpy(),
                              window, hop)
        mags = got[0].cpu().numpy()
        mse = float(np.mean((mags - oracle) ** 2) / np.mean(oracle ** 2))
        assert mse < FIDELITY_MAX_REL_MSE, (n, mse)
        windowed = (frames * win).reshape(-1, window).contiguous()
        k_ms, lib_ms, turns = in_turns(
            lambda: hopper_stft.dft_mag(frames, full, win),
            lambda: torch.matmul(windowed, full), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: hopper_stft.dft_mag_plain(frames, full,
                                                             win))
        flops = 2 * n * window * full.shape[1]
        k_bytes = n * hop * 4 + (window - hop) * 4 + nbytes(full, win, got)
        b_ms, b_by = bound(k_bytes, 3 * flops, TF32_FLOPS)
        full_rows[n] = dict(ms=k_ms, library_ms=lib_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        say(f"devtools: K1 full width {tuple(frames.shape)} -> "
            f"{tuple(got.shape)}: max|d| {err:.3e} of max {scale:.3e} vs "
            f"its plain version (tol {K1_REL_TOL:g}x); spectral rel MSE "
            f"{mse:.3e} (< {FIDELITY_MAX_REL_MSE:g}); bins [0, {kc + 1}) "
            f"bitwise the banded launch's; {k_ms:.4f} ms vs cuBLAS FP32 "
            f"{lib_ms:.4f} ms (turns kernel/cuBLAS/kernel/cuBLAS "
            f"{'/'.join(f'{t:.4f}' for t in turns)}), plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
            f"{3 * flops / 1e9:.2f} GFLOP 3xTF32, {k_bytes / 1e6:.1f} MB)")
        del windowed, got, ref, band_got, prefix
    k1 = by_name["K1"]
    k1.update({f"full_width_{k}": v for k, v in full_rows[4096].items()})
    k1.update({f"full_width_live_{k}": v for k, v in full_rows[2].items()})

    # K5 over all 1,025 bins from a state that ran banded (its tail above
    # the band frozen, never seeded from banded magnitudes), S=1 x N=4096.
    n5 = 4096
    fr = frame_signal(x, window, hop)[None]                 # [1, 8192, W]
    gf = torch.full((1, n5), float(noisefloor.global_floor_linear(-96.0,
                                                                  half)),
                    device=dev)
    mags_b = hopper_stft.dft_mag(fr[:, :n5], banded, win)
    mags_f = hopper_stft.dft_mag(fr[:, n5:], full, win)
    st_b, _ = noisefloor.noise_floor_scan(
        noisefloor.init_state(half, dev, (1,)), mags_b, gf, kc)
    assert not bool(st_b.floor[..., kc:].any()), "tail not frozen"
    st_k, eff_k = noisefloor.noise_floor_scan(st_b, mags_f, gf, None)
    st_p, eff_p = noisefloor.noise_floor_scan_plain(st_b, mags_f, gf, None)
    torch.cuda.synchronize()
    assert eff_k.shape == (1, n5, half)
    assert same_bits(eff_k, eff_p), "K5 banded -> full effective differs"
    for name, a, b in zip(noisefloor.NoiseFloorState._fields, st_k, st_p):
        assert same_bits(a, b), f"K5 banded -> full final {name} differs"
    k5_full_ms = cuda_ms(lambda: hopper_noisefloor.noise_floor_scan(
        st_b, mags_f, gf, half), KERNEL_REPS)
    k5_bytes = 2 * n5 * half * 4 + nbytes(gf) + 2 * (3 * half * 4 + 1)
    k5_bound, k5_by = bound(k5_bytes, 30 * n5 * half, FP32_FLOPS)
    say(f"devtools: K5 full width from a banded state (S=1 N={n5}, "
        f"{half} bins, the tail above {kc} frozen): bitwise equal to the "
        f"plain scan (effective floors and the final state); "
        f"{k5_full_ms:.4f} ms; bound {k5_bound * 1e3:.2f} us ({k5_by})")
    k5 = by_name["K5"]
    k5.update(full_width_continuation_bitwise=True,
              full_width_ms_s1_n4096=k5_full_ms,
              full_width_bound_ms=k5_bound)
    del fr, mags_b, mags_f, st_b, st_k, st_p, eff_k, eff_p

    # PitchAnalyzer with a DebugRecorder over 60 s: stable outputs bit for
    # bit the analyzer's without one, a record a frame, warm wall.
    tags = ("K1", "K10", "K3", "K5", "K2")
    counters = counters_of(tags)
    minute = audio44[:int(DEBUG_SECONDS * SR)]
    n60 = num_frames(len(minute), window, hop)
    PitchAnalyzer(SR).process(minute)
    t0 = time.perf_counter()
    plain = PitchAnalyzer(SR).process(minute)
    plain_s = time.perf_counter() - t0
    PitchAnalyzer(SR, debug_recorder=devtools.DebugRecorder()).process(
        minute[:int(5 * SR)])
    rec = devtools.DebugRecorder(max_frames=n60)
    an = PitchAnalyzer(SR, debug_recorder=rec)
    for mod in counters:
        mod.LAUNCHES = 0
    with PlainExtractions() as plain_x:
        t0 = time.perf_counter()
        out = an.process(minute)
        debug_s = time.perf_counter() - t0
    launches = [mod.LAUNCHES for mod in counters]
    assert all(n > 0 for n in off_path_zero(launches)), launches
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    for name in ("stable_freqs", "stable_scores", "stable_valid"):
        a, b = getattr(out, name), getattr(plain, name)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    assert out.mags.shape == out.eff_floor.shape == (n60, half)
    assert plain.eff_floor.shape == (0, 0)
    assert [r.frame for r in rec.pitch_frames] == list(range(n60))
    assert rec.pitch_frames[-1].noise_floor.shape == (half,)
    assert np.isfinite(out.eff_floor).all() and plain.stable_valid.any()
    say(f"devtools: PitchAnalyzer with a DebugRecorder over "
        f"{DEBUG_SECONDS:.0f} s ({n60} frames): stable outputs bitwise equal to the analyzer "
        f"without one; {len(rec.pitch_frames)} records (one a frame, "
        f"{half}-bin spectra and floors); warm {debug_s:.3f} s against "
        f"{plain_s:.3f} s without; launches K1/K10/K3/K5/K2 {launches}, "
        f"plain extractions 0")
    for key, n in zip(tags, launches):
        by_name[key]["launches_debug_analyzer"] = n
    del rec, an, out, plain

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".devtools_") as tmp:
        tmp = Path(tmp)
        # The live engine in phase 10's configuration with a
        # JsonlStreamRecorder: the sequential consumers, K1 and K5 at full
        # width, against the sequential consumers without a recorder.
        scene = gen.mixed_scene(DEBUG_LIVE_SLOTS * LIVE_SLOT / LIVE_SR + 0.5,
                                LIVE_SR, seed=11)
        live_session(scene, "cuda", 50, fused=False,
                     recorder=devtools.DebugRecorder())
        jsonl = tmp / "live.jsonl"
        rec = devtools.JsonlStreamRecorder(str(jsonl))
        counters = counters_of(COUNTED)

        def zero(i):
            if i == 0:
                for mod in counters:
                    mod.LAUNCHES = 0

        with PlainExtractions() as plain_x:
            e, polls, host_ms, _ = live_session(
                scene, "cuda", DEBUG_LIVE_SLOTS, on_slot=zero, recorder=rec)
        launches = [mod.LAUNCHES for mod in counters]
        rec.close()
        assert all(n > 0 for n in off_path_zero(launches)), launches
        assert not plain_x.calls, \
            f"{plain_x.calls} plain extractions on the card"
        assert e._fused_slots == 0, f"{e._fused_slots} fused slots"
        _, ref_polls, ref_ms, _ = live_session(scene, "cuda",
                                               DEBUG_LIVE_SLOTS, fused=False)
        same = sum(a == b for a, b in zip(polls, ref_polls))
        events = 0
        for k, ((t, o, d), (rt, ro, rd)) in enumerate(zip(polls, ref_polls)):
            assert o == ro, f"live debug slot {k}: onsets {o} != {ro}"
            assert json.loads(t)["notes"] == json.loads(rt)["notes"], k
            events += len(json.loads(o))
        kinds = {"pitch": 0, "onset": 0}
        for line in jsonl.read_text().splitlines():
            kinds[json.loads(line)["kind"]] += 1
        pc, oc = (next(c for c in e._consumers.values()
                       if type(c).__name__ == kind)
                  for kind in ("_PitchConsumer", "_OnsetConsumer"))
        assert kinds["pitch"] == pc.analyzer.frames_consumed, kinds
        assert kinds["onset"] == oc.analyzer.frames_consumed, kinds
        assert events > 0
        over = sum(t > LIVE_BUDGET_MS for t in host_ms)
        live_s = DEBUG_LIVE_SLOTS * LIVE_SLOT / LIVE_SR
        say(f"devtools: live engine with a JsonlStreamRecorder, "
            f"{DEBUG_LIVE_SLOTS} slots ({live_s:.1f} s), 0 fused: onset events ({events}) and tuner notes equal "
            f"to the sequential consumers without a recorder on every slot "
            f"({same} of {len(polls)} polls identical); {kinds['pitch']} "
            f"pitch and {kinds['onset']} onset records, one a frame, every "
            f"line parsed; host ms a slot p50 {pct(host_ms, 0.5):.3f}, p99 "
            f"{pct(host_ms, 0.99):.3f}, max {max(host_ms):.3f}, {over} over "
            f"{LIVE_BUDGET_MS:.2f} ms (without a recorder, sequential: p50 "
            f"{pct(ref_ms, 0.5):.3f}, p99 {pct(ref_ms, 0.99):.3f}); "
            f"launches K1/K10/K3/K4/K5/K11/K2 {launches}, plain extractions 0")
        for key, n in zip(COUNTED, launches):
            by_name[key]["launches_debug_live"] = n
        by_name["K1-debug"]["launches"] = launches[0]

        # The CLI as a user runs it, on the card.
        wav60 = tmp / "minute.wav"
        wav.write_wav(str(wav60), minute, int(SR))
        wav10 = tmp / "ten.wav"
        wav.write_wav(str(wav10), minute[:int(DEBUG_TUNER_SECONDS * SR)],
                      int(SR))
        for args, what in (
                (["analyze", str(wav60), str(tmp / "a.jsonl"), "--segments",
                  "auto"], "analyze 60 s --segments auto"),
                (["tuner", str(wav10), "--debug-jsonl",
                  str(tmp / "d.jsonl")],
                 f"tuner {DEBUG_TUNER_SECONDS:.0f} s --debug-jsonl")):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", f"{PKG}.cli", *args],
                                 cwd=REPO, capture_output=True, text=True,
                                 timeout=CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            assert res.returncode == 0, (what, res.stderr[-2000:])
            if args[0] == "analyze":
                lines = (tmp / "a.jsonl").read_text().splitlines()
                header = json.loads(lines[0])
                frames = [json.loads(line) for line in lines[1:]]
                assert header["frames"] == len(frames) == n60
                assert any(f["stable_pitches"] for f in frames)
                detail = (f"{len(frames)} frames, {len(header['onsets'])} "
                          f"onsets")
            else:
                recs = [json.loads(line) for line in
                        (tmp / "d.jsonl").read_text().splitlines()]
                assert recs and {r["kind"] for r in recs} == {"pitch"}
                assert [r["frame"] for r in recs] == list(range(len(recs)))
                detail = (f"{len(recs)} pitch records, "
                          f"{len(res.stdout.splitlines())} lines of output")
            say(f"devtools: cli {what}: exit 0 in {wall:.2f} s (process "
                f"start and the card's set-up included); {detail}")


GATHER_F, GATHER_P = 8, 7296      # the probe's comb-shaped row (phase 14)
MESH_LANES = 33                   # the pooled wave at world size 1 ...
MESH_WAVES = 3                    # ... chained waves
TWO_RANK_B = 16                   # the full step's fleet over two ranks
TWO_RANK_LANES = 8
TWO_RANK_SEGMENTS = 8
TWO_RANK_SECONDS = 60.0           # the scene's first minute, segmented
TWO_RANK_TIMEOUT_S = 300.0


def _tool(name: str):
    """port_tools/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "port_tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gather_phase(rows) -> None:
    """Phase 14a: K8 and K9 through the probe's path (its five cases and
    the index edge cases, bitwise to numpy and the plain versions), the
    launch counts of that run, then each kernel timed at [8, 7296] beside
    its bound, K8 beside torch.gather."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather
    probe = _tool("gather_probe")    # the probe's twin
    hopper_gather.LAUNCHES_K8 = hopper_gather.LAUNCHES_K9 = 0
    res = probe.check_cases(say=lambda line: say(f"gather: {line}"))
    launches = (hopper_gather.LAUNCHES_K8, hopper_gather.LAUNCHES_K9)
    assert all(res["ok"].values()), res["ok"]
    assert all(n > 0 for n in launches), launches
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (GATHER_F, GATHER_P)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(probe.comb_index()).to(dev)
    idx64 = idx.long()
    k8_ms, lib_ms, k8_turns = in_turns(
        lambda: hopper_gather.lane_gather(x, idx),
        lambda: torch.gather(x, 1, idx64), KERNEL_REPS)
    k9_ms = cuda_ms(lambda: hopper_gather.comb_gather12(x, idx), KERNEL_REPS)
    k8_plain = cuda_ms(lambda: gather.lane_gather(x, idx))
    k9_plain = cuda_ms(lambda: gather.comb_gather12(x, idx))
    # Bytes: x and idx read once, the output written once; K9's 12 adds an
    # output are far below the FP32 rate's bound.
    g_bytes = 3 * GATHER_F * GATHER_P * 4
    k8_bound, k8_by = bound(g_bytes, 0, FP32_FLOPS)
    k9_bound, k9_by = bound(g_bytes, 12 * GATHER_F * GATHER_P, FP32_FLOPS)
    say(f"gather: K8 lane_gather and K9 comb_gather12 bitwise to numpy and "
        f"to their plain versions in all {len(res['ok'])} cases; launches "
        f"K8/K9 over the probe's run {list(launches)}; at [{GATHER_F}, "
        f"{GATHER_P}] K8 {k8_ms * 1e3:.2f} us vs torch.gather "
        f"{lib_ms * 1e3:.2f} us (turns "
        f"{'/'.join(f'{t * 1e3:.2f}' for t in k8_turns)} us), plain "
        f"{k8_plain * 1e3:.1f} us; K9 {k9_ms * 1e3:.2f} us, plain "
        f"{k9_plain * 1e3:.1f} us; bound {k8_bound * 1e3:.3f} us each "
        f"({k8_by}: {g_bytes / 1e6:.2f} MB)")
    rows.append(dict(name="K8 lane_gather (the probe's take_along_axis)",
                     route="cuda", source=f"{PKG}/csrc/gather.cu",
                     replaces="tools/mosaic_probe.py:24",
                     launches=launches[0], max_abs_err=res["max_abs_err"]["K8"],
                     ms=k8_ms, plain_ms=k8_plain, bound_ms=k8_bound,
                     bound_by=k8_by, library_ms=lib_ms))
    rows.append(dict(name="K9 comb_gather12 (the probe's 12 summed gathers)",
                     route="cuda", source=f"{PKG}/csrc/gather.cu",
                     replaces="tools/mosaic_probe.py:83",
                     launches=launches[1], max_abs_err=res["max_abs_err"]["K9"],
                     ms=k9_ms, plain_ms=k9_plain, bound_ms=k9_bound,
                     bound_by=k9_by, library_ms=None))


def _full_step_outs(mesh, audio):
    """One full step from fresh states over `audio` (this rank's rows with
    a mesh), the step as shipped; outputs on the host."""
    import torch
    from audio_analyzer_rs_tpu_torch.parallel import mesh as pmesh
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    states = sharding.init_stream_states(TWO_RANK_B)
    if mesh is not None:
        states = pmesh.batch_sharding(mesh).shard(states)
    _, out = sharding.make_batched_full_step(mesh, FULL_SR)(states, audio)
    torch.cuda.synchronize()
    return sharding.FullStepOut(*(t.cpu() for t in out))


def two_rank_case(rank: int, world: int, audio16, scene):
    """Phase 14c on one of two ranks sharing the card (gloo): the full step
    over this rank's streams, the segmented pitch path, and the pooled
    wave, bitwise to one process."""
    import torch
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.parallel import dryrun
    from audio_analyzer_rs_tpu_torch.parallel import mesh as pmesh
    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = pmesh.make_mesh("cuda")
    local = pmesh.batch_sharding(mesh).shard(torch.from_numpy(audio16)).cuda()
    out = {"step": _full_step_outs(mesh, local)}
    out["segmented"] = segmented.segmented_pitch_analysis(
        scene, SR, segments=TWO_RANK_SEGMENTS, mesh=mesh)
    out["pool"] = dryrun.pooled_wave_check(mesh, TWO_RANK_LANES, MESH_WAVES,
                                           seed=7, device="cuda")
    out["backend"] = str(torch.distributed.get_backend())
    return out


def mesh_phase(card: str, audio44, full_outs, fleet_chunk,
               fleet_out) -> None:
    """Phase 14b and 14c: the mesh on the card.  World size 1 (NCCL, a
    FileStore): the 30-minute segmented pitch path bitwise to phase 4's
    mesh-free outputs, one full step at phase 12's configuration bitwise
    to phase 12's first step, the pooled wave over 33 lanes x 3 waves
    bitwise to `fused_slot_pool_step`.  Then two ranks on the one card
    (spawned, gloo): the full step at B = 16 bitwise to world size 1 (the
    step as shipped), the segmented pitch path at 8 segments bitwise, the
    pooled wave bitwise."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.parallel import dryrun
    from audio_analyzer_rs_tpu_torch.parallel import mesh as pmesh
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    t_phase = time.perf_counter()
    counters = counters_of(("K1", "K10", "K3", "K5", "K2"))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh("cuda")
            t0 = time.perf_counter()
            segmented.segmented_pitch_analysis(audio44, SR, mesh=mesh,
                                               transfer="resident")
            cold = time.perf_counter() - t0
            for mod in counters:
                mod.LAUNCHES = 0
            with PlainExtractions() as plain_x:
                t0 = time.perf_counter()
                got = segmented.segmented_pitch_analysis(
                    audio44, SR, mesh=mesh, transfer="resident")
                warm = time.perf_counter() - t0
            launches = [mod.LAUNCHES for mod in counters]
            assert all(n > 0 for n in off_path_zero(launches)), launches
            assert not plain_x.calls, \
                f"{plain_x.calls} plain extractions on the card"
            for a, b in zip(got, full_outs):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            piped = segmented.segmented_pitch_analysis(
                audio44, SR, mesh=mesh, transfer="pipelined")
            t0 = time.perf_counter()
            piped = segmented.segmented_pitch_analysis(
                audio44, SR, mesh=mesh, transfer="pipelined")
            warm_piped = time.perf_counter() - t0
            for a, b in zip(piped, full_outs):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            del piped
            _, out = sharding.make_batched_full_step(mesh, FULL_SR)(
                sharding.init_stream_states(FULL_B), fleet_chunk)
            for name, a, b in zip(sharding.FullStepOut._fields, out,
                                  fleet_out):
                assert same_bits_nan(a, b), f"full step on the mesh: {name}"
            pool = dryrun.pooled_wave_check(mesh, MESH_LANES, MESH_WAVES,
                                            seed=5, device="cuda")
        finally:
            dist.destroy_process_group()
    del out
    say(f"mesh: world size 1 (NCCL): segmented_pitch_analysis 30 min on the "
        f"mesh (transfer=\"resident\") bitwise to phase 4's mesh-free run, "
        f"cold {cold:.2f} s, warm "
        f"{warm:.3f} s, launches K1/K10/K3/K5/K2 {launches}, plain "
        f"extractions 0; with transfer=\"pipelined\" (each rank stages its "
        f"own rows) bitwise to the same, warm {warm_piped:.3f} s; "
        f"make_batched_full_step {FULL_B} streams x {fleet_chunk.shape[1]} "
        f"samples bitwise to phase 12's first step (every output, the fleet "
        f"statistics included); make_pooled_wave_step {pool['lanes']} lanes "
        f"x {pool['waves']} waves bitwise to fused_slot_pool_step")

    # Two ranks on the one card.
    audio16 = fleet_chunk[:TWO_RANK_B].cpu().numpy()
    scene = audio44[:int(TWO_RANK_SECONDS * SR)]
    t0 = time.perf_counter()
    ranks = dryrun.run_world(two_rank_case, 2, audio16, scene,
                             timeout=TWO_RANK_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    x16 = torch.from_numpy(audio16).cuda()
    ref = _full_step_outs(None, x16)
    ref_seg = segmented.segmented_pitch_analysis(
        scene, SR, segments=TWO_RANK_SEGMENTS)
    fields = sharding.FullStepOut._fields
    for f in fields[:5]:
        got = torch.cat([getattr(r["step"], f) for r in ranks])
        assert same_bits_nan(got, getattr(ref, f)), f"two ranks: {f}"
    want = float(ref.global_noise_floor_db)
    floor_err = abs(float(ranks[0]["step"].global_noise_floor_db) - want)
    assert floor_err <= 1e-5 * abs(want), floor_err
    assert torch.equal(ranks[0]["step"].global_noise_floor_db,
                       ranks[1]["step"].global_noise_floor_db)
    for r in ranks:
        assert int(r["step"].global_onset_count) == int(
            ref.global_onset_count)
        for a, b in zip(r["segmented"], ref_seg):
            assert np.array_equal(a, b), "two ranks: segmented differs"
        assert r["pool"] == {"lanes": TWO_RANK_LANES // 2,
                             "waves": MESH_WAVES}
    say(f"mesh: two ranks on the one card ({ranks[0]['backend']}, CUDA "
        f"tensors staged through the host for the collectives; "
        f"{two_s:.1f} s with the spawn): the full step at B = {TWO_RANK_B} "
        f"({TWO_RANK_B // 2} a rank), the step as shipped (no STFT "
        f"equalization), bitwise to world size 1 in every per-stream "
        f"output, the fleet floor within {floor_err:.2e} dB and the onset "
        f"count equal; segmented_pitch_analysis "
        f"{TWO_RANK_SECONDS:.0f} s at {TWO_RANK_SEGMENTS} segments bitwise; "
        f"the pooled wave {TWO_RANK_LANES} lanes x {MESH_WAVES} waves "
        f"bitwise; phase 14 took {time.perf_counter() - t_phase:.0f} s")


ORACLE_SECONDS = 25.0             # JAX tests/test_fullchain_divergence.py
ORACLE_STABLE_AGREEMENT = 0.98    # ... and its gates
ORACLE_ONSET_AGREEMENT = 0.999
ORACLE_MODE_AGREEMENT = 0.999
ORACLE_K5_RTOL, ORACLE_K5_ATOL = 1e-6, 2.0 ** -126
ORACLE_K4_RTOL = 1e-6             # tests/test_torch_onset.py's values


def stable_sets(sf, sv) -> list:
    """Each frame's stable frequencies in integer deci-hertz, sorted."""
    return [sorted(int(round(float(f) * 10)) for f in sf[i][sv[i]])
            for i in range(sf.shape[0])]


def oracle_phase(card: str, audio44, oracle_in: dict, device="cuda",
                 seconds: float = ORACLE_SECONDS, lanes: int = FULL_B):
    """Phase 15 ("oracle:" lines): the port's float64 oracles, on the card's
    machine.  `make_batched_full_step` over JAX's divergence scene
    (mixed_scene(seconds, 48 kHz, seed=3), whole slots) in lane 0, "hist"
    and "exact", at B = 1 and at B = `lanes` with phase 12's streams in the
    other lanes (no STFT equalization), lane 0
    against `full_chain_np` at JAX's gates; the stable-set and fired flips
    between the two B.  Then K5 and K4 at phase 3's S = 1 calls against
    `noise_floor_np` (the FMA form) and `onset_np`."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, onset
    from audio_analyzer_rs_tpu_torch.parallel import sharding
    t_phase = time.perf_counter()
    x = gen.mixed_scene(seconds, FULL_SR, seed=3)
    x = x[:(len(x) // 1024) * 1024]
    t0 = time.perf_counter()
    oracle = sharding.full_chain_np(x, FULL_SR)
    oracle_s = time.perf_counter() - t0
    sets_o = [sorted(int(round(float(f) * 10)) for f, _ in fr)
              for fr in oracle["stable"]]
    fired_o = oracle["onset_fired"]
    fleet = np.stack([x] + [audio44[k * 600_000:k * 600_000 + len(x)]
                            for k in range(1, lanes)])
    outs = {}
    for b in (1, lanes):
        audio_b = torch.from_numpy(fleet[:b]).to(device)
        for mode in ("hist", "exact"):
            step = sharding.make_batched_full_step(None, FULL_SR,
                                                   dyn_mode=mode,
                                                   device=device)
            _, out = step(sharding.init_stream_states(b, device=device),
                          audio_b)
            sf, sv, fired = (t[0].cpu().numpy() for t in (
                out.stable_freqs, out.stable_valid, out.onset_fired))
            assert np.isfinite(sf).all() and len(sets_o) == sf.shape[0]
            sets = stable_sets(sf, sv)
            stable = float(np.mean([a == o for a, o in zip(sets, sets_o)]))
            onsets = float((fired == fired_o[:len(fired)]).mean())
            outs[b, mode] = dict(sets=sets, sv=sv, fired=fired,
                                 stable=stable, onsets=onsets)
            assert stable >= ORACLE_STABLE_AGREEMENT, (b, mode, stable)
            assert onsets >= ORACLE_ONSET_AGREEMENT, (b, mode, onsets)
            del out
        del audio_b
    texts = []
    for b in (1, lanes):
        h, e = outs[b, "hist"], outs[b, "exact"]
        modes = float(np.mean([a == c for a, c in zip(h["sets"],
                                                      e["sets"])]))
        assert modes >= ORACLE_MODE_AGREEMENT, (b, modes)
        assert np.array_equal(h["fired"], e["fired"]), b
        texts.append(
            f"B = {b}: stable sets against the oracle {h['stable']:.4%} "
            f"hist, {e['stable']:.4%} exact (>= 98%), onset frames "
            f"{h['onsets']:.4%} / {e['onsets']:.4%} (>= 99.9%), hist "
            f"against exact {modes:.4%} (>= 99.9%), fired equal")
    flips = []
    for mode in ("hist", "exact"):
        one, many = outs[1, mode], outs[lanes, mode]
        counts = (int((one['sv'] != many['sv']).sum()),
                  sum(a != c for a, c in zip(one['sets'], many['sets'])),
                  int((one['fired'] != many['fired']).sum()))
        # K11's magnitudes do not depend on the batch.
        assert counts == (0, 0, 0), (mode, counts)
        flips.append(f"{mode} {counts[0]} stable slots, {counts[1]} frames' "
                     f"sets, {counts[2]} fired")
    say(f"oracle: make_batched_full_step on mixed_scene({seconds:.0f} s, "
        f"48 kHz, seed=3) ({len(x)} samples, {len(sets_o)} pitch and "
        f"{len(fired_o)} onset frames; {int(fired_o.sum())} oracle onsets) "
        f"in lane 0 against full_chain_np (its wall {oracle_s:.1f} s on the "
        f"host): " + "; ".join(texts) + f"; B = 1 against B = {lanes} "
        f"(no equalization): " + ", ".join(flips))

    # K5 and K4 at phase 3's S = 1 calls against their oracles.
    mags5, gf5, kc = oracle_in["K5"]
    dev = torch.device(device)
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(2048 // 2 + 1, dev, (1,)), mags5.to(dev),
        gf5.to(dev), kc)
    eff = eff[0, :, :kc].cpu().numpy()
    t0 = time.perf_counter()
    eff_o = noisefloor.noise_floor_np(mags5[0, :, :kc].numpy(),
                                      gf5[0].numpy(), fma=True)
    k5_s = time.perf_counter() - t0
    np.testing.assert_allclose(eff, eff_o, rtol=ORACLE_K5_RTOL,
                               atol=ORACLE_K5_ATOL)
    k5_bitwise = float((eff.view(np.uint32) == eff_o.view(np.uint32)).mean())
    mags4, gf4, ts4, hold4 = oracle_in["K4"]
    _, out4 = onset.onset_scan(onset.init_state(onset.HALF, dev, (1,)),
                               *(t.to(dev) for t in oracle_in["K4"]))
    t0 = time.perf_counter()
    o4 = onset.onset_np(mags4[0].numpy(), gf4[0].numpy(), ts4[0].numpy(),
                        hold4[0].numpy())
    k4_s = time.perf_counter() - t0
    fired4 = out4.fired[0].cpu().numpy()
    vel4 = out4.velocity[0].cpu().numpy().astype(np.float64)
    assert np.array_equal(fired4, o4["fired"]), "K4 fired against onset_np"
    np.testing.assert_allclose(vel4, o4["velocity"], rtol=ORACLE_K4_RTOL,
                               atol=0)
    nz = o4["velocity"] != 0
    vel_rel = float((np.abs(vel4 - o4["velocity"])[nz]
                     / o4["velocity"][nz]).max()) if nz.any() else 0.0
    say(f"oracle: K5 at S=1 x N={eff.shape[0]} (band {kc}) against "
        f"noise_floor_np(fma=True): within rtol {ORACLE_K5_RTOL:g}, atol "
        f"2^-126, {k5_bitwise:.4%} of the effective floors bitwise (oracle "
        f"{k5_s:.1f} s); K4 at S=1 x N={len(fired4)} with tick-suppressed "
        f"and held frames against onset_np: fired equal ({int(fired4.sum())} "
        f"onsets), velocities within rtol {ORACLE_K4_RTOL:g} (largest "
        f"{vel_rel:.2e}; oracle {k4_s:.1f} s); {card}; phase 15 took "
        f"{time.perf_counter() - t_phase:.0f} s")


def main() -> int:
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from audio_analyzer_rs_tpu_torch import _build, analysis
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.models.analyzer import (OnsetAnalyzer,
                                                             PitchAnalyzer)
    from audio_analyzer_rs_tpu_torch.ops import (hopper_comb, hopper_extract,
                                                 hopper_noisefloor,
                                                 hopper_onset, hopper_rfft,
                                                 hopper_stft, hopper_tracker,
                                                 noisefloor, onset, pitch,
                                                 tracker)
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.stft import (FIDELITY_MAX_REL_MSE,
                                                      spectral_rel_mse,
                                                      windowed_mags)
    from audio_analyzer_rs_tpu_torch.utils.framing import (frame_signal,
                                                           num_frames)
    dev = torch.device("cuda")
    window, hop, half = 2048, 512, 1025

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")

    # 2. Build every kernel from csrc/, and K5's chain probe beside them.
    t0 = time.perf_counter()
    k5_chain = _tool("k5_chain")
    chain_build = k5_chain.start_build()
    lib_path, log = _build.build()
    _build.lib()
    chain_lib = k5_chain.finish_build(chain_build)
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"({'nvcc ran' if log else 'cached'}) -> {lib_path.name}")
    for line in log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # 3. Kernels against their plain versions at the main-path shapes.
    t0 = time.perf_counter()
    audio = gen.mixed_scene(1800.0, SR, seed=0)
    say(f"scene: 30 min mixed scene, {len(audio)} samples, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    n_total = num_frames(len(audio), window, hop)
    plan = segmented._plan_streams(n_total, 128, 128, 64, window, hop)
    audio_dev = torch.from_numpy(np.pad(
        audio, (0, max(0, plan.max_sample - len(audio))))).to(dev)
    streams = segmented._slice_streams(audio_dev, plan.stream_start * hop,
                                       plan.stream_samples)
    chunk = streams[:, 2 * 64 * hop:2 * 64 * hop + plan.chunk_samples]
    frames = frame_signal(chunk, window, hop)            # [128, 64, 2048] view
    bin_width = float(np.float32(SR) / np.float32(window))
    kc = pitch.candidate_band(bin_width, half)
    min_bin, max_bin = pitch._bins(bin_width, half, pitch.MIN_FREQ,
                                   pitch.MAX_FREQ)
    trig = rdft_trig(window, dev)[:, :2 * (kc + 1)]
    win = hann(window, dev)
    rows = []

    mags = hopper_stft.dft_mag(frames, trig, win)
    mags_plain = hopper_stft.dft_mag_plain(frames, trig, win)
    torch.cuda.synchronize()
    k1_err = float((mags - mags_plain).abs().max())
    k1_scale = float(mags_plain.abs().max())
    assert k1_err <= K1_REL_TOL * k1_scale, (k1_err, k1_scale)
    probe = gen.tone_with_harmonics(220.0, 1.0, SR, harmonics=8,
                                    amplitude=0.5)
    mse = spectral_rel_mse(probe, window, hop, device=dev)
    assert mse < FIDELITY_MAX_REL_MSE, mse
    windowed = (frames * win).reshape(-1, window).contiguous()
    k1_ms, k1_lib_ms, k1_turns = in_turns(
        lambda: hopper_stft.dft_mag(frames, trig, win),
        lambda: torch.matmul(windowed, trig), KERNEL_REPS)
    k1_plain_ms = cuda_ms(lambda: hopper_stft.dft_mag_plain(frames, trig,
                                                            win))
    n_frames, cols = windowed.shape[0], trig.shape[1]
    k1_flops = 2 * n_frames * window * cols
    span = (frames.shape[1] - 1) * frames.stride(1) + window
    k1_bytes = (frames.shape[0] * span * 4 + nbytes(trig, win, mags))
    k1_bound, k1_by = bound(k1_bytes, 3 * k1_flops, TF32_FLOPS)
    say(f"K1 stft {tuple(frames.shape)} -> {tuple(mags.shape)}: max|d| "
        f"{k1_err:.3e} of max {k1_scale:.3e} vs cuBLAS FP32 (tol "
        f"{K1_REL_TOL:g}x); spectral rel MSE {mse:.3e} (< "
        f"{FIDELITY_MAX_REL_MSE:g}); {k1_ms:.3f} ms vs cuBLAS FP32 GEMM "
        f"{k1_lib_ms:.3f} ms (turns kernel/cuBLAS/kernel/cuBLAS "
        f"{'/'.join(f'{t:.3f}' for t in k1_turns)}), plain "
        f"{k1_plain_ms:.3f} ms; bound {k1_bound:.3f} ms ({k1_by}: "
        f"{3 * k1_flops / 1e9:.1f} GFLOP 3xTF32 at 495 TFLOP/s; "
        f"{k1_bytes / 1e6:.1f} MB; FP32 FFMA floor "
        f"{k1_flops / FP32_FLOPS * 1e3:.3f} ms)")
    rows.append(dict(name="K1 stft (windowed banded rDFT magnitude)",
                     route="cuda", source=f"{PKG}/csrc/stft.cu",
                     replaces="audio_analyzer_rs_tpu/ops/pallas_stft.py:52",
                     max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
                     bound_ms=k1_bound, bound_by=k1_by,
                     library_ms=k1_lib_ms))
    del windowed

    s_n = frames.shape[0] * frames.shape[1]
    flat = mags.reshape(s_n, -1)
    gf = torch.full((frames.shape[0], frames.shape[1]),
                    float(noisefloor.global_floor_linear(-96.0, half)),
                    device=dev)
    _, eff = noisefloor.noise_floor_scan(
        noisefloor.init_state(half, dev, (frames.shape[0],)), mags, gf, kc)
    pm, frac, m_c, _, _ = pitch._pre_comb(flat, eff.reshape(s_n, -1),
                                          min_bin, max_bin, kc)
    fund = m_c.contiguous()
    got = hopper_comb.comb(pm, frac, fund, half, max_bin)
    ref = pitch._comb(pm, frac, fund, half, max_bin)
    torch.cuda.synchronize()
    for g, r, name in zip(got, ref, ("score", "longest_run", "total_harms")):
        assert torch.equal(g, r), f"K2 {name} differs from the plain comb"
    k2_err = float((got[0] - ref[0]).abs().max())
    k2_ms, k2_plain_ms, k2_turns = in_turns(
        lambda: hopper_comb.comb(pm, frac, fund, half, max_bin),
        lambda: pitch._comb(pm, frac, fund, half, max_bin), 1)
    n_peaks = int((pm > 0).sum())
    # Operations: a (candidate k, harmonic n) pair runs while e = frac*n <
    # half and n*(k-1) <= max_bin, and its window reads at most 4 bins.
    harm = torch.arange(2, pitch.MAX_HARMONICS + 1, device=dev)
    cand = torch.arange(pm.shape[1], device=dev)[:, None]
    pairs = int(((frac[..., None] * harm < half)
                 & (harm * (cand - 1) <= max_bin)).sum())
    k2_bytes = nbytes(pm, frac, fund, *got)
    k2_bound, k2_by = bound(k2_bytes, 4 * pairs, FP32_FLOPS)
    say(f"K2 comb {tuple(pm.shape)} ({n_peaks} peaks, {pairs} live "
        f"(candidate, harmonic) pairs): bitwise equal; {k2_ms:.3f} ms vs "
        f"plain {k2_plain_ms:.3f} ms (turns kernel/plain/kernel/plain "
        f"{'/'.join(f'{t:.3f}' for t in k2_turns)}); bound "
        f"{k2_bound:.4f} ms ({k2_by}: {k2_bytes / 1e6:.1f} MB)")
    rows.append(dict(name="K2 comb (13-harmonic comb; on the paths it runs "
                     "inside K10)", route="cuda",
                     source=f"{PKG}/csrc/comb.cu",
                     replaces="audio_analyzer_rs_tpu/ops/pallas_comb.py:56",
                     max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
                     bound_ms=k2_bound, bound_by=k2_by, library_ms=None))

    # K10: the whole extraction in one launch, bitwise to the plain
    # `_extract` (plain torch, its comb too) on the step's K1 magnitudes and K5
    # floors, 8,192 frames.
    eff_flat = eff.reshape(s_n, -1)
    x_args = (bin_width, min_bin, max_bin, pitch.MIN_FREQ, pitch.MAX_FREQ,
              half)
    got10 = hopper_extract.extract(flat, eff_flat, *x_args)
    ref10 = pitch._extract(flat, eff_flat, *x_args)
    torch.cuda.synchronize()
    for name, g, r in zip(pitch.PitchFrame._fields, got10, ref10):
        assert same_bits(g, r), f"K10 {name} differs from the plain extraction"
    k10_err = float((got10.scores - ref10.scores).abs().max())
    k10_ms, k10_plain_ms, k10_turns = in_turns(
        lambda: hopper_extract.extract(flat, eff_flat, *x_args),
        lambda: pitch._extract(flat, eff_flat, *x_args), 1)
    # Bytes: the band's magnitudes (kc + 1) and floors (kc) read once, the
    # three [N, 8] outputs written once; ~30 operations a bin (the logs,
    # the peak tests) are far below the FP32 rate's bound.
    k10_bytes = s_n * (2 * kc + 1) * 4 + nbytes(*got10)
    k10_bound, k10_by = bound(k10_bytes, 30 * s_n * (kc + 1), FP32_FLOPS)
    say(f"K10 extract [{s_n}, {kc + 1}] magnitudes and [{s_n}, {kc}] floors "
        f"-> [{s_n}, 8] ({int(ref10.valid.sum())} notes): bitwise equal to "
        f"the plain extraction (freqs, scores, valid); {k10_ms:.4f} ms vs "
        f"plain {k10_plain_ms:.3f} ms (turns kernel/plain/kernel/plain "
        f"{'/'.join(f'{t:.4f}' for t in k10_turns)}); bound "
        f"{k10_bound * 1e3:.2f} us ({k10_by}: {k10_bytes / 1e6:.1f} MB); "
        f"achieved {k10_bytes / k10_ms / 1e6:.0f} GB/s against "
        f"{HBM_BYTES_PER_S / 1e9:.0f} ({k10_bound / k10_ms:.1%} of the "
        f"bound)")
    rows.append(dict(name="K10 extract (the pitch extraction: peaks, comb, "
                     "gates, top-32, ghosts, dedup, first 8)", route="cuda",
                     source=f"{PKG}/csrc/extract.cu",
                     replaces="audio_analyzer_rs_tpu/ops/pitch.py:294",
                     note="port-only kernel: no Pallas twin (XLA fused "
                     "_extract_single on the TPU)",
                     max_abs_err=k10_err, ms=k10_ms, plain_ms=k10_plain_ms,
                     bound_ms=k10_bound, bound_by=k10_by, library_ms=None,
                     gb_per_s=k10_bytes / k10_ms / 1e6))
    del got10, ref10

    # K1 at the latency shapes (the live slot's [1, 2, 2048] and the pool
    # wave's [33, 2, 2048] at 48 kHz's band, the debug slot's [1, 2] at
    # full width): split over the sample depth, bitwise to the unsplit
    # launch, timed in turns with it and beside cuBLAS FP32 and the plain
    # version.
    bw48 = float(np.float32(LIVE_SR) / np.float32(window))
    trig48 = rdft_trig(window, dev)[:, :2 * (pitch.candidate_band(
        bw48, half) + 1)]
    trig_full = rdft_trig(window, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    at = 1000 * hop
    latency = (
        ("K1-live", "[1, 2, 2048]", trig48,
         frame_signal(audio_dev[at:at + hop + window], window, hop)[None]),
        ("K1-pool", "[33, 2, 2048]", trig48, frame_signal(torch.stack([
            audio_dev[at + 9000 * i:at + 9000 * i + hop + window]
            for i in range(33)]), window, hop)),
        ("K1-debug", "[1, 2, 2048], full width", trig_full,
         frame_signal(audio_dev[at:at + hop + window], window, hop)[None]))
    for tag, shape, tr, fr in latency:
        got = hopper_stft.dft_mag(fr, tr, win)
        one = hopper_stft._dft_mag(fr, tr, win, splits=1)
        ref = hopper_stft.dft_mag_plain(fr, tr, win)
        torch.cuda.synchronize()
        assert same_bits(got, one), f"{tag}: the split is not the unsplit"
        err = float((got - ref).abs().max())
        assert err <= K1_REL_TOL * float(ref.abs().max()), (tag, err)
        n_fr = fr.shape[0] * fr.shape[1]
        cols_pad = hopper_stft._cached_split(tr)[1]
        splits = hopper_stft.split_count(n_fr, cols_pad, window, sms)
        assert splits > 1, (tag, splits)
        t_split, t_one, turns = in_turns(
            lambda: hopper_stft.dft_mag(fr, tr, win),
            lambda: hopper_stft._dft_mag(fr, tr, win, splits=1),
            KERNEL_REPS)
        wf = (fr * win).reshape(-1, window).contiguous()
        t_lib = cuda_ms(lambda: torch.matmul(wf, tr), KERNEL_REPS)
        t_plain = cuda_ms(lambda: hopper_stft.dft_mag_plain(fr, tr, win))
        span = (fr.shape[1] - 1) * fr.stride(1) + window
        nb = fr.shape[0] * span * 4 + nbytes(tr, win, got)
        b_ms, b_by = bound(nb, 3 * 2 * n_fr * window * tr.shape[1],
                           TF32_FLOPS)
        split_table = 2 * cols_pad * window * 4
        b_split, _ = bound(nb - nbytes(tr) + split_table, 0, TF32_FLOPS)
        say(f"{tag} stft split {shape} -> {got.shape[-1]} bins ({splits} "
            f"blocks a column tile): bitwise equal to the unsplit launch, "
            f"max|d| {err:.3e} vs plain; split {t_split * 1e3:.2f} us vs "
            f"unsplit {t_one * 1e3:.2f} us (turns split/unsplit/split/unsplit "
            f"{'/'.join(f'{t * 1e3:.2f}' for t in turns)}), cuBLAS FP32 "
            f"{t_lib * 1e3:.2f} us, plain {t_plain * 1e3:.2f} us; bound "
            f"{b_ms * 1e3:.2f} us ({b_by}: {nb / 1e6:.1f} MB with the "
            f"table; {b_split * 1e3:.2f} us with the {split_table / 1e6:.1f} "
            f"MB split table the kernel reads)")
        rows.append(dict(name=f"{tag} stft split over the sample depth, "
                         f"{shape} -> {got.shape[-1]} bins", route="cuda",
                         source=f"{PKG}/csrc/stft.cu",
                         replaces="audio_analyzer_rs_tpu/ops/pallas_stft.py:52",
                         launches=0, max_abs_err=err, ms=t_split,
                         plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=t_lib, unsplit_ms=t_one, splits=splits,
                         bound_split_table_ms=b_split))

    pf = pitch.extract_pitches(flat, eff.reshape(s_n, -1), bin_width,
                               true_half=half)
    main_raws = (pf.freqs.reshape(128, 64, 8), pf.scores.reshape(128, 64, 8),
                 pf.valid.reshape(128, 64, 8),
                 torch.zeros((128, 64), dtype=torch.bool, device=dev))
    rnd = tuple(torch.from_numpy(a).to(dev)
                for a in random_raws(np.random.default_rng(11), 128, 64))
    rng3 = np.random.default_rng(12)
    raws256 = tuple(torch.from_numpy(a).to(dev)
                    for a in random_raws(rng3, 128, 256))
    raws64 = tuple(r[:, :64].contiguous() for r in raws256)
    raws4096 = tuple(torch.from_numpy(a).to(dev)
                     for a in random_raws(rng3, 1, 4096))
    st0 = tracker.init_state(dev, (128,))
    st1 = tracker.init_state(dev, (1,))

    def k3_plain(st, raws):
        st, emits = tracker.tracker_scan_plain(st, *raws)
        return st, tracker.select_stable(*emits)

    for label, st, raws in (("random", st0, rnd),
                            ("main-path", st0, main_raws),
                            ("S=1 N=4096", st1, raws4096)):
        st_k, out_k = hopper_tracker.tracker_scan(st, *raws)
        st_p, out_p = k3_plain(st, raws)
        torch.cuda.synchronize()
        for name, g, r in zip(("freq", "score", "valid"), out_k, out_p):
            assert same_bits(g, r), f"K3 {label} {name} differs"
        for name in tracker.TrackerState._fields:
            assert same_bits(getattr(st_k, name), getattr(st_p, name)), \
                f"K3 {label} final {name} differs"
        if label == "main-path":
            k3_err = float((out_k[0] - out_p[0]).abs().max())
            k3_out = out_k
    k3_ms = cuda_ms(lambda: hopper_tracker.tracker_scan(st0, *main_raws),
                    KERNEL_REPS)
    with SmClock() as k3_clock:
        k3_ms64 = cuda_ms(lambda: hopper_tracker.tracker_scan(st0, *raws64),
                          KERNEL_REPS)
        k3_ms256 = cuda_ms(lambda: hopper_tracker.tracker_scan(
            st0, *raws256), KERNEL_REPS)
    k3_ms4096 = cuda_ms(lambda: hopper_tracker.tracker_scan(st1, *raws4096),
                        KERNEL_REPS)
    k3_plain_ms = cuda_ms(lambda: k3_plain(st0, main_raws))
    slope_ns = (k3_ms256 - k3_ms64) / (256 - 64) * 1e6
    slope_cycles = slope_ns * k3_clock.mhz / 1e3
    # Bytes: raws, onsets, the state in and out, the stable top-8 out; the
    # work is a dependent chain of 64 frames x 8 match rounds a stream, far
    # below any rate's bound.
    k3_bytes = (nbytes(*main_raws, *k3_out) + 2 * nbytes(*st0))
    k3_bound, k3_by = bound(k3_bytes, 0, FP32_FLOPS)
    say(f"K3 tracker (scan + select_stable fused): bitwise equal to the plain "
        f"scan + select_stable on random, main-path and S=1 N=4096 raws "
        f"({int(k3_out[2].sum())} stable outputs on the main path); S=128 "
        f"N=64 {k3_ms:.4f} ms on the main-path raws; random raws S=128 N=64 "
        f"{k3_ms64:.4f} ms, N=256 {k3_ms256:.4f} ms, S=1 N=4096 "
        f"{k3_ms4096:.4f} ms; per frame (N=64 -> 256) "
        f"{k3_clock.cycles(slope_ns)}; "
        f"plain {k3_plain_ms:.3f} ms; bound {k3_bound * 1e3:.2f} us ({k3_by}: "
        f"{k3_bytes / 1e6:.2f} MB)")
    rows.append(dict(name="K3 tracker (batched PitchTracker scan + "
                     "select_stable)",
                     route="cuda", source=f"{PKG}/csrc/tracker.cu",
                     replaces="audio_analyzer_rs_tpu/ops/pallas_tracker.py:51",
                     max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms,
                     bound_ms=k3_bound, bound_by=k3_by, library_ms=None,
                     ms_random_s128_n64=k3_ms64, ms_random_s128_n256=k3_ms256,
                     ms_s1_n4096=k3_ms4096, per_frame_ns=slope_ns,
                     per_frame_cycles=slope_cycles, sm_mhz=k3_clock.mhz,
                     sm_clock=k3_clock.source))

    # K5: the noise-floor scan, bitwise to the plain loop on the step's K1
    # magnitudes (fresh, then the state carried into the next step), on the
    # sequential analyzer's call (S=1 x N=4096, a full-width state, banded
    # magnitudes) and at full width (band=None, cuFFT magnitudes).
    def k1_mags(x):
        return hopper_stft.dft_mag(x, trig, win)

    prev_chunk = streams[:, 64 * hop:64 * hop + plan.chunk_samples]
    mags_prev = k1_mags(frame_signal(prev_chunk, window, hop))
    n_seq5 = 4096
    mags_seq5 = k1_mags(frame_signal(
        audio_dev[:(n_seq5 - 1) * hop + window], window, hop)[None])
    gf_seq5 = torch.full((1, n_seq5), gf[0, 0].item(), device=dev)
    mags_full = windowed_mags(frames, window, "fft")
    st128 = noisefloor.init_state(half, dev, (128,))
    st_one = noisefloor.init_state(half, dev, (1,))
    st_carried, _ = noisefloor.noise_floor_scan_plain(st128, mags_prev, gf,
                                                      kc)
    k5_cases = (("step, fresh", st128, mags, gf, kc),
                ("step, carried", st_carried, mags, gf, kc),
                ("S=1 N=4096", st_one, mags_seq5, gf_seq5, kc),
                ("full width", st128, mags_full, gf, None))
    k5_err = 0.0
    for label, st, m5, g5, band5 in k5_cases:
        st_k, eff_k = noisefloor.noise_floor_scan(st, m5, g5, band5)
        st_p, eff_p = noisefloor.noise_floor_scan_plain(st, m5, g5, band5)
        torch.cuda.synchronize()
        assert same_bits(eff_k, eff_p), f"K5 {label} effective differs"
        for name, g, r in zip(noisefloor.NoiseFloorState._fields, st_k,
                              st_p):
            assert same_bits(g, r), f"K5 {label} final {name} differs"
        k5_err = max(k5_err, float((eff_k - eff_p).abs().max()))
    # Timed alone at a state as wide as the band (no tail), and through
    # the wrapper with the path's 1,025-wide state (K5 writes the tail).
    st_band = noisefloor.init_state(kc, dev, (128,))
    st_band1 = noisefloor.init_state(kc, dev, (1,))
    k5_ms = cuda_ms(lambda: hopper_noisefloor.noise_floor_scan(
        st_band, mags, gf, kc), KERNEL_REPS)
    with SmClock() as k5_clock:
        k5_ms_seq = cuda_ms(lambda: hopper_noisefloor.noise_floor_scan(
            st_band1, mags_seq5, gf_seq5, kc), KERNEL_REPS)
    k5_wrapper_ms = cuda_ms(lambda: noisefloor.noise_floor_scan(
        st128, mags, gf, kc), KERNEL_REPS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    noisefloor.noise_floor_scan_plain(st128, mags, gf, kc)
    end.record()
    end.synchronize()
    k5_plain_ms = start.elapsed_time(end)
    # Bytes: the band of the magnitudes and the global floors read, the
    # effective floors written, the band of the state in and out; ~30
    # operations a bin and frame are far below the FP32 rate's bound.
    s5, n5f = mags.shape[:2]
    k5_bytes = (2 * s5 * n5f * kc * 4 + nbytes(gf)
                + 2 * (3 * s5 * kc * 4 + s5))
    k5_bound, k5_by = bound(k5_bytes, 30 * s5 * n5f * kc, FP32_FLOPS)
    # At S=1 the bound is each bin's floor recurrence: one warp of 32 bins
    # alone on its SM, its frames in shared memory (the slowest warp sets
    # the time).
    chain = k5_chain.chain_cycles(chain_lib, mags_seq5[0], gf_seq5[0], kc)
    k5_cycles_seq = k5_ms_seq / n_seq5 * 1e6 * k5_clock.mhz / 1e3
    say(f"K5 noise floor: bitwise equal to the plain scan (effective floors "
        f"and the final state) on the step's K1 magnitudes "
        f"{tuple(mags.shape)} at band {kc} from fresh and carried states, "
        f"at S=1 N={n_seq5} with a {half}-wide state, and at full width "
        f"(band=None); S=128 N=64 {k5_ms * 1e3:.2f} us alone "
        f"({k5_bound / k5_ms:.1%} of the bound), "
        f"{k5_wrapper_ms * 1e3:.2f} us through the wrapper with the "
        f"{half}-wide state (the tail written by the kernel); S=1 "
        f"N={n_seq5} {k5_ms_seq:.4f} ms, a frame "
        f"{k5_clock.cycles(k5_ms_seq / n_seq5 * 1e6)}; its chain bound (the "
        f"floor recurrence alone) {max(chain):.1f} cycles a frame (slowest "
        f"of {len(chain)} warps; mean {statistics.mean(chain):.1f}), "
        f"{max(chain) / k5_cycles_seq:.1%} of the kernel's; "
        f"plain {k5_plain_ms:.1f} ms at S=128 N=64 (one sample, ~30 "
        f"launches a frame); bound {k5_bound * 1e3:.2f} us ({k5_by}: "
        f"{k5_bytes / 1e6:.1f} MB)")
    k5_row = dict(name="K5 noise floor (the per-bin floor recurrence)",
                  route="cuda", source=f"{PKG}/csrc/noisefloor.cu",
                  replaces="audio_analyzer_rs_tpu/ops/noisefloor.py:98",
                  max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms,
                  plain_samples=1, bound_ms=k5_bound, bound_by=k5_by,
                  library_ms=None, wrapper_ms=k5_wrapper_ms,
                  share_of_bound=k5_bound / k5_ms,
                  ms_s1_n4096=k5_ms_seq, cycles_a_frame_s1=k5_cycles_seq,
                  chain_cycles_a_frame_s1=max(chain),
                  share_of_chain_bound_s1=max(chain) / k5_cycles_seq,
                  sm_mhz=k5_clock.mhz, sm_clock=k5_clock.source)
    oracle_in = {"K5": (mags_seq5.cpu(), gf_seq5.cpu(), kc)}
    del mags_prev, mags_seq5, mags_full
    del streams, chunk, frames, audio_dev

    # K4: the onset scan, on the 30-minute scene's "fft" magnitudes as the
    # segmented onset path gives them (128 streams, 4,096-frame steps).
    o_win, o_hop = onset.WINDOW, onset.HOP
    n_on = num_frames(len(audio), o_win, o_hop)
    o_plan = segmented._plan_streams(
        n_on, segmented.auto_segments(n_on, 128), 128, 4096, o_win, o_hop)
    o_audio = torch.from_numpy(np.pad(
        audio, (0, max(0, o_plan.max_sample - len(audio))))).to(dev)
    o_streams = segmented._slice_streams(
        o_audio, o_plan.stream_start * o_hop, o_plan.stream_samples)
    mags4 = windowed_mags(frame_signal(o_streams[:, :o_plan.chunk_samples],
                                       o_win, o_hop), o_win, "fft")
    s_o, n_o = mags4.shape[:2]                   # 128 x 4096 x 129
    gf_on = float(noisefloor.global_floor_linear(-96.0, onset.HALF))
    gf4 = torch.full((s_o, n_o), gf_on, device=dev)
    no4 = torch.zeros((s_o, n_o), dtype=torch.bool, device=dev)
    st4 = onset.init_state(onset.HALF, dev, (s_o,))
    st1 = onset.init_state(onset.HALF, dev, (1,))
    in1k = (mags4[:, :1024].contiguous(), gf4[:, :1024].contiguous(),
            no4[:, :1024].contiguous(), no4[:, :1024].contiguous())
    ts1 = torch.zeros((1, 4096), dtype=torch.bool, device=dev)
    hold1 = torch.zeros_like(ts1)
    ts1[0, ::97] = True
    hold1[0, 50::89] = True
    in_one = (mags4[7:8].contiguous(), gf4[:1].contiguous(), ts1, hold1)
    # More streams than the card holds blocks at once, as the full step at
    # 2,048 streams: the scene's magnitudes cut into 256-frame streams.
    s2k = s_o * n_o // 256
    ts2k = torch.zeros((s2k, 256), dtype=torch.bool, device=dev)
    hold2k = torch.zeros_like(ts2k)
    ts2k[:, ::97] = True
    hold2k[:, 50::89] = True
    in2k = (mags4.reshape(s2k, 256, onset.HALF), gf4.reshape(s2k, 256),
            ts2k, hold2k)
    st2k = onset.init_state(onset.HALF, dev, (s2k,))
    k4_err, k4_fired = 0.0, []
    for label, st, inputs in (("S=128 N=1024", st4, in1k),
                              ("S=1 N=4096", st1, in_one),
                              (f"S={s2k} N=256", st2k, in2k)):
        st_k, out_k = hopper_onset.onset_scan(st, *inputs)
        st_p, out_p = onset.onset_scan_plain(st, *inputs)
        torch.cuda.synchronize()
        for name, g, r in zip(onset.OnsetFrameOut._fields, out_k, out_p):
            assert same_bits(g, r), f"K4 {label} {name} differs"
        for name, g, r in zip(onset.OnsetState._fields, st_k, st_p):
            assert same_bits(g, r), f"K4 {label} final {name} differs"
        for g, r in zip(out_k, out_p):
            if g.dtype == torch.float32:
                k4_err = max(k4_err, float((g - r).abs().max()))
        k4_fired.append(int(out_k.fired.sum()))
    oracle_in["K4"] = tuple(t.cpu() for t in in_one)
    n_seq = 131072
    mags_seq = windowed_mags(frame_signal(
        o_audio[:(n_seq - 1) * o_hop + o_win], o_win, o_hop)[None], o_win,
        "fft")
    gf_seq = torch.full((1, n_seq), gf_on, device=dev)
    no_seq = torch.zeros((1, n_seq), dtype=torch.bool, device=dev)
    with SmClock() as k4_clock:
        k4_ms = cuda_ms(lambda: hopper_onset.onset_scan(
            st4, mags4, gf4, no4, no4), KERNEL_REPS)
        k4_ms1k = cuda_ms(lambda: hopper_onset.onset_scan(st4, *in1k),
                          KERNEL_REPS)
    k4_ms_seq = cuda_ms(lambda: hopper_onset.onset_scan(
        st1, mags_seq, gf_seq, no_seq, no_seq), KERNEL_REPS)
    # The full step's calls, [2048, 7,485, 129] and its first 128 streams:
    # each stream a chunk of the scene from its own offset, through K11.
    resident = hopper_onset.resident_blocks(onset.HALF)
    assert resident >= 2, f"K4 keeps {resident} block(s) a SM at 129 bins"
    mags_fs = fullstep_onset_mags(o_audio, FULL_B * 16)
    gf_fs = torch.full(mags_fs.shape[:2], gf_on, device=dev)
    no_fs = torch.zeros(mags_fs.shape[:2], dtype=torch.bool, device=dev)
    k4_full = {}
    for s in (FULL_B, FULL_B * 16):
        fs_in = (mags_fs[:s], gf_fs[:s], no_fs[:s], no_fs[:s])
        fs_st = onset.init_state(onset.HALF, dev, (s,))
        fs_ms = cuda_ms(lambda: hopper_onset.onset_scan(fs_st, *fs_in),
                        KERNEL_REPS)
        fs_out = hopper_onset.onset_scan(fs_st, *fs_in)[1]
        b_ms, b_by = bound(nbytes(*fs_in, *fs_out) + 2 * nbytes(*fs_st),
                           30 * fs_in[0].numel(), FP32_FLOPS)
        k4_full[s] = (fs_ms, b_ms, b_by)
    del mags_fs, gf_fs, no_fs, fs_in, fs_out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    onset.onset_scan_plain(st4, mags4, gf4, no4, no4)
    end.record()
    end.synchronize()
    k4_plain_ms = start.elapsed_time(end)
    k4_slope_ns = (k4_ms - k4_ms1k) / (n_o - 1024) * 1e6
    k4_slope_cycles = k4_slope_ns * k4_clock.mhz / 1e3
    _, out4 = hopper_onset.onset_scan(st4, mags4, gf4, no4, no4)
    # Bytes: magnitudes, floors and flags in, the 8 per-frame outputs out,
    # the state in and out; the per-bin work (~30 operations a bin and
    # frame) is far below the FP32 rate's bound.
    k4_bytes = nbytes(mags4, gf4, no4, no4, *out4) + 2 * nbytes(*st4)
    k4_bound, k4_by = bound(k4_bytes, 30 * mags4.numel(), FP32_FLOPS)
    say(f"K4 onset scan: bitwise equal to the plain scan (every output and "
        f"the final state) on the scene's magnitudes at S=128 N=1024 and at "
        f"S=1 N=4096 and S={s2k} N=256 with tick-suppressed and held "
        f"frames ({k4_fired} fired); {resident} blocks a SM at 129 bins; "
        f"S=128 N=4096 {k4_ms:.4f} ms, S=128 N=1024 "
        f"{k4_ms1k:.4f} ms, S=1 N=131072 {k4_ms_seq:.3f} ms; the full "
        f"step's calls " + ", ".join(
            f"[{s}, {FULL_ONSET_FRAMES}, 129] {ms:.4f} ms (bound {b:.4f} ms, "
            f"{by})" for s, (ms, b, by) in k4_full.items()) + "; per frame "
        f"(N=1024 -> 4096) {k4_clock.cycles(k4_slope_ns)}; plain "
        f"{k4_plain_ms:.1f} ms at S=128 "
        f"N=4096 (one sample, ~60-80 launches a frame); bound "
        f"{k4_bound:.4f} ms ({k4_by}: {k4_bytes / 1e6:.1f} MB)")
    rows.append(dict(name="K4 onset (the onset recurrence)", route="cuda",
                     source=f"{PKG}/csrc/onset.cu",
                     replaces="audio_analyzer_rs_tpu/ops/onset.py:145",
                     max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain_ms,
                     plain_samples=1, bound_ms=k4_bound, bound_by=k4_by,
                     library_ms=None, ms_s128_n1024=k4_ms1k,
                     ms_s1_n131072=k4_ms_seq,
                     **{f"{k}_s{s}_n{FULL_ONSET_FRAMES}": v
                        for s, (ms, b, _) in k4_full.items()
                        for k, v in (("ms", ms), ("bound_ms", b))},
                     resident_blocks_h129=resident, per_frame_ns=k4_slope_ns,
                     per_frame_cycles=k4_slope_cycles, sm_mhz=k4_clock.mhz,
                     sm_clock=k4_clock.source))
    rows.append(k5_row)
    del o_audio, o_streams, mags4, gf4, no4, in1k, in_one, in2k, mags_seq
    del out4

    k11_phase(rows, probe, dev)

    # 4. The main path through the public entry points.
    tags = ("K1", "K10", "K3", "K5")
    counters = counters_of(tags)
    t0 = time.perf_counter()
    sf, ss, sv = segmented.segmented_pitch_analysis(audio, SR)
    cold = time.perf_counter() - t0
    plain_select, selects = tracker.select_stable, []
    tracker.select_stable = lambda *a: selects.append(1) or plain_select(*a)
    plain_nf_step, nf_steps = noisefloor._step, []
    noisefloor._step = lambda *a: nf_steps.append(1) or plain_nf_step(*a)
    for mod in counters + (hopper_comb,):
        mod.LAUNCHES = 0
    with PlainExtractions() as plain_x:
        t0 = time.perf_counter()
        sf, ss, sv = segmented.segmented_pitch_analysis(audio, SR)
        warm = time.perf_counter() - t0
    launches = [mod.LAUNCHES for mod in counters]
    tracker.select_stable = plain_select
    noisefloor._step = plain_nf_step
    assert all(n > 0 for n in launches), launches
    assert not selects, f"{len(selects)} plain select_stable calls"
    assert not nf_steps, f"{len(nf_steps)} plain floor steps on the CUDA path"
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    assert hopper_comb.LAUNCHES == 0, "K2 launched outside K10"
    assert sf.shape == ss.shape == sv.shape == (n_total, 8), sf.shape
    assert np.isfinite(sf).all() and np.isfinite(ss).all()
    assert sv.any(), "no stable pitch in 30 minutes of tones"
    auto = segmented._resolve_transfer("auto", "pitch", len(audio), SR, None)
    say(f"main path: segmented_pitch_analysis 30 min ({n_total} frames, "
        f"transfer=\"auto\": {auto}): "
        f"cold {cold:.2f} s, warm {warm:.2f} s = {n_total / warm:,.0f} "
        f"frames/s; launches K1/K10/K3/K5 {launches} (K2 0: its comb runs "
        f"inside K10), plain select_stable calls 0, plain floor steps 0, "
        f"plain extractions 0; "
        f"{int(sv.any(1).sum())} frames with a stable pitch")
    for tag, n in zip(tags, launches):
        row_of(rows, tag)["launches"] = n
    row_of(rows, "K2")["launches"] = hopper_comb.LAUNCHES
    feed_phase(card, audio, launches)

    takes = [audio[i * int(30 * SR):(i + 1) * int(30 * SR)] for i in range(8)]
    t0 = time.perf_counter()
    res = segmented.segmented_pitch_analysis_batch(takes, SR)
    batch_s = time.perf_counter() - t0
    n_take = num_frames(int(30 * SR), window, hop)
    for f, s, v in res:
        assert f.shape == s.shape == v.shape == (n_take, 8), f.shape
        assert np.isfinite(f).all() and np.isfinite(s).all()
    assert any(v.any() for _, _, v in res), "no stable pitch in 8 takes"
    say(f"batch: segmented_pitch_analysis_batch 8 takes x 30 s in "
        f"{batch_s:.2f} s; {sum(int(v.any(1).sum()) for _, _, v in res)} "
        f"frames with a stable pitch")

    # 5. Agreement with the sequential analyzer on the first 5 minutes.
    five = audio[:int(300 * SR)]
    n5 = num_frames(len(five), window, hop)
    t0 = time.perf_counter()
    seq = PitchAnalyzer(SR).process(five)
    seq_s = time.perf_counter() - t0
    gf5, gs5, gv5 = segmented.segmented_pitch_analysis(five, SR)
    seg0 = segmented._plan_streams(
        n5, segmented.auto_segments(n5, 128), 128, 64, window, hop
    ).payload_range(0, n5)[1]
    assert np.array_equal(gf5[:seg0], seq.stable_freqs[:seg0])
    assert np.array_equal(gs5[:seg0], seq.stable_scores[:seg0])
    assert np.array_equal(gv5[:seg0], seq.stable_valid[:seg0])
    agree = frame_agreement(gf5, gv5, seq.stable_freqs, seq.stable_valid)
    say(f"agreement: 5 min ({n5} frames), sequential PitchAnalyzer "
        f"{seq_s:.2f} s; segment 0 ({seg0} frames) bitwise equal; frame "
        f"agreement {agree:.6f} (>= {MIN_AGREEMENT})")
    assert agree >= MIN_AGREEMENT, agree

    # 6. The offline analysis API over the 30-minute scene: every kernel of
    # both pipelines, and no plain onset step on the CUDA path.
    t0 = time.perf_counter()
    arr = analysis.analyze_buffer_segmented(audio, SR)
    cold = time.perf_counter() - t0
    plain_step, steps = onset._step, []
    onset._step = lambda *a: steps.append(1) or plain_step(*a)
    noisefloor._step = lambda *a: nf_steps.append(1) or plain_nf_step(*a)
    counters = counters_of(COUNTED)
    for mod in counters:
        mod.LAUNCHES = 0
    with PlainExtractions() as plain_x:
        t0 = time.perf_counter()
        arr = analysis.analyze_buffer_segmented(audio, SR)
        warm = time.perf_counter() - t0
    launches = [mod.LAUNCHES for mod in counters]
    onset._step = plain_step
    noisefloor._step = plain_nf_step
    assert all(n > 0 for n in off_path_zero(launches)), launches
    assert not plain_x.calls, f"{plain_x.calls} plain extractions on the card"
    assert not steps, f"{len(steps)} plain onset steps on the CUDA path"
    assert not nf_steps, f"{len(nf_steps)} plain floor steps on the CUDA path"
    assert len(arr.rms) == n_total and arr.spectrogram.shape == (n_total,
                                                                 half)
    for col in (arr.rms, arr.energy, arr.centroid_hz, arr.flux,
                arr.yin_f0_hz, arr.stable_freqs, arr.spectrogram):
        assert np.isfinite(col).all()
    assert arr.onsets, "no onset in 30 minutes with percussion"
    assert arr.stable_valid.any() and arr.yin_voiced.any()
    say(f"analysis: analyze_buffer_segmented 30 min ({n_total} pitch frames, "
        f"{n_on} onset frames): cold {cold:.2f} s, warm {warm:.2f} s = "
        f"{n_total / warm:,.0f} pitch frames/s; launches K1/K10/K3/K4/K5/K11/K2 "
        f"{launches}, plain onset and floor steps 0, plain extractions 0; "
        f"{len(arr.onsets)} "
        f"onsets, "
        f"{int(arr.stable_valid.any(1).sum())} frames with a stable pitch, "
        f"{int(arr.yin_voiced.sum())} YIN-voiced frames")
    row_of(rows, "K4")["launches"] = launches[3]
    row_of(rows, "K11")["launches_analysis"] = launches[5]
    del arr
    # Where the warm wall goes: the upload and each pass alone, warm, on
    # the shared device copy; the feature chunks are the rest.
    t0 = time.perf_counter()
    shared = segmented._upload_f32(audio, dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    t0 = time.perf_counter()
    segmented.segmented_onset_analysis(audio, SR, device_audio=shared)
    t_on = time.perf_counter() - t0
    t0 = time.perf_counter()
    segmented.segmented_pitch_analysis(audio, SR, device_audio=shared)
    t_pi = time.perf_counter() - t0
    del shared
    say(f"analysis: warm wall split: upload {t_up:.3f} s, onset pass "
        f"{t_on:.3f} s, pitch pass {t_pi:.3f} s, feature chunks and "
        f"readback (the rest) {warm - t_up - t_on - t_pi:.3f} s")
    ores = feed_turns(lambda mode: segmented.segmented_onset_analysis(
        audio, SR, transfer=mode), "_vmapped_onset_chunks")
    say("feed: segmented_onset_analysis 30 min, pipelined bitwise to "
        "resident over 3 warm calls each in turns: " + "; ".join(
            f"{m} {ores[m]['median']:.4f} s (spread {ores[m]['spread']:.4f},"
            f" first kernel at {ores[m]['first']:.2f} ms)" for m in FEEDS)
        + "; transfer=\"auto\" resolves to "
        + segmented._resolve_transfer("auto", "onset", len(audio), SR, None))

    # 7. The sequential API over the first minute.
    minute = audio[:int(60 * SR)]
    t0 = time.perf_counter()
    res = analysis.analyze_buffer(minute, SR)
    ab_s = time.perf_counter() - t0
    n60 = num_frames(len(minute), window, hop)
    assert len(res.frames) == n60 == res.spectrogram.shape[0]
    voiced = sum(f.yin_voiced for f in res.frames)
    assert voiced > 0 and res.onsets
    assert all(np.isfinite(f.rms) and np.isfinite(f.centroid_hz)
               for f in res.frames)
    say(f"analysis: analyze_buffer 60 s in {ab_s:.2f} s: {len(res.frames)} "
        f"per-frame structs, {voiced} YIN-voiced, {len(res.onsets)} onsets, "
        f"{sum(bool(f.stable_pitches) for f in res.frames)} with a stable "
        f"pitch")

    # 8. The batched onset path over the 8 takes.
    t0 = time.perf_counter()
    ores = segmented.segmented_onset_analysis_batch(takes, SR)
    obatch_s = time.perf_counter() - t0
    n_take_o = num_frames(int(30 * SR), o_win, o_hop)
    for f, v, x, e in ores:
        assert f.shape == v.shape == x.shape == e.shape == (n_take_o,)
        assert np.isfinite(v).all() and np.isfinite(e).all()
    assert any(f.any() for f, _, _, _ in ores), "no onset in 8 takes"
    say(f"batch: segmented_onset_analysis_batch 8 takes x 30 s in "
        f"{obatch_s:.2f} s; {sum(int(f.sum()) for f, _, _, _ in ores)} "
        f"onsets")

    # 9. Onset agreement: the sequential OnsetAnalyzer on the first 5
    # minutes against the segmented run.
    t0 = time.perf_counter()
    oseq = OnsetAnalyzer(SR).process(five)
    oseq_s = time.perf_counter() - t0
    o5 = segmented.segmented_onset_analysis(five, SR)
    n5o = num_frames(len(five), o_win, o_hop)
    seg0o = segmented._plan_streams(
        n5o, segmented.auto_segments(n5o, 128), 128, 4096, o_win, o_hop
    ).payload_range(0, n5o)[1]
    ref5 = (oseq.fired, oseq.velocity, oseq.flux, oseq.energy)
    # K11's magnitudes do not depend on the batch (S = 1 x 131,072 frames
    # against 128 x 4,096), and K4 is bitwise: segment 0 is bitwise.
    for a, b, name in zip(o5, ref5, ("fired", "velocity", "flux", "energy")):
        assert np.array_equal(a[:seg0o], b[:seg0o]), f"segment 0: {name}"
    assert np.array_equal(np.flatnonzero(o5[0]),
                          np.flatnonzero(oseq.fired)), "onset sets differ"
    say(f"agreement: onsets, 5 min ({n5o} frames), sequential OnsetAnalyzer "
        f"{oseq_s:.2f} s; segment 0 ({seg0o} frames) bitwise equal (fired, "
        f"velocity, flux, energy); fired sets identical "
        f"({int(o5[0].sum())} onsets)")

    # 10. The live engine.
    live_phase(rows, card)

    # 11. The classroom: an engine pool.
    classroom_phase(rows, card)

    # 12. The batched full chain: K6, K7, make_batched_full_step, and the
    # floor warmup.
    fleet_chunk, fleet_out = fullstep_phase(rows, card, audio, (sf, ss, sv))

    # 13. The debug surface: K1 and K5 at full width, the recorders, the
    # CLI.
    devtools_phase(rows, card, audio)

    # 14. The probe's gathers (K8, K9) and the mesh: world size 1 on NCCL,
    # two ranks on the one card with gloo.
    gather_phase(rows)
    mesh_phase(card, audio, (sf, ss, sv), fleet_chunk, fleet_out)
    del fleet_chunk, fleet_out

    # 15. The float64 oracles on the card's machine (no JAX).
    oracle_phase(card, audio, oracle_in)

    say(json.dumps({"kernels": rows}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
