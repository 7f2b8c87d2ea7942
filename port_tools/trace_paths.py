#!/usr/bin/env python3
"""Trace the port's two offline paths on one GPU with torch.profiler: where
the host time goes by stage, the launches, and the device's idle share.

    python3 port_tools/trace_paths.py [--minutes 30] \
        [--out trace.json]

Paths: `segmented_pitch_analysis` and `analyze_buffer_segmented` over the
`mixed_scene(seed=0)` recording chip_smoke.py uses, each warmed by one
untraced call and then traced once.  Stages are marked by wrapping the
package's functions in `torch.profiler.record_function` for the traced call
(nothing in the package changes): the upload, the STFT (K1, or K11), the
noise-floor scan (K5), the extraction (K10), the tracker (K3),
and for the analysis API the onset pass (K11 + K4), the pitch pass and the
feature chunks (spectrogram, feature pack, YIN).

Per path, one JSON object: the host wall of the traced call; per stage its
host ms (inclusive, summed over calls), calls and the kernel launches made
inside it; the launches in all and a pitch step's share; the device's busy
time (the union of kernel, copy and memset intervals inside the call) and
idle share; the kernels with the most device time.  Launches are the
runtime's launch calls (cudaLaunchKernel and its kin) the trace records.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SR = 44100.0
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def wrap(module, name: str, label: str, undo: list) -> None:
    """module.name → the same function inside record_function(label)."""
    import torch
    fn = getattr(module, name)

    def traced(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, traced)
    undo.append((module, name, fn))


def stage_wrappers(analysis_api: bool) -> list:
    from audio_analyzer_rs_tpu_torch import analysis
    from audio_analyzer_rs_tpu_torch.models import analyzer, segmented
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, pitch, tracker
    undo: list = []
    wrap(segmented, "_upload_f32", "upload", undo)
    wrap(segmented, "_slice_streams", "slice streams", undo)
    wrap(analyzer, "windowed_mags", "stft (K1; K11 in the onset pass)",
         undo)
    wrap(noisefloor, "noise_floor_scan", "noise floor (K5)", undo)
    wrap(pitch, "extract_pitches", "extraction (K10)", undo)
    wrap(tracker, "tracker_scan_batched", "tracker (K3)", undo)
    if analysis_api:
        wrap(segmented, "segmented_onset_analysis", "onset pass", undo)
        wrap(segmented, "segmented_pitch_analysis", "pitch pass", undo)
        wrap(analysis, "windowed_mags", "feature chunks: spectrogram", undo)
        wrap(analysis, "feature_pack", "feature chunks: feature pack", undo)
        wrap(analysis, "yin_pitch", "feature chunks: YIN", undo)
    return undo


def summarize(prof, wall_s: float, steps: int) -> dict:
    from torch.autograd import DeviceType
    events = list(prof.events())
    call = [e for e in events if e.name == "traced call"][0]
    c0, c1 = call.time_range.start, call.time_range.end
    stages: dict = {}
    launches = []
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS:
            launches.append(e.time_range.start)
    for e in events:
        if e.device_type != DeviceType.CPU or e.name == "traced call":
            continue
        if e.name in STAGE_LABELS:
            st = stages.setdefault(e.name, {"host_ms": 0.0, "calls": 0,
                                            "launches": 0})
            st["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
            st["calls"] += 1
            st["launches"] += sum(e.time_range.start <= t <= e.time_range.end
                                  for t in launches)
    # Device work: kernels, copies and memsets (the record_function ranges
    # also appear on the device's timeline, as annotations: left out).
    work = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in STAGE_LABELS and e.name != "traced call"]
    spans = sorted((max(e.time_range.start, c0), min(e.time_range.end, c1))
                   for e in work
                   if e.time_range.end > c0 and e.time_range.start < c1)
    busy, cur0, cur1 = 0.0, None, None
    for a, b in spans:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
    by_kernel: dict = {}
    for e in work:
        k = by_kernel.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    traced_ms = (c1 - c0) / 1e3
    return {
        "host_wall_s": wall_s, "traced_ms": traced_ms,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / 1e3 / traced_ms,
        "launches": len(launches), "pitch_steps": steps,
        "launches_per_step": len(launches) / max(steps, 1),
        "device_kernels": sum(n for _, n in by_kernel.values()),
        "stages": {k: {**v, "host_ms": round(v["host_ms"], 3)}
                   for k, v in sorted(stages.items(),
                                      key=lambda kv: -kv[1]["host_ms"])},
        "top_device": [{"name": k[:90], "ms": round(v[0], 3), "count": v[1]}
                       for k, v in top],
    }


STAGE_LABELS = {
    "upload", "slice streams", "stft (K1; K11 in the onset pass)",
    "noise floor (K5)", "extraction (K10)", "tracker (K3)",
    "onset pass", "pitch pass", "feature chunks: spectrogram",
    "feature chunks: feature pack", "feature chunks: YIN",
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_paths: no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    from audio_analyzer_rs_tpu_torch import analysis
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.utils.framing import num_frames

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    audio = gen.mixed_scene(60.0 * args.minutes, SR, seed=0)
    n = num_frames(len(audio), 2048, 512)
    plan = segmented._plan_streams(n, segmented.auto_segments(n, 128), 128,
                                   64, 2048, 512)
    results = []
    for name, fn, api in (
            ("segmented_pitch_analysis",
             lambda: segmented.segmented_pitch_analysis(audio, SR), False),
            ("analyze_buffer_segmented",
             lambda: analysis.analyze_buffer_segmented(audio, SR), True)):
        fn()
        torch.cuda.synchronize()
        undo = stage_wrappers(api)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function("traced call"):
                    fn()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for module, attr, orig in reversed(undo):
                setattr(module, attr, orig)
        t0 = time.perf_counter()
        fn()
        untraced = time.perf_counter() - t0
        res = {"path": name, "card": card, "minutes": args.minutes,
               "untraced_wall_s": untraced,
               **summarize(prof, wall, plan.steps)}
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
