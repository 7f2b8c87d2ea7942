#!/usr/bin/env python3
"""The port's own spans (`audio_analyzer_rs_tpu_torch/spans.py`) on the
device trace's clock: which stage of the full step launched each kernel,
and which host code the card waited on.

    python3 benchmark/program_spans.py --workload chain48k.b128 --seed <n>

runs one cell as `run.py --trace 1` does (its inputs from the seed, the
warm-up, a device-only profile of the cell's `trace_seconds`, the
readers' context of `tracing.context`), with the program's spans on over
the window alone, and prints the card's name and power limit, then one
JSON line:

- `per_layer`: the cell's per-layer metrics as `run.py` reads them;
- `program_metrics`: the metrics the program's spans give (`METRICS`),
  and `host_ms`, the host ms a step in each span;
- `idle_gaps`: the breakdown's idle time split by span (the window's
  garbage collections among the harness's spans, as "gc"); `gc`, the
  window's collections, the full ones apart, and their ms;
- `own_stage`: for each hand kernel, the share of its time launched
  inside its own stage's span (the self-check that the spans and the
  trace share one clock), `unattributed_ms` a step, and `coverage`, the
  share of the window's kernel time launched inside any `full_step*`
  span.

It runs no check of the outputs.  Exits 3 without a CUDA device.  Once
`run.py` turns the program's spans on in its traced runs, `trace_cell`
and `main` go, and the rest moves into `tracing.py` and `readers.py`.

How the spans enter the context: the program's records and the
harness's spans, both taken by the host clock (perf_counter's,
CLOCK_MONOTONIC), are set on the trace's clock by the clocks themselves
(`realtime_shift`: the profiler stamps its CPU events in CLOCK_REALTIME,
and the offset between the two clocks is read once beside the mark), and
join `host` under their own names.  (`tracing.py` places the harness's
spans by the synchronize mark instead, which lies 0.08-0.15 ms late on
an H100's host.)  Each device operation's launch time is the host start
of the runtime call that shares its CUPTI correlation id
(`FunctionEvent.id` on both), and the operation belongs to the innermost
program span holding that time.  An idle gap is divided over the
innermost span, the harness's or the program's, that holds each part of
it, the gap moved first by the device's skew against the host in its
request (`device_skews`); a part outside every span is the harness's.
A span's host time leaves out the garbage collections inside it: they
are the process's, not the span's code.  The window and its operations
stay as `tracing.context` gives them.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import readers  # noqa: E402
import run  # noqa: E402
import tracing  # noqa: E402

STEP = "full_step"
# The name-pattern metric whose kernels each stage launches.
OWN_STAGE = {"chain.conditioning_ms": "full_step.conditioning",
             "chain.pitch_ms": "full_step.pitch",
             "chain.onset_ms": "full_step.onsets"}


def _events(prof):
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA,
             e.time_range.start / 1e6, e.time_range.end / 1e6, e.id)
            for e in prof.events()]


def _window(ctx) -> tuple[float, float]:
    reqs = [h for h in ctx["host"] if h[0] == "request"]
    return reqs[0][1], max(b for _, _, b in reqs)


def segments(spans) -> tuple[list[float], list]:
    """The elementary intervals between the spans' edges, each with the
    name of the innermost (shortest) span holding it, None where none
    does → (edges, names), names[i] the name of [edges[i], edges[i+1])."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    starts = sorted(spans, key=lambda s: s[1])
    active, names, j = [], [], 0
    for lo, hi in zip(edges, edges[1:]):
        while j < len(starts) and starts[j][1] <= lo:
            active.append(starts[j])
            j += 1
        active = [s for s in active if s[2] >= hi]
        names.append(min(active, key=lambda s: s[2] - s[1])[0]
                     if active else None)
    return edges, names


def name_at(seg, t: float):
    edges, names = seg
    i = bisect.bisect_right(edges, t) - 1
    return names[i] if 0 <= i < len(names) else None


def split(seg, a: float, b: float, into: dict) -> None:
    """Add [a, b] to `into`, each part under the innermost span holding
    it ("harness" outside every span)."""
    edges, names = seg
    covered = 0.0
    i = max(bisect.bisect_right(edges, a) - 1, 0)
    while i < len(names) and edges[i] < b:
        part = min(b, edges[i + 1]) - max(a, edges[i])
        if part > 0:
            name = names[i] or "harness"
            into[name] = into.get(name, 0.0) + part
            covered += part
        i += 1
    if b - a - covered > 0:
        into["harness"] = into.get("harness", 0.0) + (b - a - covered)


def realtime_shift(trace_start_ns: int, real_minus_mono_ns: int) -> float:
    """Host clock → trace clock by the clocks themselves: the profiler
    stamps its events in CLOCK_REALTIME ns less the trace's start, and
    `real_minus_mono_ns` is CLOCK_REALTIME less perf_counter's clock."""
    return (real_minus_mono_ns - trace_start_ns) / 1e9


def device_skews(launched, host) -> list[tuple[float, float]]:
    """How far the trace's device times lie early against its host times,
    request by request → [(the request's first device start, skew)], in
    seconds, sorted.  Each request starts on an idle device (the harness
    waits for the last one's results), so its first operation starts as
    soon as its launch call allows: the skew is what brings the request's
    least lag from launch to start to 0.  (On an H100's host the device
    times were seen to drift by up to 5 ms across a 4-s window.)"""
    starts = [a for n, a, _ in host if n == "request"]
    per: dict = {}
    for _, a, _, t, _ in launched:
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0:
            first, lag = per.get(k, (a, a - t))
            per[k] = (min(first, a), min(lag, a - t))
    return sorted((first, -lag) for first, lag in per.values())


def extend(ctx: dict, events, shift: float, records, harness) -> dict:
    """A copy of the readers' context with the program's spans added, the
    harness's (`harness`, (name, start, end) by the host clock) and the
    program's set on the trace's clock by `shift`: `host` holds both,
    each under its own name, `program` the program's alone, `launched`
    is `ops` with each operation's launch time and launching span,
    (name, start, end, launch, span), launch and span None where no
    runtime call or no program span matched, `idle_by_span` the idle
    time split by span, and `device_skews` what the device's times were
    moved by to split it (`device_skews`).  The window and its operations stay as `ctx` has
    them, so every key the accepted readers read keeps its value."""
    def place(spans):
        return [(n, a + shift, b + shift) for n, a, b in spans]

    program = sorted(place((r.name, r.start_ns / 1e9, r.end_ns / 1e9)
                           for r in records))
    w0, w1 = _window(ctx)
    dev_ids = {i for _, dev, _, _, i in events if dev}
    launch: dict = {}
    for _, dev, a, _, i in events:
        if not dev and i in dev_ids:
            launch[i] = min(a, launch.get(i, a))
    prog_seg = segments(program)
    launched = []
    for name, dev, a, b, i in events:
        if dev and b > w0 and a < w1:
            t = launch.get(i)
            launched.append((name, max(a, w0), min(b, w1), t,
                             None if t is None else name_at(prog_seg, t)))
    host = sorted(place(harness) + program)
    all_seg = segments(host)
    skews = device_skews(launched, host)
    at = [d for d, _ in skews]
    idle: dict = {}
    reach = w0
    for a, b in sorted((a, b) for _, a, b, _, _ in launched) + [(w1, w1)]:
        if a > reach:
            k = max(bisect.bisect_right(at, reach) - 1, 0)
            skew = skews[k][1] if skews else 0.0
            split(all_seg, reach + skew, a + skew, idle)
        reach = max(reach, b)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(ctx, host=host, program=program, launched=launched,
                idle_by_span=idle, device_skews=skews,
                breakdown=dict(ctx["breakdown"], idle_gaps=[
                    ["idle, host in " + n, s] for n, s in top]))


def _per_step(ctx, seconds: list[float]) -> float | None:
    if not seconds or not ctx.get("program") or not ctx["requests"]:
        return None
    return sum(seconds) * 1e3 / ctx["requests"]


def launched_ms(ctx, span: str) -> float | None:
    """Device ms a request of the kernels launched inside the program span
    `span` (the innermost holding their launch)."""
    return _per_step(ctx, [b - a for name, a, b, _, by in ctx["launched"]
                           if by == span
                           and not name.startswith(readers.NON_KERNELS)])


def idle_ms(ctx, prefix: str) -> float | None:
    """Device-idle ms a request while the host was inside a program span
    named `prefix` or `prefix.*`."""
    return _per_step(ctx, [s for n, s in ctx["idle_by_span"].items()
                           if n == prefix or n.startswith(prefix + ".")])


def _less_gc(a: float, b: float, pauses) -> float:
    """The length of [a, b] less its overlap with the `pauses` [(start,
    end)]."""
    return b - a - sum(max(0.0, min(b, d) - max(a, c)) for c, d in pauses)


def step_host_ms(ctx) -> float | None:
    """Host ms a request inside the program's step span, less the garbage
    collections inside it."""
    if not ctx.get("program") or not ctx["requests"]:
        return None
    pauses = [(a, b) for n, a, b in ctx["host"] if n == "gc"]
    return sum(_less_gc(a, b, pauses) for n, a, b in ctx["host"]
               if n == STEP) * 1e3 / ctx["requests"]


METRICS = {
    "chain.step_host_ms": (step_host_ms, {}),
    "chain.step_idle_ms": (idle_ms, {"prefix": STEP}),
    "chain.conditioning_launched_ms": (launched_ms,
                                       {"span": "full_step.conditioning"}),
    "chain.pitch_launched_ms": (launched_ms, {"span": "full_step.pitch"}),
    "chain.onset_launched_ms": (launched_ms, {"span": "full_step.onsets"}),
}


def self_check(ctx) -> dict:
    """Each hand kernel's share of its time launched inside its own stage,
    the kernel time a request launched outside every program span, and
    the share of the window's kernel time launched inside the step."""
    kernels = [(n, b - a, by) for n, a, b, _, by in ctx["launched"]
               if not n.startswith(readers.NON_KERNELS)]
    own = {}
    for metric, stage in OWN_STAGE.items():
        args = json.loads((HERE / "metrics" / f"{metric}.json").read_text())
        for p in args["patterns"]:
            rx = re.compile(p)
            hit = [(d, by) for n, d, by in kernels if rx.search(n)]
            total = sum(d for d, _ in hit)
            own[p] = (100.0 * (sum(d for d, by in hit if by == stage)
                               / total) if total else None)
    total = sum(d for _, d, _ in kernels)
    inside = sum(d for _, d, by in kernels
                 if by is not None and by.startswith(STEP))
    outside = [d for _, d, by in kernels if by is None]
    return {"own_stage": own,
            "unattributed_ms": sum(outside) * 1e3 / max(ctx["requests"], 1),
            "coverage": 100.0 * inside / total if total else None}


def host_ms(records, requests: int, pauses) -> dict:
    """Host ms a request in each program span, and in the step's own code
    (its span less its children's) under "full_step.self", less the
    garbage collections `pauses` [(start, end)] (s, the host clock)."""
    def ms(r):
        return _less_gc(r.start_ns / 1e9, r.end_ns / 1e9, pauses) * 1e3

    out: dict = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + ms(r)
    if STEP in out:
        out[STEP + ".self"] = out[STEP] - sum(ms(r) for r in records
                                              if r.parent == STEP)
    return {k: v / max(requests, 1) for k, v in sorted(out.items())}


def gc_spans(into: list):
    """A `gc.callbacks` entry that adds each garbage collection to `into`
    as a host span ("gc", start, end) by the host clock, and its
    generation to its own `generations`."""
    def collect(phase, info):
        if phase == "start":
            collect.t0 = time.perf_counter()
        else:
            into.append(("gc", collect.t0, time.perf_counter()))
            collect.generations.append(info["generation"])
    collect.generations = []
    return collect


def trace_cell(cell_name: str, seed: int) -> dict:
    spec = run.resolve(cell_name)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_analyzer_rs_tpu_torch import spans as program
    if not torch.cuda.is_available():
        raise SystemExit(3)
    workload = spec["workload"]
    driver = run.load_module(spec["driver"], "driver_" + workload["driver"])
    harness = run.Spans()
    cell = driver.Cell(workload, spec["config"], seed, "cuda", harness)
    cell.warm()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    harness.mark = time.perf_counter()
    real_minus_mono_ns = time.time_ns() - time.perf_counter_ns()
    torch.cuda.synchronize()
    harness.done.clear()
    pauses: list = []
    collect = gc_spans(pauses)
    gc.callbacks.append(collect)
    program.drain()
    program.enable()
    try:
        run.run_window(cell, workload["trace_seconds"], harness,
                       cell.min_requests())
        torch.cuda.synchronize()
    finally:
        program.disable()
        gc.callbacks.remove(collect)
    prof.__exit__(None, None, None)
    records = program.drain()
    ctx = tracing.context(prof, harness, cell)
    shift = realtime_shift(prof.profiler.kineto_results.trace_start_ns(),
                           real_minus_mono_ns)
    ext = extend(ctx, _events(prof), shift, records, harness.done + pauses)
    full = [p for p, g in zip(pauses, collect.generations) if g == 2]
    out = {
        "cell": cell_name, "seed": seed, "requests": ctx["requests"],
        "window_s": ctx["window_s"], "busy_s": ctx["busy_s"],
        "program_spans": len(records),
        "launch_matched": sum(op[3] is not None for op in ext["launched"]),
        "device_ops": len(ext["launched"]),
        "per_layer": run.per_layer(spec["per_layer"], ctx, HERE / "metrics"),
        "program_metrics": {name: fn(ext, **args)
                            for name, (fn, args) in METRICS.items()},
        "host_ms": host_ms(records, ctx["requests"],
                           [(a, b) for _, a, b in pauses]),
        "idle_gaps": ext["breakdown"]["idle_gaps"],
        **self_check(ext),
        "gc": {"collections": len(pauses), "full": len(full),
               "ms": sum(b - a for _, a, b in pauses) * 1e3,
               "full_ms": sum(b - a for _, a, b in full) * 1e3},
    }
    cell.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.fixed_caches(run.ROOT)
    try:
        result = trace_cell(args.workload, args.seed)
    except run.Usage as e:
        print(f"program_spans: {e}", file=sys.stderr)
        return 2
    print(f"card: {run.card_limit()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
