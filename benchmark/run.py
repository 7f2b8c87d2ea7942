#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, run once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file, `benchmark/workloads/<cell>.json`, names its
configuration (`benchmark/configs/<config>.json`), the module that drives
the entry it times (`benchmark/drivers/<entry>.py`) and the limits of its
output check.  A run makes its inputs on the card from the seed, builds
and warms the program on this cell's shapes alone (set-up), then sends
one request after another for `--seconds` (closed loop: the next request
follows the last one's results on the host).  With `--trace 0` it
reports the cell's end-to-end metrics, timed by the host clock; with
`--trace 1` it runs the window under torch.profiler and reports the
cell's per-layer metrics, each read by `benchmark/metrics/<metric>.py` or
`.json`.  Once the window has closed, that module holds a sample of what
the timed path produced against the plain reference in
`benchmark/reference/`.  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, end standard error
and the result line.

Exits 3 without enough CUDA devices, 4 if JAX or the JAX package was
loaded, 2 on a bad argument or a missing file.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Compared by whole top-level module name: the port's package name
# begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_analyzer_rs_tpu")


class Usage(Exception):
    """A bad argument or a missing file of the benchmark."""


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Usage(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Usage(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(cell_name: str, root: Path = ROOT) -> dict:
    """The manifest's entries and files for one cell, found by name."""
    manifest = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise Usage(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[cell["config"]]
    workload = read_json(root / "benchmark" / "workloads"
                         / f"{cell_name}.json")
    config = read_json(root / entry["file"])
    if workload.get("config") != cell["config"]:
        raise Usage(f"{cell_name}: its file names config "
                    f"{workload.get('config')!r}, BENCHMARK.json "
                    f"{cell['config']!r}")
    driver = root / "benchmark" / "drivers" / f"{workload['driver']}.py"
    end_to_end = [m for m in manifest["end_to_end"]
                  if cell_name in m.get("workloads", [cell_name])]
    per_layer = [m for m in manifest["per_layer"]
                 if cell_name in m.get("workloads", [cell_name])]
    return dict(manifest=manifest, cell=cell, workload=workload,
                config=config, driver=driver, end_to_end=end_to_end,
                per_layer=per_layer, root=root)


def fixed_caches(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout, before
    torch is imported (the program's own nvcc build goes to its package's
    `_build/`, also inside the checkout)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(root / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Spans:
    """Host spans around the harness's calls into the program, by the
    host clock, kept in memory.  `mark` is the host time of the
    synchronize that starts a traced window."""

    def __init__(self):
        self.done: list[tuple[str, float, float]] = []
        self.mark = None

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.owner.done.append((self.name, self.t0, time.perf_counter()))
        return False


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default), over every value."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(spec: list[dict], workload: dict, latencies_s: list[float],
               window_s: float, audio_s: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics, as its workload file maps them:
    "setup" (process start to the first timed request), "rate" (seconds of
    audio of every request completed in the window over the window's wall
    seconds) and "p95" (the 95th percentile of every request's latency)."""
    kinds = workload["end_to_end"]
    out = {}
    for m in spec:
        kind = "setup" if m["name"] == "setup_s" else kinds[m["name"]]
        if kind == "setup":
            v = setup_s
        elif kind == "rate":
            v = audio_s * len(latencies_s) / window_s
        elif kind == "p95":
            v = percentile(latencies_s, 95.0) * 1e3
        else:
            raise Usage(f"unknown end-to-end kind {kind!r}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def card_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def run_window(cell, seconds: float, spans: Spans, min_requests: int):
    """Requests back to back until `seconds` have passed and at least
    `min_requests` have completed → (latencies in s, window s).  The
    cell's `after` hook, outside each request's time, keeps what its
    check needs."""
    latencies = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        if time.perf_counter() >= deadline and i >= min_requests:
            break
        a = time.perf_counter()
        with spans("request"):
            cell.request()
        latencies.append(time.perf_counter() - a)
        cell.after()
        i += 1
    return latencies, time.perf_counter() - t0


def per_layer(spec: list[dict], ctx: dict, metrics_dir: Path) -> dict:
    """Each per-layer metric read by its own file: `<name>.py` (its
    `read(ctx)`) or `<name>.json` (a reader of benchmark/readers.py and
    its arguments).  A reader that finds nothing returns None, and the
    metric is left out."""
    import readers
    out = {}
    for m in spec:
        py, js = (metrics_dir / f"{m['name']}.py",
                  metrics_dir / f"{m['name']}.json")
        if py.is_file():
            value = load_module(py, "metric_" + m["name"].replace(".", "_")
                                ).read(ctx)
        elif js.is_file():
            args = json.loads(js.read_text())
            value = getattr(readers, args.pop("reader"))(ctx, **args)
        else:
            raise Usage(f"no reader for per-layer metric {m['name']}")
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             control: str | None = None):
    """One run of one cell → the result line's dict, with every number
    the check read under "readings" (last).  `device` and `control` are
    for the benchmark's own tests and calibration: a run always uses
    "cuda" and the program."""
    spec = resolve(cell_name, root)
    for p in (str(HERE), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    chips = spec["cell"]["chips"]
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(3)
    workload = spec["workload"]
    driver = load_module(spec["driver"], "driver_" + workload["driver"])
    profiled = bool(trace) and device == "cuda"
    spans = Spans()
    cell = driver.Cell(workload, spec["config"], seed, device, spans)
    cell.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    window = min(seconds, workload.get("trace_seconds", seconds)) \
        if trace else seconds
    prof = None
    if profiled:
        # The device's activity alone: recording every host op as well
        # slowed a 128-stream step by ~2 ms.  The host spans come from
        # the harness's clock, set on the trace's by one synchronize.
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        spans.mark = time.perf_counter()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    spans.done.clear()
    latencies, window_s = run_window(cell, window, spans,
                                     cell.min_requests())
    if device == "cuda":
        torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    dev = device_info(chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"attempted": len(latencies), "failed": 0}
    if profiled:
        import tracing
        ctx = tracing.context(prof, spans, cell)
        result["metrics"] = per_layer(spec["per_layer"], ctx,
                                      HERE / "metrics")
        dev["busy_s"], dev["window_s"] = ctx["busy_s"], ctx["window_s"]
        result["breakdown"] = ctx["breakdown"]
        del prof, ctx
    elif trace:
        result["metrics"] = {}
    else:
        result["metrics"] = end_to_end(spec["end_to_end"], workload,
                                       latencies, window_s,
                                       cell.audio_seconds(), setup_s)
    result["device"] = dev
    cell.release()
    t_check = time.perf_counter()
    readings = cell.check(control)
    readings["check_s"] = time.perf_counter() - t_check
    limits = workload["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    result["readings"] = readings
    return {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device", *(
                                       ["breakdown"] if profiled else []),
                                   "checks", "readings")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(ROOT)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Usage as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except SystemExit as e:
        if e.code == 3:
            print("benchmark: this cell needs CUDA devices that this "
                  "machine does not have", file=sys.stderr)
        raise
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"card: {card_limit()}", file=sys.stderr)
    for name, v in sorted(result.pop("readings").items()):
        print(f"reading {name}: {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
