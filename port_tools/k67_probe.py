#!/usr/bin/env python3
"""Measure the full chain's two scan kernels, K6 (the reducer scan,
csrc/reducer.cu) and K7 (the AGC scan, csrc/dynamics.cu), on one GPU.

    python3 port_tools/k67_probe.py turns [--parent DIR] [--variants]
    python3 port_tools/k67_probe.py split --version barrier|mbarrier
                                          [--source PATH]
                                          [--sass OUT.sass]
    python3 port_tools/k67_probe.py chain

`turns`: the parent's K6 and K7 (DIR holds its reducer.cu and dynamics.cu,
e.g. unpacked by `git archive <rev> audio_analyzer_rs_tpu_torch/csrc | tar
-x -C _proof/parent`) against the package's, each source built alone by nvcc
(sm_90a, the port's flags) and called through its C entry, at the full
step's shapes: K6 over [128, 479,232] samples (windows of a 120 s
`mixed_scene`, one stream digital silence, one with a NaN sample), K7 over
K6's output as [128, 468, 1,024] slots, from fresh and from session states.
The two versions' outputs are held bit for bit to each other (each is held
to its plain version by the card tests), also at edge shapes; then they are
timed in turns (parent, package, package, parent), each turn the median of
5 samples of 10 launches queued behind a ~2 ms spin of the card (the card's
time, not the host's), with nvidia-smi's SM clock sampled during the turn.
K7's phases: probe copies of the package's dynamics.cu whose entry launches
(A) alone, or (A) and (B) ("exact"; "hist" runs (B) and (C) in one kernel).
`--variants` also times, in turns with the package's, K6 with 8 streams a
block (128-sample tiles), 16 and 32 with 64-sample tiles, and with the
passes' chunk loops unrolled (every variant bit for bit to the package's).

`split`: a probe copy of K6 with clock64 stamps in block 0 (lane 0 of each
warp, every tile), built on its own beside the unstamped source, run at
[128, 479,232] (random audio): the two timed in turns (the stamps' cost),
then per warp the median cycles a tile waiting and working.  `--version
barrier` fits the earlier design (three warps, 32-sample tiles, a block
barrier a tile: the producer's cp.async issue and wait, each stage's row,
the gate warp's row stores, the barrier wait), `--version mbarrier` the
warp-specialised one (each warp's mbarrier waits and its pass; the
producer's stores and load issue).  `--sass` writes cuobjdump's SASS of
the unmodified source.

`chain`: the dependent latency of each K6 stage's carried recurrence alone
(one warp, in registers, 65,536 samples: the biquad's two feedback FMAs;
the envelope's compare, blend and select; the hold's count), and K7's
"hist" chain a slot (a probe copy of dynamics.cu stamping clock64 at each
slot of block 0's chain warp, at B = 1 and 128, fresh and session states).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from audio_analyzer_rs_tpu_torch import _build  # noqa: E402
from audio_analyzer_rs_tpu_torch.models import generators as gen  # noqa: E402
from audio_analyzer_rs_tpu_torch.ops import dynamics, reducer  # noqa: E402

OUT = REPO / "_proof" / "k67_probe"
CSRC = REPO / "audio_analyzer_rs_tpu_torch" / "csrc"
SR = 48000.0
B, S = 128, 468
T = S * 1024
SPIN = 4_000_000            # ~2 ms of card time: the host queues ahead


def build(named_sources: dict) -> dict:
    """{label: source text} -> {label: library path}, one nvcc each, in
    parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, text in named_sources.items():
        src = OUT / f"{label}.cu"
        src.write_text(text)
        jobs[label] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(OUT / f"{label}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for label, job in jobs.items():
        _, err = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc {label}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"built {label}: {regs}", flush=True)
        out[label] = OUT / f"{label}.so"
    return out


def entry(path: Path, name: str):
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


class Clock:
    """nvidia-smi's SM clock sampled every 20 ms while a block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        v = [float(w) for w in out.split() if w.strip().isdigit()]
        self.mhz = statistics.median(v) if v else float("nan")
        return False


def card_ms(fn, samples: int = 5, reps: int = 10) -> list:
    """Card ms a call: `samples` samples of `reps` calls queued behind a
    spin, each bracketed by one pair of CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        torch.cuda._sleep(SPIN)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return out


def same(a, b) -> bool:
    if a.dtype == torch.float32:
        an, bn = torch.isnan(a), torch.isnan(b)
        return torch.equal(an, bn) and torch.equal(
            torch.where(an, 0, a.view(torch.int32)),
            torch.where(bn, 0, b.view(torch.int32)))
    return torch.equal(a, b)


def session_state(b: int, seed: int):
    """A DynamicsState as a long session leaves it (chip_smoke.py's)."""
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
    return dynamics.DynamicsState(*(t.cuda() for t in leaves))


class K6:
    """Calls of a K6 library on fresh states (a carried hold of 300)."""

    def __init__(self, fn):
        self.fn = fn
        self.hp = reducer.biquad_coeffs(reducer.HPF_FREQ, SR, False)
        self.lp = reducer.biquad_coeffs(reducer.LPF_FREQ, SR, True)
        self.gate = reducer.gate_params(SR)

    def __call__(self, x, gate_only: int):
        b = x.shape[0]
        st = torch.zeros((b, 9), device=x.device)
        hold = torch.full((b,), 300, dtype=torch.int32, device=x.device)
        y, st1, hold1 = (torch.empty_like(x), torch.empty_like(st),
                         torch.empty_like(hold))
        code = self.fn(x.data_ptr(), y.data_ptr(), st.data_ptr(),
                       hold.data_ptr(), st1.data_ptr(), hold1.data_ptr(), b,
                       x.shape[1], gate_only,
                       *(float(c) for c in (*self.hp, *self.lp)),
                       *self.gate, stream())
        assert code == 0, code
        return y, st1, hold1


class K7:
    """Calls of a K7 library."""

    def __init__(self, fn):
        self.fn = fn
        self.alphas = dynamics.smoothing_alphas(SR, 1024)

    def __call__(self, st, slots, mode: str):
        b, s, length = slots.shape
        dev = slots.device
        gained = torch.empty_like(slots)
        outs = dynamics.DynamicsOut(
            torch.empty((b, s), dtype=torch.int32, device=dev),
            *(torch.empty((b, s), device=dev) for _ in range(5)))
        new = dynamics.DynamicsState(*(torch.empty_like(t) for t in st))
        code = self.fn(slots.data_ptr(), *(t.data_ptr() for t in st),
                       *(t.data_ptr() for t in outs), gained.data_ptr(),
                       *(t.data_ptr() for t in new), b, s, length,
                       int(mode == "exact"), float(np.float32(1.0 / length)),
                       *self.alphas, stream())
        assert code == 0, code
        return [*outs, gained, *new]


def in_turns(label: str, fns: dict) -> None:
    """fns {"parent": f, "package": f}: turns parent, package, package,
    parent, each the median of card_ms."""
    ts = {k: [] for k in fns}
    for who in ("parent", "package", "package", "parent"):
        with Clock() as clock:
            t = card_ms(fns[who])
        ts[who] += t
        print(f"  turn {who}: {statistics.median(t):.4f} ms (SM "
              f"{clock.mhz:.0f} MHz)", flush=True)
    print(f"{label}: parent {statistics.median(ts['parent']):.4f} ms, "
          f"package {statistics.median(ts['package']):.4f} ms", flush=True)


def fleet():
    scene = gen.mixed_scene(120.0, SR, seed=0)
    x = np.stack([scene[k * 15000:k * 15000 + T] for k in range(B)])
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    x[1] = 0.0
    x[2, T // 3] = float("nan")
    return x


def turns(args) -> None:
    parent = Path(args.parent)
    text = {"parent_reducer": (parent / "reducer.cu").read_text(),
            "package_reducer": (CSRC / "reducer.cu").read_text(),
            "parent_dynamics": (parent / "dynamics.cu").read_text(),
            "package_dynamics": (CSRC / "dynamics.cu").read_text()}
    dyn = text["package_dynamics"]
    end = dyn.index("  return static_cast<int>(cudaGetLastError());\n}\n\n}"
                    "  // extern")
    cut_bc = dyn[dyn.index("  if (exact) {\n"):end]
    cut_c = dyn[dyn.index("    dynamics_gain_kernel<<<"):
                dyn.index("  } else {\n    dynamics_hist_kernel<<<")]
    text["phase_a"] = dyn.replace(cut_bc, "")
    text["phase_ab"] = dyn.replace(cut_c, "")
    red = text["package_reducer"]
    variants = {}
    if args.variants:
        for rows, tile in ((8, 128), (16, 64), (32, 64)):
            variants[f"{rows} streams a block, {tile}-sample tiles"] = (
                red.replace("constexpr int ROWS = 16;",
                            f"constexpr int ROWS = {rows};")
                .replace("constexpr int TILE = 128;",
                         f"constexpr int TILE = {tile};"))
        variants["the passes' chunk loops unrolled (a 128-sample body a "
                 "warp)"] = red.replace("#pragma unroll 1\n",
                                        "#pragma unroll\n")
        for n, (label, v) in enumerate(variants.items()):
            assert v != red, label
            text[f"k6_variant{n}"] = v
    libs = build(text)
    print("card:", card(), flush=True)
    k6 = {w: K6(entry(libs[f"{w}_reducer"], "aat_reducer_scan"))
          for w in ("parent", "package")}
    x = fleet()
    for gate_only in (0, 1):
        a, b = k6["parent"](x, gate_only), k6["package"](x, gate_only)
        torch.cuda.synchronize()
        print(f"K6 gate_only={gate_only}: package == parent bit for bit: "
              f"{all(same(u, v) for u, v in zip(a, b))}", flush=True)
        in_turns(f"K6 gate_only={gate_only} [{B}, {T}]",
                 {w: (lambda w=w: k6[w](x, gate_only)) for w in k6})
    for b, t in ((1, 40), (3, 61), (33, 1001), (129, 700), (5, 130),
                 (2, 64), (7, 4)):
        xe = torch.cat([x, x])[:b, :t].contiguous()
        for gate_only in (0, 1):
            a, c = k6["parent"](xe, gate_only), k6["package"](xe, gate_only)
            assert all(same(u, v) for u, v in zip(a, c)), (b, t, gate_only)
    print("K6 edge shapes: package == parent bit for bit", flush=True)
    if variants:
        ref = k6["package"](x, 0)
        for n, label in enumerate(variants):
            f = K6(entry(libs[f"k6_variant{n}"], "aat_reducer_scan"))
            assert all(same(u, v) for u, v in zip(f(x, 0), ref)), label
            ms = [statistics.median(card_ms(lambda: g(x, 0))) for g in
                  (k6["package"], f, f, k6["package"])]
            print(f"K6 {label}: {ms[1]:.4f}, {ms[2]:.4f} ms against the "
                  f"package's {ms[0]:.4f}, {ms[3]:.4f} in turns", flush=True)

    slots = k6["package"](x, 0)[0].reshape(B, S, 1024)
    k7 = {w: K7(entry(libs[f"{w}_dynamics"], "aat_dynamics_scan"))
          for w in ("parent", "package")}
    states = {"fresh": dynamics.init_state("cuda", (B,)),
              "session": session_state(B, 5)}
    for mode in ("hist", "exact"):
        for label, st in states.items():
            a, b = k7["parent"](st, slots, mode), k7["package"](st, slots,
                                                                mode)
            torch.cuda.synchronize()
            print(f"K7 {mode} {label}: package == parent bit for bit: "
                  f"{all(same(u, v) for u, v in zip(a, b))}", flush=True)
        in_turns(f"K7 {mode} [{B}, {S}, 1024]",
                 {w: (lambda w=w: k7[w](states["fresh"], slots, mode))
                  for w in k7})
    flat = slots.reshape(B, -1)
    for b, s, length in ((1, 1, 1024), (129, 7, 1024), (5, 9, 480),
                         (3, 4, 1), (2, 33, 1000)):
        sl = torch.cat([flat, flat])[:b, :s * length].reshape(
            b, s, length).contiguous()
        for mode in ("hist", "exact"):
            st = session_state(b, 7)
            a, c = k7["parent"](st, sl, mode), k7["package"](st, sl, mode)
            assert all(same(u, v) for u, v in zip(a, c)), (b, s, length)
    print("K7 edge shapes: package == parent bit for bit", flush=True)
    phase = {w: K7(entry(libs[w], "aat_dynamics_scan"))
             for w in ("phase_a", "phase_ab")}
    for mode in ("hist", "exact"):
        ms = {w: statistics.median(card_ms(
            lambda f=f: f(states["fresh"], slots, mode)))
            for w, f in (*phase.items(), ("all", k7["package"]))}
        if mode == "hist":
            print(f"K7 hist phases: (A) {ms['phase_a']:.4f} ms, (B) with "
                  f"(C) {ms['all'] - ms['phase_a']:.4f} ms, all "
                  f"{ms['all']:.4f} ms", flush=True)
        else:
            print(f"K7 exact phases: (A) {ms['phase_a']:.4f} ms, (B) "
                  f"{ms['phase_ab'] - ms['phase_a']:.4f} ms, (C) "
                  f"{ms['all'] - ms['phase_ab']:.4f} ms, all "
                  f"{ms['all']:.4f} ms", flush=True)


# ── split ────────────────────────────────────────────────────────────────

def _stamp(roles: int, maxk: int) -> str:
    return (f"__device__ long long g_rec[{roles} * {maxk} * 5];\n"
            "__device__ __forceinline__ long long stamp() { long long t; "
            "asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: "
            "\"memory\"); return t; }\n"
            "__device__ __forceinline__ void rec(int w, int k, int j, "
            "long long t) { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 "
            f"&& k < {maxk}) g_rec[((long long)w * {maxk} + k) * 5 + j] = "
            "t; }\n")


COPY_OUT = ("extern \"C\" {\n", "extern \"C\" {\nint probe_copy(long long* "
            "h) { return (int)cudaMemcpyFromSymbol(h, g_rec, "
            "sizeof(g_rec)); }\n")

# The block-barrier design: stage = warp (0 HPF + cp.async, 1 LPF, 2 gate
# + stores).
BARRIER_EDITS = [
    ("    const int tk = k - stage;              // the tile this stage "
     "runs\n",
     "    const int tk = k - stage;              // the tile this stage "
     "runs\n    long long q0 = stamp(), q1 = q0, q2 = q0, q3 = q0;\n"),
    ("        copy_wait();\n        __syncwarp();\n      }\n",
     "        copy_wait();\n        __syncwarp();\n      }\n"
     "      q1 = stamp();\n"),
    ("      if (stage == 2) {\n        __syncwarp();\n",
     "      q2 = stamp();\n      if (stage == 2) {\n        __syncwarp();\n"),
    ("      }\n    }\n    __syncthreads();\n  }\n",
     "      }\n      q3 = stamp();\n    }\n    __syncthreads();\n"
     "    rec(stage, k, 0, q0); rec(stage, k, 1, q1); rec(stage, k, 2, q2);"
     " rec(stage, k, 3, q3); rec(stage, k, 4, stamp());\n  }\n"),
]
BARRIER_PARTS = {0: ("HPF + loads", ("cp.async issue+wait", 0, 1),
                 ("row", 1, 2), ("barrier wait", 3, 4)),
             1: ("LPF", ("before", 0, 1), ("row", 1, 2),
                 ("barrier wait", 3, 4)),
             2: ("gate + stores", ("before", 0, 1), ("row", 1, 2),
                 ("row stores", 2, 3), ("barrier wait", 3, 4))}

# The warp-specialised kernel: stamps around each warp's waits and pass.
MBARRIER_EDITS = [
    ("    for (int k = 0; k < tiles; ++k) {\n      // Store what is gated, "
     "then free the slot of tile k - NSLOTS.\n",
     "    for (int k = 0; k < tiles; ++k) {\n      rec(LOAD_WARP, k, 0, "
     "stamp());\n      // Store what is gated, then free the slot of tile "
     "k - NSLOTS.\n"),
    ("      __syncwarp();\n      const int i = k % NSLOTS;\n",
     "      __syncwarp();\n      rec(LOAD_WARP, k, 1, stamp());\n"
     "      const int i = k % NSLOTS;\n"),
    ("        bar_arrive(&sh.full[i]);\n      }\n    }\n",
     "        bar_arrive(&sh.full[i]);\n      }\n      rec(LOAD_WARP, k, 2, "
     "stamp());\n    }\n"),
    ("      bar_wait(&wait_on[i], (k / NSLOTS) & 1);\n",
     "      rec(warp, k, 0, stamp());\n      bar_wait(&wait_on[i], "
     "(k / NSLOTS) & 1);\n      rec(warp, k, 1, stamp());\n"),
    ("      bar_arrive(&done[i]);\n",
     "      bar_arrive(&done[i]);\n      rec(warp, k, 2, stamp());\n"),
    ("      bar_wait(&sh.lpf_done[i], (k / NSLOTS) & 1);\n      bar_wait("
     "&sh.env_empty[g], ((k / NGATE) & 1) ^ 1);\n",
     "      rec(ENV_WARP, k, 0, stamp());\n      bar_wait(&sh.lpf_done[i], "
     "(k / NSLOTS) & 1);\n      bar_wait(&sh.env_empty[g], ((k / NGATE) & "
     "1) ^ 1);\n      rec(ENV_WARP, k, 1, stamp());\n"),
    ("      bar_arrive(&sh.env_full[g]);\n",
     "      bar_arrive(&sh.env_full[g]);\n      rec(ENV_WARP, k, 2, "
     "stamp());\n"),
    ("      bar_wait(&sh.env_full[g], (k / NGATE) & 1);\n      const int n",
     "      rec(LOW_WARP, k, 0, stamp());\n      bar_wait(&sh.env_full[g], "
     "(k / NGATE) & 1);\n      rec(LOW_WARP, k, 1, stamp());\n"
     "      const int n"),
    ("      bar_arrive(&sh.low_full[g]);\n",
     "      bar_arrive(&sh.low_full[g]);\n      rec(LOW_WARP, k, 2, "
     "stamp());\n"),
    ("      bar_wait(&sh.low_full[g], (k / NGATE) & 1);\n",
     "      rec(HOLD_WARP, k, 0, stamp());\n      bar_wait(&sh.low_full[g], "
     "(k / NGATE) & 1);\n"),
    ("      const int n = min(TILE, T - k * TILE);\n      lim = max(lim - z, "
     "-1);\n",
     "      rec(HOLD_WARP, k, 1, stamp());\n      const int n = min(TILE, T "
     "- k * TILE);\n      lim = max(lim - z, -1);\n"),
    ("      bar_arrive(&sh.env_empty[g]);\n",
     "      bar_arrive(&sh.env_empty[g]);\n      rec(HOLD_WARP, k, 2, "
     "stamp());\n"),
    ("      bar_arrive(&sh.gated[i]);\n",
     "      bar_arrive(&sh.gated[i]);\n      rec(HOLD_WARP, k, 3, "
     "stamp());\n"),
]
MBARRIER_PARTS = {0: ("HPF", ("wait", 0, 1), ("pass", 1, 2)),
             1: ("LPF", ("wait", 0, 1), ("pass", 1, 2)),
             2: ("hold", ("wait", 0, 1), ("pass", 1, 2),
                 ("fence + release", 2, 3)),
             3: ("envelope", ("wait", 0, 1), ("pass", 1, 2)),
             4: ("producer", ("stores + slot release", 0, 1),
                 ("load issue", 1, 2)),
             5: ("low", ("wait", 0, 1), ("pass", 1, 2))}


def probe_source(src: str, version: str) -> str:
    edits, roles = ((BARRIER_EDITS, 3) if version == "barrier"
                    else (MBARRIER_EDITS, 6))
    for a, b in [("namespace {\n", "namespace {\n" + _stamp(roles, 16384)),
                 *edits, COPY_OUT]:
        if src.count(a) != 1:
            raise SystemExit(f"the probe does not fit the source: {a!r}")
        src = src.replace(a, b)
    return src


def split(args) -> None:
    source = Path(args.source) if args.source else CSRC / "reducer.cu"
    text = source.read_text()
    lib = build({f"split_{args.version}": probe_source(text, args.version),
                 "split_asis": text})
    if args.sass:
        cubin = OUT / "asis.cubin"
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-o", str(cubin), str(source)], check=True)
        sass = subprocess.run(["cuobjdump", "--dump-sass", str(cubin)],
                              capture_output=True, text=True).stdout
        Path(args.sass).write_text(sass)
        print(f"SASS: {len(sass.splitlines())} lines in {args.sass}")
    probe = entry(lib[f"split_{args.version}"], "aat_reducer_scan")
    asis = entry(lib["split_asis"], "aat_reducer_scan")
    print("card:", card(), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn(B, T, device="cuda", generator=g) * 0.1
    roles, parts = ((3, BARRIER_PARTS) if args.version == "barrier"
                    else (6, MBARRIER_PARTS))
    tile = 32 if args.version == "barrier" else 128
    for gate_only in (0, 1):
        for label, fn in (("unstamped", asis), ("probe", probe),
                          ("probe", probe), ("unstamped", asis)):
            f = K6(fn)
            ms = statistics.median(card_ms(lambda: f(x, gate_only), 3, 3))
            print(f"gate_only={gate_only} {label}: {ms:.3f} ms", flush=True)
        rec = np.zeros(roles * 16384 * 5, np.int64)
        lib_probe = ctypes.CDLL(str(lib[f"split_{args.version}"]))
        assert lib_probe.probe_copy(rec.ctypes.data_as(ctypes.c_void_p)) == 0
        rec = rec.reshape(roles, 16384, 5)
        n = min((T + tile - 1) // tile, 16384)
        for w, (name, *spans) in parts.items():
            r = rec[w, 100:n - 100]
            if not r.any():
                continue
            tile_cyc = np.diff(rec[w, 100:n - 99, 0])
            print(f"gate_only={gate_only} {name}: " + ", ".join(
                f"{what} {int(np.median(r[:, j] - r[:, i]))}"
                for what, i, j in spans)
                + f"; tile {int(np.median(tile_cyc))} cycles "
                f"({np.median(tile_cyc) / tile:.1f} a sample)", flush=True)


# ── chain ────────────────────────────────────────────────────────────────

MICRO = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ long long stamp() { long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory"); return t; }
__global__ void chains(const float* in, float* out, long long* cyc, int n,
                       float a1, float a2, float rel, float c1, float hs) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = in[(threadIdx.x + i) & 31];
  float y1 = 0.f, y2 = 0.f, e = 0.f, z = 0.f, lim = 0.f;
  const long long t0 = stamp();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float y = fmaf(-a2, y2, fmaf(-a1, y1, x[k]));
      y2 = y1; y1 = y;
    }
  }
  const long long t1 = stamp();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a = fabsf(x[k]);
      const bool at = a > e;
      const float bl = fmaf(rel, e, __fmul_rn(c1, a));
      e = at ? a : bl;
    }
  }
  const long long t2 = stamp();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool at = x[k] > 0.5f, above = x[k] > 0.25f;
      lim = at ? __fadd_rn(z, hs) : lim;
      z = __fadd_rn(z, above ? 0.0f : 1.0f);
    }
  }
  const long long t3 = stamp();
  out[threadIdx.x] = y1 + e + z + lim;
  if (threadIdx.x == 0) {
    cyc[0] = t1 - t0; cyc[1] = t2 - t1; cyc[2] = t3 - t2;
  }
}
extern "C" int run(const float* in, float* out, long long* cyc, int n,
                   float a1, float a2, float rel, float c1, float hs) {
  chains<<<1, 32>>>(in, out, cyc, n, a1, a2, rel, c1, hs);
  return (int)cudaDeviceSynchronize();
}
'''

K7_EDITS = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_slot[8192];\n__device__ "
     "__forceinline__ long long stamp() { long long t; asm volatile("
     "\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: \"memory\"); return t; }\n"),
    ("    for (int j = 0; j < n; ++j) {\n      const float rms = __shfl_sync(",
     "    for (int j = 0; j < n; ++j) {\n      if (b == 0 && lane == 0 && "
     "s0 + j < 8192) g_slot[s0 + j] = stamp();\n      const float rms = "
     "__shfl_sync("),
    ("extern \"C\" {\n", "extern \"C\" {\nint probe_copy(long long* h) { "
     "return (int)cudaMemcpyFromSymbol(h, g_slot, sizeof(g_slot)); }\n"),
]


def chain(args) -> None:
    k7src = (CSRC / "dynamics.cu").read_text()
    for a, b in K7_EDITS:
        if k7src.count(a) != 1:
            raise SystemExit(f"the probe does not fit the source: {a!r}")
        k7src = k7src.replace(a, b)
    libs = build({"micro": MICRO, "k7_slots": k7src})
    print("card:", card(), flush=True)
    micro = ctypes.CDLL(str(libs["micro"]))
    micro.run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                          + [ctypes.c_float] * 5)
    n = 1 << 16
    xin = torch.rand(32, device="cuda")
    out = torch.empty(32, device="cuda")
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    c = reducer.biquad_coeffs(reducer.HPF_FREQ, SR, False)
    rel, c1, hs = reducer.gate_params(SR)
    for _ in range(2):
        assert micro.run(xin.data_ptr(), out.data_ptr(), cyc.data_ptr(), n,
                         float(c[3]), float(c[4]), rel, c1, float(hs)) == 0
    cy = cyc.cpu().numpy() / n
    print(f"K6 stage chains, cycles a sample (one warp, {n} samples): "
          f"biquad feedback {cy[0]:.2f}, envelope {cy[1]:.2f}, hold count "
          f"{cy[2]:.2f}", flush=True)
    k7 = K7(entry(libs["k7_slots"], "aat_dynamics_scan"))
    probe = ctypes.CDLL(str(libs["k7_slots"]))
    scene = gen.mixed_scene(60.0, SR, seed=0)
    for b in (1, B):
        sl = torch.from_numpy(np.stack(
            [scene[k * 9000:k * 9000 + T] for k in range(b)])
            .reshape(b, S, 1024).astype(np.float32)).cuda()
        for label, st in (("fresh", dynamics.init_state("cuda", (b,))),
                          ("session", session_state(b, 5))):
            for _ in range(2):
                k7(st, sl, "hist")
                torch.cuda.synchronize()
            h = np.zeros(8192, np.int64)
            assert probe.probe_copy(h.ctypes.data_as(ctypes.c_void_p)) == 0
            d = np.diff(h[:S])
            print(f"K7 hist chain B={b} {label}: cycles a slot median "
                  f"{np.median(d):.0f}, mean {d.mean():.0f}, p90 "
                  f"{np.percentile(d, 90):.0f}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("turns")
    t.add_argument("--parent", default=str(
        REPO / "_proof" / "parent" / "audio_analyzer_rs_tpu_torch" / "csrc"))
    t.add_argument("--variants", action="store_true")
    s = sub.add_parser("split")
    s.add_argument("--version", choices=("barrier", "mbarrier"), required=True)
    s.add_argument("--source")
    s.add_argument("--sass")
    sub.add_parser("chain")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("k67_probe: no CUDA device", file=sys.stderr)
        return 1
    {"turns": turns, "split": split, "chain": chain}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
