#!/usr/bin/env python3
"""The port's twin of tools/mosaic_probe.py: the probe's lane gathers through
the hand-written kernels K8 (`lane_gather`) and K9 (`comb_gather12`) of
csrc/gather.cu on one GPU.

    python3 port_tools/gather_probe.py
    python3 port_tools/gather_probe.py --turns a=PATH b=PATH [--rounds 2]

The TPU probe asked whether Mosaic lowers `jnp.take_along_axis` across
128-lane tiles, and timed the comb's 12-gather read.  On the card a thread
reads any address, so the question left is the one the probe's checks
ask: are the gathers right, and how long does the 12-gather take.  The
five cases, as the probe makes them (x = arange):
  lane_gather_intile     [8, 1024], each lane inside its own 128-lane tile;
  lane_gather_crosstile  [8, 1024], stride 3 across tiles;
  lane_gather_random     [8, 1024], random indices (seed 0) a row;
  lane_gather_7296       [8, 7296], stride 13 (the comb's padded row);
  comb_gather12_7296     the 12 gathers at (i + n) mod 7296 summed, on
                         x = arange and on random values;
each held bit for bit to `np.take_along_axis` (the 12-gather: its sum from
+0.0 in numpy float32) and to the plain version in ops/gather.py run on the
same card tensors; then K8 and K9 at [8, 7296] with wrapped negative and
out-of-range indices (NaN).  Prints `correct=` a tag, then the 12-gather's
time in microseconds a call (CUDA events around 50 back-to-back calls
after a warm call and a ~2 ms spin of the card, median of 20 samples)
beside its bound (bytes over 3.35 TB/s) and K8's beside `torch.gather`'s
on the same [8, 7296] shape.  The card's name and power limit come first.
Exits 1 on any mismatch, 2 without a CUDA device.

`--turns label=path ...`: versions of csrc/gather.cu (a parent's from
`git archive <rev> audio_analyzer_rs_tpu_torch/csrc | tar -x -C
_proof/parent`), each built alone by nvcc with the port's flags into
`_proof/gather_turns/` and called through its C entries; every version's
K8 and K9 are first held bit for bit to the plain versions on the card,
then timed at [8, 7296] in turns (a, b, b, a, `--rounds` times), each turn
the median µs a call as above.  One JSON object a turn.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
F, P, P2 = 8, 1024, 7296
HBM_BYTES_PER_S = 3.35e12
REPS = 50
SAMPLES = 20
SPIN_CYCLES = 4_000_000         # ~2 ms of card time ahead of the launches


def lane_cases() -> list:
    """(tag, x, idx) of the probe's four lane_gather cases."""
    x = np.arange(F * P, dtype=np.float32).reshape(F, P)
    base = (np.arange(P) // 128) * 128
    intile = (base + (np.arange(P) * 7) % 128).astype(np.int32)
    cross = ((np.arange(P) * 3) % P).astype(np.int32)
    rand = np.random.default_rng(0).integers(0, P, size=(F, P)).astype(
        np.int32)
    x2 = np.arange(F * P2, dtype=np.float32).reshape(F, P2)
    return [("lane_gather_intile", x, np.broadcast_to(intile, (F, P)).copy()),
            ("lane_gather_crosstile", x,
             np.broadcast_to(cross, (F, P)).copy()),
            ("lane_gather_random", x, rand),
            ("lane_gather_7296", x2, comb_index())]


def comb_index() -> np.ndarray:
    return np.broadcast_to(((np.arange(P2) * 13) % P2).astype(np.int32),
                           (F, P2)).copy()


def comb_inputs() -> list:
    """x = arange and random values (both signs) at [8, 7296]."""
    rand = np.random.default_rng(1).standard_normal((F, P2)).astype(
        np.float32)
    return [np.arange(F * P2, dtype=np.float32).reshape(F, P2), rand]


def edge_case() -> tuple:
    """[8, 7296] random values with indices over [-2P, 2P) (a quarter
    wrapped from the end, half outside: NaN for K8) and near the ends of
    the int32 range (K9's wrapping add)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((F, P2)).astype(np.float32)
    x[0, :16] = -0.0
    idx = rng.integers(-2 * P2, 2 * P2, (F, P2)).astype(np.int32)
    idx[1, :64] = np.int32(2 ** 31 - 1) - np.arange(64, dtype=np.int32)
    idx[2, :64] = np.int32(-2 ** 31) + np.arange(64, dtype=np.int32)
    idx[0, :16] = np.arange(16, dtype=np.int32)
    return x, idx


def comb_reference(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The 12-gather in numpy float32: from +0.0, n = 0..11, int32-wrapped
    (idx + n) and its floor-mod."""
    acc = np.zeros_like(x)
    for n in range(12):
        j = (idx.astype(np.int64) + n + 2 ** 31) % 2 ** 32 - 2 ** 31
        acc = acc + np.take_along_axis(x, j % x.shape[1], axis=1)
    return acc


def lane_reference(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """np.take_along_axis with JAX's index semantics (NaN out of range)."""
    p = x.shape[1]
    i = idx.astype(np.int64)
    inside = (i >= -p) & (i < p)
    out = np.take_along_axis(x, np.where(inside, i % p, 0), axis=1)
    return np.where(inside, out, np.float32(np.nan)).astype(np.float32)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def check_cases(say=print) -> dict:
    """Every case through K8 and K9 on the card, bitwise against numpy and
    the plain versions on the same card tensors; prints `correct=` a tag.
    Returns {tag: ok} and the largest |K - plain| over the finite
    outputs of each kernel."""
    import torch
    from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather
    dev = torch.device("cuda")
    results, err = {}, {"K8": 0.0, "K9": 0.0}

    def run(tag, x, idx, kernel, plain, ref, name):
        xd = torch.from_numpy(x).to(dev)
        idd = torch.from_numpy(idx).to(dev)
        got = kernel(xd, idd)
        want = plain(xd, idd)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        # NaNs by position: the card's canonical NaN may differ in bits.
        nan = np.isnan(ref)
        ok = (np.array_equal(np.isnan(got), nan)
              and np.array_equal(np.isnan(want), nan)
              and same_bits(np.where(nan, 0, got).astype(np.float32),
                            np.where(nan, 0, ref).astype(np.float32))
              and same_bits(np.where(nan, 0, want).astype(np.float32),
                            np.where(nan, 0, ref).astype(np.float32)))
        fin = ~nan
        if fin.any():
            err[name] = max(err[name], float(np.abs(got[fin] - want[fin])
                                             .max()))
        results[tag] = ok
        say(f"{tag:28s} correct={ok}")

    for tag, x, idx in lane_cases():
        run(tag, x, idx, hopper_gather.lane_gather, gather.lane_gather,
            np.take_along_axis(x, idx, axis=1), "K8")
    for k, x in enumerate(comb_inputs()):
        idx = comb_index()
        run(f"comb_gather12_7296{'_random' if k else ''}", x, idx,
            hopper_gather.comb_gather12, gather.comb_gather12,
            comb_reference(x, idx), "K9")
    x, idx = edge_case()
    run("lane_gather_edges", x, idx, hopper_gather.lane_gather,
        gather.lane_gather, lane_reference(x, idx), "K8")
    run("comb_gather12_edges", x, idx, hopper_gather.comb_gather12,
        gather.comb_gather12, comb_reference(x, idx), "K9")
    return {"ok": results, "max_abs_err": err}


def cuda_us(fn, reps: int = REPS) -> float:
    """Median µs a call: CUDA events around `reps` back-to-back calls
    queued behind a ~2 ms spin, SAMPLES samples after a warm call."""
    import torch
    fn()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def time_kernels() -> dict:
    """K8, K9, the plain versions and torch.gather at [8, 7296] (the probe's
    stride-13 index; K9 on zeros, as the probe times it), with the bound:
    x and idx read once, the output written once, over 3.35 TB/s."""
    import torch
    from audio_analyzer_rs_tpu_torch.ops import gather, hopper_gather
    dev = torch.device("cuda")
    x = torch.zeros((F, P2), dtype=torch.float32, device=dev)
    idx = torch.from_numpy(comb_index()).to(dev)
    idx64 = idx.long()
    nbytes = 3 * F * P2 * 4
    return {
        "k9_us": cuda_us(lambda: hopper_gather.comb_gather12(x, idx)),
        "k9_plain_us": cuda_us(lambda: gather.comb_gather12(x, idx), 5),
        "k8_us": cuda_us(lambda: hopper_gather.lane_gather(x, idx)),
        "k8_plain_us": cuda_us(lambda: gather.lane_gather(x, idx), 5),
        "gather_us": cuda_us(lambda: torch.gather(x, 1, idx64)),
        "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
        "bytes": nbytes,
    }


def turns(sources: list[str], rounds: int) -> int:
    """Each `label=path` version of csrc/gather.cu built alone, held bitwise
    to the plain versions, then timed in turns; 1 on a mismatch."""
    import torch
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.ops import gather
    out_dir = REPO / "_proof" / "gather_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (F, P2)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(comb_index()).to(dev)
    edge_x, edge_i = (torch.from_numpy(a).to(dev) for a in edge_case())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls = {}
    for spec in sources:
        label, path = spec.split("=", 1)
        lib_path = out_dir / f"lib_{label}.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(lib_path), path], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"gather_probe: nvcc failed for {label}:\n"
                     f"{proc.stderr}")
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("aat_lane_gather", "aat_comb_gather12"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int

        def call(entry, a, i, _lib=lib):
            out = torch.empty_like(a)
            _build.check(getattr(_lib, entry)(
                a.data_ptr(), i.data_ptr(), out.data_ptr(), a.shape[0],
                a.shape[1], stream), entry)
            return out
        for entry, plain in (("aat_lane_gather", gather.lane_gather),
                             ("aat_comb_gather12", gather.comb_gather12)):
            for a, i in ((x, idx), (edge_x, edge_i)):
                got, want = call(entry, a, i), plain(a, i)
                nan = torch.isnan(want)
                if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                        torch.where(nan, 0, got.view(torch.int32)),
                        torch.where(nan, 0, want.view(torch.int32)))):
                    print(f"{label} {entry}: differs from the plain version")
                    return 1
        calls[label] = call
        print(json.dumps({"build": label, "ptxas": [
            ln.strip() for ln in proc.stderr.splitlines() if "Used" in ln]}))
    labels = list(calls)
    for r in range(rounds):
        order = labels + labels[::-1]
        for label in (order if r % 2 == 0 else order[::-1]):
            call = calls[label]
            print(json.dumps({
                "round": r, "version": label,
                "k8_us": cuda_us(lambda: call("aat_lane_gather", x, idx)),
                "k9_us": cuda_us(lambda: call("aat_comb_gather12", x, idx))}))
    return 0


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if args.turns:
        return turns(args.turns, args.rounds)
    res = check_cases()
    t = time_kernels()
    print(f"12x gather [8,7296]: {t['k9_us']:.2f} us/call (bound "
          f"{t['bound_us']:.3f} us: {t['bytes'] / 1e6:.2f} MB; plain "
          f"{t['k9_plain_us']:.1f} us)")
    print(f"lane gather [8,7296]: {t['k8_us']:.2f} us/call vs torch.gather "
          f"{t['gather_us']:.2f} us (bound {t['bound_us']:.3f} us; plain "
          f"{t['k8_plain_us']:.1f} us)")
    return 0 if all(res["ok"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
