#!/usr/bin/env python3
"""Time versions of the scan kernels K4 (onset, csrc/onset.cu) and K5 (noise
floor, csrc/noisefloor.cu) against each other on one GPU, in turns.

    python3 port_tools/kernel_turns.py --kernel k4 \\
        --source new=audio_analyzer_rs_tpu_torch/csrc/onset.cu \\
        --source old=_proof/parent/audio_analyzer_rs_tpu_torch/csrc/onset.cu \\
        [--probe old:nodiv ...] [--rounds 2] [--data scene|random] \\
        [--out k4_turns.json]

Each `--source label=path` is built alone by nvcc (sm_90a, the port's
flags) into its own library under `_proof/kernel_turns/` and called through
the port's wrapper (`ops/hopper_onset.py`, `ops/hopper_noisefloor.py`), so
every version sees the same arguments.  Every source is first held bitwise
to the plain version on the card.  `--probe label:name` adds a probe build
of a source, which is only timed (a probe need not be right):
  nodiv    K4's frame-at-a-time design (shuffle trees a frame): the burst
           ratio's IEEE division made a product;
  noshfl   the same design: no shuffle trees and no ballot (each bin
           warp's lane 0 stores its own values);
  nochain  K4: the chain warp only meets the barriers;
  nophase1 K4's tiled design: the bin lanes skip their per-bin work (phase
           1: the floor recurrence and the flux contributions);
  nophase2 the tiled design: the bin warps skip the frame reductions;
  noguard  K4, K5: `div_guarded` is the bare IEEE division again (zero
           numerators take the division's slow path).
Probes join with "+" (`new:nophase1+nophase2`: the chain warp alone).  A
probe whose text does not fit the source stops the script.

Timing as chip_smoke.py does it: CUDA events around 10 back-to-back
launches after a ~2 ms spin, median of 20 samples; the versions in turns,
`--rounds` times over (the order reversed every other round), each turn's
median printed.  K4's shapes: the segmented onset step S=128 x N=4,096 and
its first 1,024 frames, and the sequential analyzer's chunk S=1 x
N=131,072; its per-frame cost is the slope between N=1,024 and N=4,096.
K5's: the segmented pitch step S=128 x N=64 x band 464 and the sequential
analyzer's chunk S=1 x N=4,096, with a state as wide as the band (the
kernel alone); its per-frame cost at S=1.  `--data scene` (the default)
takes chip_smoke.py's inputs from the 30-minute `mixed_scene(seed=0)` (about
40% of it digital silence, so zero magnitudes); `--data random` nonzero
random magnitudes.  Cycles at the SM clock nvidia-smi reads.  One JSON
object a line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT_DIR = REPO / "_proof" / "kernel_turns"
SR = 44100.0

PROBES = {
    "nodiv": [(r"excess = (?:div_guarded|__fdiv_rn)\(m, ",
               "excess = __fmul_rn(m, ")],
    "noshfl": [(r"#pragma unroll\s*\n\s*for \(int off = 16; off > 0; "
                r"off >>= 1\) \{.*?\n\s*\}\s*\n\s*const int cnt = "
                r"__popc\(__ballot_sync\(FULL, burst\)\);",
                "const int cnt = burst ? 1 : 0;")],
    "nochain": [(r"(?<!void )chain_tile\(", "if (false) chain_tile(")],
    "nophase1": [(r"if \(real\) \{(\s*// Phase 1)", r"if (false) {\1")],
    "nophase2": [(r"if \(lane < nt\) \{(\s*)const float4\*",
                  r"if (false) {\1const float4*")],
    "noguard": [(r"const float q = __fdiv_rn\(n == 0\.0f \? 1\.0f : n, d\);"
                 r"\s*return n == 0\.0f \? n : q;",
                 "return __fdiv_rn(n, d);")],
}
ENTRY = {"k4": "aat_onset_scan", "k5": "aat_noise_floor_scan"}


def probe_source(text: str, names: str) -> str:
    for name in names.split("+"):
        text = _probe(text, name)
    return text


def _probe(text: str, name: str) -> str:
    for pat, rep in PROBES[name]:
        text, n = re.subn(pat, rep, text, flags=re.S)
        if n == 0:
            sys.exit(f"kernel_turns: probe {name} does not fit its source")
    return text


def build(label: str, text: str) -> tuple[Path, dict]:
    from audio_analyzer_rs_tpu_torch import _build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"{label}.cu"
    src.write_text(text)
    lib = OUT_DIR / f"lib_{label}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"kernel_turns: nvcc failed for {label}:\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "Used" in ln]
    return lib, {"build": label, "ptxas": regs}


def load(path: Path, entry: str) -> ctypes.CDLL:
    from audio_analyzer_rs_tpu_torch import _build
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return lib


def scene_streams(dev, window: int, hop: int, chunk: int, segments=None):
    """chip_smoke.py's streams of the 30-minute `mixed_scene(seed=0)`:
    (the recording on the device, zero-padded to the plan's last sample,
    [S, stream samples] streams, the plan)."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.utils.framing import num_frames
    audio = gen.mixed_scene(1800.0, SR, seed=0)
    n = num_frames(len(audio), window, hop)
    plan = segmented._plan_streams(
        n, segments or segmented.auto_segments(n, 128), 128, chunk, window,
        hop)
    padded = torch.from_numpy(np.pad(
        audio, (0, max(0, plan.max_sample - len(audio))))).to(dev)
    return padded, segmented._slice_streams(
        padded, plan.stream_start * hop, plan.stream_samples), plan


def k4_cases(dev, data: str) -> dict:
    """name → (state, (mags, global floor, tick, hold))."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, onset
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal

    def with_flags(mags, gf):
        no = torch.zeros(mags.shape[:2], dtype=torch.bool, device=dev)
        return mags, gf, no, no

    if data == "scene":
        win, hop = onset.WINDOW, onset.HOP
        audio, streams, plan = scene_streams(dev, win, hop, 4096)
        big = windowed_mags(frame_signal(streams[:, :plan.chunk_samples],
                                         win, hop), win, "fft")
        seq = windowed_mags(frame_signal(audio[:131071 * hop + win], win,
                                         hop)[None], win, "fft")
        g = float(noisefloor.global_floor_linear(-96.0, onset.HALF))
        big = with_flags(big, torch.full(big.shape[:2], g, device=dev))
        seq = with_flags(seq, torch.full(seq.shape[:2], g, device=dev))
    else:
        rng = np.random.default_rng(2)

        def rand(s, n):
            m = rng.random((s, n, onset.HALF), dtype=np.float32) * 2.0
            m[rng.random((s, n)) < 0.06] *= np.float32(20.0)
            gf = rng.uniform(0.01, 0.08, (s, n)).astype(np.float32)
            return with_flags(torch.from_numpy(m).to(dev),
                              torch.from_numpy(gf).to(dev))

        big, seq = rand(128, 4096), rand(1, 131072)
    st128 = onset.init_state(onset.HALF, dev, (128,))
    return {"s128_n4096": (st128, big),
            "s128_n1024": (st128, tuple(x[:, :1024].contiguous()
                                        for x in big)),
            "s1_n131072": (onset.init_state(onset.HALF, dev, (1,)), seq),
            "check": (st128, tuple(x[:, :256].contiguous() for x in big))}


def k5_cases(dev, data: str) -> dict:
    """name → (state, (mags, global floor, band)); the state as wide as the
    band, so the wrapper adds no tail."""
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, pitch
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.hopper_stft import dft_mag
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    window, hop, half = 2048, 512, 1025
    kc = pitch.candidate_band(float(np.float32(SR) / np.float32(window)),
                              half)
    g = float(noisefloor.global_floor_linear(-96.0, half))
    if data == "scene":
        audio, streams, plan = scene_streams(dev, window, hop, 64, 128)
        trig = rdft_trig(window, dev)[:, :2 * (kc + 1)]
        win = hann(window, dev)
        step = streams[:, 2 * 64 * hop:2 * 64 * hop + plan.chunk_samples]
        big = dft_mag(frame_signal(step, window, hop), trig, win)
        seq = dft_mag(frame_signal(audio[:4095 * hop + window], window,
                                   hop)[None], trig, win)
    else:
        rng = np.random.default_rng(3)
        big, seq = (torch.from_numpy(rng.exponential(
            0.5, (s, n, kc + 1)).astype(np.float32)).to(dev)
            for s, n in ((128, 64), (1, 4096)))
    cases = {}
    for name, mags in (("s128_n64", big), ("s1_n4096", seq)):
        s = mags.shape[0]
        cases[name] = (noisefloor.init_state(kc, dev, (s,)),
                       (mags, torch.full(mags.shape[:2], g, device=dev), kc))
    cases["check"] = (noisefloor.init_state(half, dev, (128,)),
                      cases["s128_n64"][1])
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k4", "k5"), required=True)
    ap.add_argument("--source", action="append", required=True,
                    help="label=path of a kernel source")
    ap.add_argument("--probe", action="append", default=[],
                    help="label:name, a probe build of a source")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--data", choices=("scene", "random"), default="scene")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_turns: no CUDA device")
    import chip_smoke
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.ops import (hopper_noisefloor,
                                                 hopper_onset, noisefloor,
                                                 onset)

    texts = {k: (REPO / v).read_text()
             for k, v in (s.split("=", 1) for s in args.source)}
    full = list(texts)
    for spec in args.probe:
        label, name = spec.split(":")
        texts[f"{label}-{name}"] = probe_source(texts[label], name)
    dev = torch.device("cuda")
    if args.kernel == "k4":
        cases = k4_cases(dev, args.data)

        def call(st, x):
            return hopper_onset.onset_scan(st, *x)

        def plain(st, x):
            return onset.onset_scan_plain(st, *x)
    else:
        cases = k5_cases(dev, args.data)

        def call(st, x):
            return hopper_noisefloor.noise_floor_scan(st, *x)

        def plain(st, x):
            return noisefloor.noise_floor_scan_plain(st, *x)
    torch.cuda.synchronize()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(*kv),
                                         texts.items())))
    libs = {k: load(path, ENTRY[args.kernel])
            for k, (path, _) in built.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lines = [{"card": card, "kernel": args.kernel, "data": args.data}]
    lines += [info for _, info in built.values()]

    def run_with(label, fn):
        _build._lib = libs[label]
        try:
            return fn()
        finally:
            _build._lib = None

    st, x = cases.pop("check")
    want = plain(st, x)
    for label in full:
        got = run_with(label, lambda: call(st, x))
        torch.cuda.synchronize()
        flat = (lambda r: [t for part in r for t in
                           (part if isinstance(part, tuple) else (part,))])
        same = all(chip_smoke.same_bits(a, b)
                   for a, b in zip(flat(got), flat(want)))
        lines.append({"check": label, "bitwise_to_plain": same})
        if not same:
            print(json.dumps(lines[-1]))
            return 1

    times = {k: {c: [] for c in cases} for k in libs}
    for r in range(args.rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        for label in order:
            for name, (st, x) in cases.items():
                t = run_with(label, lambda: chip_smoke.cuda_times(
                    lambda: call(st, x), chip_smoke.KERNEL_REPS))
                times[label][name].extend(t)
                lines.append({"turn": r, "label": label, "shape": name,
                              "ms": statistics.median(t)})
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    for label, by_shape in times.items():
        ms = {k: statistics.median(v) for k, v in by_shape.items()}
        row = {"label": label, **{f"ms_{k}": v for k, v in ms.items()}}
        if args.kernel == "k4":
            slope = (ms["s128_n4096"] - ms["s128_n1024"]) / 3072 * 1e6
            row["per_frame_cycles_s128"] = slope * sm_mhz / 1e3
            row["per_frame_cycles_s1"] = (ms["s1_n131072"] / 131072 * 1e6
                                          * sm_mhz / 1e3)
        else:
            row["per_frame_cycles_s1"] = (ms["s1_n4096"] / 4096 * 1e6
                                          * sm_mhz / 1e3)
        lines.append({**row, "sm_mhz": sm_mhz, "card": card})
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
