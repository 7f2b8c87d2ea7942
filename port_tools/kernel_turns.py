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
every version sees the same arguments.  A K5 source with the C entry of
the previous design (no `width` argument; the state out only as wide
as the band) is called as that build's wrapper called it: its launch, then
`noisefloor.with_tail`'s torch ops.  Every source is first held bitwise to
the plain version on the card.  `--probe label:name` adds a probe build
of a source, which is only timed (a probe need not be right):
  nodiv    K4's frame-at-a-time design (shuffle trees a frame): the burst
           ratio's IEEE division made a product;
  noshfl   the same design: no shuffle trees and no ballot (each bin
           warp's lane 0 stores its own values);
  nochain  K4: the chain warp only meets the barriers;
  nophase1 K4's tiled design: the bin lanes skip their per-bin work (phase
           1: the floor recurrence and the flux contributions);
  nophase2 the tiled design: the bin warps skip the frame reductions;
  noguard  K4: `div_guarded` is the bare IEEE division again (zero
           numerators take the division's slow path);
  packed288
           K4's two-blocks-a-SM instantiation with launch bounds of 288
           threads (a register cap of ~113 a thread);
  nobranch K5: vn's division on every step, no branch (a numerator of 1
           where the magnitude does not rise, whose quotient is not read);
  ahead8, ahead32
           K5 with the frames loaded ahead fixed at 8 or 32;
  counts   K5's step counts at every case (not timed): steps, IEEE
           divisions (on live lanes), those whose numerator is zero or
           subnormal (the division's slow path), subnormal volatilities,
           warp-frames, warp-frames where any lane divides (lanes past the
           band included) and where a live lane does, and the divisions of
           the lanes past the band.
Probes join with "+" (`new:nophase1+nophase2`: the chain warp alone).  A
probe whose text does not fit the source stops the script.

Timing as chip_smoke.py does it: CUDA events around 10 back-to-back
launches after a ~2 ms spin, median of 20 samples; the versions in turns,
`--rounds` times over (the order reversed every other round), each turn's
median printed.  K4's shapes: the segmented onset step S=128 x N=4,096 and
its first 1,024 frames, the sequential analyzer's chunk S=1 x N=131,072,
the full step's call at 128 and 2,048 streams (N=7,485: each stream
479,232 samples from its own offset, through K11), the live slot [1, 16]
and the pool wave [33, 16]; its per-frame cost is the slope between
N=1,024 and N=4,096, and at the full step's shapes the call's ms over its
frames (at 2,048 streams also over its rounds, ceil(2,048 / (SMs x
resident blocks a SM at 129 bins), as the build's `aat_onset_blocks_per_sm`
reports them; a build without that entry holds one block a SM).  Every
build is first held bitwise to the plain scan at S=128 x N=256 and S=300 x
N=100.  `--data scene` (the default) takes chip_smoke.py's inputs from the
30-minute `mixed_scene(seed=0)` (about 40% of it digital silence, so zero
magnitudes); `--data random` nonzero random magnitudes.
K5's cases (the scene's data, whatever `--data` says): the segmented pitch
step S=128 x N=64 x band 464 with the path's 1,025-wide carried state
(`main`) and with a state as wide as the band (`main_alone`, the kernel
alone, as chip_smoke.py phase 3 times it); the sequential analyzer's chunk
S=1 x N=4,096 from a fresh 1,025-wide state on the scene (`s1_scene`) and
on random nonzero magnitudes (`s1_random`); the full step's call as
`make_batched_full_step` makes it (128 streams x 933 frames of 1,025-float
rows, band 426, the 1,025-wide state carried from the first step:
`fullstep`; the first step's own call, `fullstep_fresh`, is checked, not
timed); the live slot [1, 2, 426] and the pool wave [33, 2, 426], states
carried.  Each is timed through the call (`ms`) and as the C launch alone
with its outputs allocated once (`kernel_ms`), with its byte bound and
achieved GB/s, and at S=1 cycles a frame.  Then the full step itself
with each build as its K5 call, in turns (port_tools/fullstep_profile.py
`profile_step`): torch's and the port's CUDA kernels a step and their
card ms under torch.profiler, K5's, and the step's ms by CUDA events.
Then K5's chain bound
(port_tools/k5_chain.py: the floor recurrence alone, one warp a block of 32
bins running the S=1 chunk's frames from shared memory, clock64 around the
frame loop): cycles a frame, mean and largest over the warps, on the scene
and on random magnitudes.  Cycles at the SM clock nvidia-smi samples while
the launches run (chip_smoke.py `SmClock`).  One JSON object a line.
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
sys.path.insert(0, str(REPO / "port_tools"))
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
    "packed288": [(r"using Packed = Layout<2, 2, PACKED_WARPS>;",
                   "using Packed = Layout<2, 2, MAX_WARPS>;")],
    "nobranch": [(r"if \(rising\) q = __fdiv_rn\(v, ",
                  "q = __fdiv_rn(rising ? v : 1.0f, ")],
    "ahead8": [(r"if \(deep_ahead\(warps, N\)\)", "if (false)")],
    "ahead32": [(r"if \(deep_ahead\(warps, N\)\)", "if (true)")],
}
# K5's counts probe: the counters and their C entry around the source, and
# a count after each frame's division.
K5_COUNT_NAMES = ("steps", "divisions", "div_tiny_numerator", "subnormal_v",
                  "warp_frames", "warp_frames_dividing",
                  "warp_frames_dividing_live", "dead_lane_divisions")
K5_COUNTS_HEAD = """#include <cuda_runtime.h>
__device__ unsigned long long k5_counts[8];
__device__ __forceinline__ void k5_count(bool live, bool rising, float v) {
  const unsigned act = __activemask();
  const bool tiny = fabsf(v) < 0x1p-126f;
  unsigned long long add[8];
  add[0] = __popc(__ballot_sync(act, live));
  add[1] = __popc(__ballot_sync(act, live && rising));
  add[2] = __popc(__ballot_sync(act, live && rising && tiny));
  add[3] = __popc(__ballot_sync(act, live && tiny && v != 0.0f));
  add[4] = 1;
  add[5] = __ballot_sync(act, rising) != 0;
  add[6] = __ballot_sync(act, live && rising) != 0;
  add[7] = __popc(__ballot_sync(act, !live && rising));
  if ((threadIdx.x & 31) == __ffs(act) - 1)
    for (int i = 0; i < 8; ++i)
      if (add[i]) atomicAdd(&k5_counts[i], add[i]);
}
"""
K5_COUNTS_TAIL = """
extern "C" int aat_noise_floor_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5_counts, sizeof(k5_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k5_counts, zero, sizeof(zero)));
}
"""
PROBES["counts"] = [
    (r"\A", K5_COUNTS_HEAD),
    (r"float& vol\) \{", "float& vol, bool live) {"),
    (r"floor_step\(m\[u\], floor, prev, vol\)",
     "floor_step(m[u], floor, prev, vol, live)"),
    (r"(\n\s*)(const bool sustained)", r"\1k5_count(live, rising, v);\1\2"),
    (r"\Z", K5_COUNTS_TAIL),
]


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
    """name → (state, (mags, global floor, tick, hold)).  The names that
    start with "check" are held bitwise to the plain scan, not timed."""
    import numpy as np
    import torch
    import chip_smoke
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, onset
    from audio_analyzer_rs_tpu_torch.ops.stft import windowed_mags
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    frames = chip_smoke.FULL_ONSET_FRAMES

    def with_flags(mags, gf):
        no = torch.zeros(mags.shape[:2], dtype=torch.bool, device=dev)
        return mags, gf, no, no

    g = float(noisefloor.global_floor_linear(-96.0, onset.HALF))
    if data == "scene":
        win, hop = onset.WINDOW, onset.HOP
        audio, streams, plan = scene_streams(dev, win, hop, 4096)
        big = windowed_mags(frame_signal(streams[:, :plan.chunk_samples],
                                         win, hop), win, "fft")
        seq = windowed_mags(frame_signal(audio[:131071 * hop + win], win,
                                         hop)[None], win, "fft")
        step = chip_smoke.fullstep_onset_mags(audio, 2048)
        del audio, streams
        big, seq, step = (with_flags(m, torch.full(m.shape[:2], g,
                                                   device=dev))
                          for m in (big, seq, step))
    else:
        rng = np.random.default_rng(2)

        def rand(s, n):
            m = rng.random((s, n, onset.HALF), dtype=np.float32) * 2.0
            m[rng.random((s, n)) < 0.06] *= np.float32(20.0)
            gf = rng.uniform(0.01, 0.08, (s, n)).astype(np.float32)
            return with_flags(torch.from_numpy(m).to(dev),
                              torch.from_numpy(gf).to(dev))

        big, seq = rand(128, 4096), rand(1, 131072)
        gen = torch.Generator(dev).manual_seed(2)
        m = torch.rand((2048, frames, onset.HALF), device=dev,
                       generator=gen) * 2.0
        step = with_flags(m, torch.full(m.shape[:2], g, device=dev))

    def part(x, s, n):
        return tuple(v[:s, :n].contiguous() for v in x)

    def state(s):
        return onset.init_state(onset.HALF, dev, (s,))
    return {"s128_n4096": (state(128), big),
            "s128_n1024": (state(128), part(big, 128, 1024)),
            "s1_n131072": (state(1), seq),
            "s128_n7485": (state(128), part(step, 128, frames)),
            "s2048_n7485": (state(2048), step),
            "s1_n16": (state(1), part(big, 1, 16)),
            "s33_n16": (state(33), part(big, 33, 16)),
            "check": (state(128), part(big, 128, 256)),
            "check_many": (state(300), part(step, 300, 100))}


def k5_new_api(text: str) -> bool:
    """Whether a K5 source's C entry takes the magnitudes' width (and
    writes the whole state), as the package's does."""
    return re.search(r"int H, int width, void\* stream", text) is not None


def k5_argtypes(new_api: bool):
    from audio_analyzer_rs_tpu_torch import _build
    sig = _build._SIGNATURES["aat_noise_floor_scan"]
    return sig if new_api else sig[:-2] + sig[-1:]


def k5_cases(dev) -> tuple:
    """(the full step, its states after step 1, step 2's chunk), {name →
    (state, mags, global floor, band)}."""
    import fullstep_profile
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.ops import noisefloor, pitch
    from audio_analyzer_rs_tpu_torch.ops.fft import hann, rdft_trig
    from audio_analyzer_rs_tpu_torch.ops.hopper_stft import dft_mag
    from audio_analyzer_rs_tpu_torch.utils.framing import frame_signal
    window, hop, half = 2048, 512, 1025
    kc = pitch.candidate_band(float(np.float32(SR) / np.float32(window)),
                              half)
    kc48 = pitch.candidate_band(float(np.float32(48000.0)
                                      / np.float32(window)), half)
    g = float(noisefloor.global_floor_linear(-96.0, half))
    audio, streams, plan = scene_streams(dev, window, hop, 64, 128)
    trig = rdft_trig(window, dev)[:, :2 * (kc + 1)]
    win = hann(window, dev)

    def k1(lo):
        return dft_mag(frame_signal(
            streams[:, lo * hop:lo * hop + plan.chunk_samples], window, hop),
            trig, win)

    def gf_of(mags):
        return torch.full(mags.shape[:2], g, device=dev)

    prev, big = k1(64), k1(2 * 64)
    seq = dft_mag(frame_signal(audio[:4095 * hop + window], window,
                               hop)[None], trig, win)
    rng = np.random.default_rng(3)
    rand = torch.from_numpy(rng.exponential(
        0.5, (1, 4096, kc + 1)).astype(np.float32)).to(dev)
    carried, _ = noisefloor.noise_floor_scan_plain(
        noisefloor.init_state(half, dev, (128,)), prev, gf_of(prev), kc)
    live = seq[:, 1000:1002, :kc48 + 1].contiguous()
    pool = big[:33, 10:12, :kc48 + 1].contiguous()
    live_st, _ = noisefloor.noise_floor_scan_plain(
        noisefloor.init_state(half, dev, (1,)), seq[:, 900:1000],
        gf_of(seq[:, 900:1000]), kc48)
    pool_st, _ = noisefloor.noise_floor_scan_plain(
        noisefloor.init_state(half, dev, (33,)), big[:33, :10],
        gf_of(big[:33, :10]), kc48)
    fresh1 = noisefloor.init_state(half, dev, (1,))
    seen = []
    step_ctx = fullstep_profile.fleet_step(dev, seen)
    # The step's calls without their first frames (a K5 build with no
    # first-frame entry takes them too): banded magnitudes, so the fresh
    # call's tail stays frozen, in both the build and the plain scan.
    fs_fresh, fs = (call[:4] for call in seen)
    return step_ctx, {
        "main": (carried, big, gf_of(big), kc),
        "main_alone": (noisefloor.init_state(kc, dev, (128,)), big,
                       gf_of(big), kc),
        "s1_scene": (fresh1, seq, gf_of(seq), kc),
        "s1_random": (fresh1, rand, gf_of(rand), kc),
        "fullstep": fs,
        "fullstep_fresh": fs_fresh,
        "live": (live_st, live, gf_of(live), kc48),
        "pool": (pool_st, pool, gf_of(pool), kc48),
    }


def k5_bytes(st, mags, gf, band) -> int:
    """What a K5 call must move: the band of the magnitudes read and the
    effective floors written, the global floors, the state in and out
    across its width (and the first frame's tail where a fresh stream's
    tail is seeded from full-width magnitudes)."""
    s, n = mags.shape[0], mags.shape[-2]
    half = st.floor.shape[-1]
    seeded = int((~st.initialized).sum()) if mags.shape[-1] >= half else 0
    return (2 * s * n * band * 4 + gf.numel() * 4 + 2 * (3 * s * half * 4 + s)
            + seeded * (half - band) * 4)


def k5_main(args, texts: dict) -> int:
    """K5's turns, chain and counts (see the module's note)."""
    import torch
    import chip_smoke
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.ops import hopper_noisefloor, noisefloor
    import fullstep_profile
    import k5_chain
    dev = torch.device("cuda")
    chain_build = k5_chain.start_build()
    step_ctx, cases = k5_cases(dev)  # the package's library runs them
    torch.cuda.synchronize()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(*kv),
                                         texts.items())))
    chain_lib = k5_chain.finish_build(chain_build)
    libs, apis = {}, {}
    for label, (path, _) in built.items():
        apis[label] = k5_new_api(texts[label])
        lib = ctypes.CDLL(str(path))
        lib.aat_noise_floor_scan.argtypes = k5_argtypes(apis[label])
        lib.aat_noise_floor_scan.restype = ctypes.c_int
        libs[label] = lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lines = [{"card": card, "kernel": "k5"}]
    lines += [info for _, info in built.values()]

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    def scan(label, st, mags, gf, band):
        """The call: the package's wrapper, or for a source with the
        previous entry that design's (its launch, then with_tail)."""
        if apis[label]:
            _build._lib = libs[label]
            try:
                return hopper_noisefloor.noise_floor_scan(st, mags, gf, band)
            finally:
                _build._lib = None
        m3 = hopper_noisefloor.check_args(st, mags, gf, band)
        s, n = m3.shape[:2]
        lead = tuple(st.initialized.shape)
        eff = torch.empty(lead + (n, band), device=dev)
        sub = noisefloor.NoiseFloorState(
            *(torch.empty(lead + (band,), device=dev) for _ in range(3)),
            torch.empty_like(st.initialized))
        _build.check(libs[label].aat_noise_floor_scan(
            m3.data_ptr(), m3.stride(0), m3.stride(1), gf.data_ptr(),
            *(x.data_ptr() for x in st), eff.data_ptr(),
            *(x.data_ptr() for x in sub), s, n, band, st.floor.shape[-1],
            ctypes.c_void_p(_build.stream_ptr(mags))), "old K5")
        return noisefloor.with_tail(st, sub, mags, gf), eff

    def launch_only(label, st, mags, gf, band):
        """The C launch alone, outputs allocated once."""
        m3 = hopper_noisefloor.check_args(st, mags, gf, band)
        s, n, width = m3.shape
        half = st.floor.shape[-1]
        lead = tuple(st.initialized.shape)
        eff = torch.empty(lead + (n, band), device=dev)
        out_w = half if apis[label] else band
        out = [torch.empty(lead + (out_w,), device=dev) for _ in range(3)]
        init = torch.empty_like(st.initialized)
        ptrs = ([m3.data_ptr(), m3.stride(0), m3.stride(1), gf.data_ptr()]
                + [x.data_ptr() for x in st] + [eff.data_ptr()]
                + [x.data_ptr() for x in out] + [init.data_ptr(), s, n, band,
                                                  half])
        if apis[label]:
            ptrs.append(width)
        fn = libs[label].aat_noise_floor_scan
        stream = ctypes.c_void_p(_build.stream_ptr(mags))
        return lambda: fn(*ptrs, stream)

    # Every build but the count probes is checked, then timed.
    timed_labels = [k for k in texts if not k.endswith("-counts")]
    for label in timed_labels:
        for name, (st, mags, gf, band) in cases.items():
            got = scan(label, st, mags, gf, band)
            want = noisefloor.noise_floor_scan_plain(st, mags, gf, band)
            torch.cuda.synchronize()
            same = all(chip_smoke.same_bits_nan(a, b) for a, b in
                       zip((got[1], *got[0]), (want[1], *want[0])))
            emit({"check": label, "case": name, "bitwise_to_plain": same})
            if not same:
                return 1

    timed = [k for k in cases if k != "fullstep_fresh"]
    times = {k: {c: {"ms": [], "kernel_ms": []} for c in timed}
             for k in timed_labels}
    clock = chip_smoke.SmClock()
    with clock:
        for r in range(args.rounds):
            order = timed_labels if r % 2 == 0 else timed_labels[::-1]
            for label in order:
                for name in timed:
                    st, mags, gf, band = cases[name]
                    t_call = chip_smoke.cuda_times(
                        lambda: scan(label, st, mags, gf, band),
                        chip_smoke.KERNEL_REPS)
                    t_kern = chip_smoke.cuda_times(
                        launch_only(label, st, mags, gf, band),
                        chip_smoke.KERNEL_REPS)
                    times[label][name]["ms"].extend(t_call)
                    times[label][name]["kernel_ms"].extend(t_kern)
                    emit({"turn": r, "label": label, "case": name,
                          "ms": statistics.median(t_call),
                          "kernel_ms": statistics.median(t_kern)})
    for label, by_case in times.items():
        for name, t in by_case.items():
            st, mags, gf, band = cases[name]
            nbytes = k5_bytes(st, mags, gf, band)
            bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            ms, kern = (statistics.median(t[k]) for k in ("ms", "kernel_ms"))
            row = {"label": label, "case": name, "ms": ms, "kernel_ms": kern,
                   "bound_ms": bound_ms, "share_of_bound": bound_ms / kern,
                   "gb_per_s": nbytes / kern / 1e6, "mb": nbytes / 1e6}
            if mags.shape[0] == 1 and mags.shape[-2] >= 1024:
                row["cycles_a_frame"] = (kern / mags.shape[-2] * 1e6
                                         * clock.mhz / 1e3)
            emit({**row, "sm_mhz": clock.mhz, "sm_clock": clock.source,
                  "card": card})

    # The full step with each build's K5 call, in turns.
    for r in range(args.rounds):
        order = timed_labels if r % 2 == 0 else timed_labels[::-1]
        for label in order:
            emit({"fullstep": label, "turn": r,
                  **fullstep_profile.profile_step(
                      *step_ctx,
                      # The profiled step's states are all initialized:
                      # its first frames seed nothing.
                      lambda st, mags, gf, band, first=None, label=label:
                      scan(label, st, mags, gf, band))})

    for name in ("s1_scene", "s1_random"):
        _, mags, gf, band = cases[name]
        cyc = k5_chain.chain_cycles(chain_lib, mags[0], gf[0], band)
        emit({"chain": "floor recurrence", "case": name,
              "frames": mags.shape[1] - 1, "warps": len(cyc),
              "cycles_a_frame_mean": sum(cyc) / len(cyc),
              "cycles_a_frame_max": max(cyc),
              "cycles_a_frame_min": min(cyc)})

    names = K5_COUNT_NAMES
    for label in (k for k in texts if k.endswith("-counts")):
        lib = libs[label]
        lib.aat_noise_floor_counts.argtypes = (ctypes.c_void_p,)
        lib.aat_noise_floor_counts.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * len(names))()
        _build.check(lib.aat_noise_floor_counts(buf), "K5 counts")
        for name, (st, mags, gf, band) in cases.items():
            got = scan(label, st, mags, gf, band)
            torch.cuda.synchronize()
            _build.check(lib.aat_noise_floor_counts(buf), "K5 counts")
            want = noisefloor.noise_floor_scan_plain(st, mags, gf, band)
            same = all(chip_smoke.same_bits_nan(a, b) for a, b in
                       zip((got[1], *got[0]), (want[1], *want[0])))
            counts = dict(zip(names, (int(x) for x in buf)))
            emit({"counts": label, "case": name, "bitwise_to_plain": same,
                  **counts,
                  "dividing_share": counts["divisions"]
                  / max(1, counts["steps"]),
                  "warp_frames_dividing_share": counts["warp_frames_dividing"]
                  / max(1, counts["warp_frames"])})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


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

    texts = {k: (REPO / v).read_text()
             for k, v in (s.split("=", 1) for s in args.source)}
    full = list(texts)
    for spec in args.probe:
        label, name = spec.split(":")
        texts[f"{label}-{name}"] = probe_source(texts[label], name)
    if args.kernel == "k5":
        return k5_main(args, texts)
    return k4_main(args, texts, full)


def k4_main(args, texts: dict, full: list) -> int:
    """K4's turns: each build held bitwise to the plain scan, then timed in
    turns; cycles a frame and the resident blocks a SM at 129 bins."""
    import torch
    import chip_smoke
    from audio_analyzer_rs_tpu_torch import _build
    from audio_analyzer_rs_tpu_torch.ops import hopper_onset, onset
    dev = torch.device("cuda")
    cases = k4_cases(dev, args.data)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def call(st, x):
        return hopper_onset.onset_scan(st, *x)

    def plain(st, x):
        return onset.onset_scan_plain(st, *x)
    torch.cuda.synchronize()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(*kv),
                                         texts.items())))
    libs, queried = {}, {}
    for k, (path, _) in built.items():
        libs[k] = load(path, "aat_onset_scan")
        queried[k] = hasattr(libs[k], "aat_onset_blocks_per_sm")
        if queried[k]:
            fn = libs[k].aat_onset_blocks_per_sm
            fn.argtypes = _build._SIGNATURES["aat_onset_blocks_per_sm"]
            fn.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lines = [{"card": card, "kernel": args.kernel, "data": args.data,
              "sms": sms}]
    lines += [info for _, info in built.values()]

    def run_with(label, fn):
        _build._lib = libs[label]
        hopper_onset.RESIDENT.clear()
        if not queried[label]:          # a build without the query
            hopper_onset.RESIDENT[onset.HALF] = None
        try:
            return fn()
        finally:
            _build._lib = None
            hopper_onset.RESIDENT.clear()

    resident = {label: run_with(label, lambda: hopper_onset.resident_blocks(
        onset.HALF)) for label in libs}
    lines += [{"label": k, "resident_blocks_per_sm_h129": v}
              for k, v in resident.items()]

    def flat(r):
        return [t for part in r for t in
                (part if isinstance(part, tuple) else (part,))]
    for check in [c for c in cases if c.startswith("check")]:
        st, x = cases.pop(check)
        want = plain(st, x)
        for label in full:
            got = run_with(label, lambda: call(st, x))
            torch.cuda.synchronize()
            same = all(chip_smoke.same_bits(a, b)
                       for a, b in zip(flat(got), flat(want)))
            lines.append({"check": label, "shape": check,
                          "bitwise_to_plain": same})
            if not same:
                print(json.dumps(lines[-1]))
                return 1

    times = {k: {c: [] for c in cases} for k in libs}
    with chip_smoke.SmClock() as clock:
        for r in range(args.rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for label in order:
                for name, (st, x) in cases.items():
                    t = run_with(label, lambda: chip_smoke.cuda_times(
                        lambda: call(st, x), chip_smoke.KERNEL_REPS))
                    times[label][name].extend(t)
                    lines.append({"turn": r, "label": label, "shape": name,
                                  "ms": statistics.median(t)})
    frames = chip_smoke.FULL_ONSET_FRAMES
    for label, by_shape in times.items():
        ms = {k: statistics.median(v) for k, v in by_shape.items()}
        row = {"label": label, **{f"ms_{k}": v for k, v in ms.items()}}
        slope = (ms["s128_n4096"] - ms["s128_n1024"]) / 3072 * 1e6
        row["per_frame_cycles_s128"] = slope * clock.mhz / 1e3
        row["per_frame_cycles_s1"] = (ms["s1_n131072"] / 131072 * 1e6
                                      * clock.mhz / 1e3)
        for s in (128, 2048):
            row[f"per_frame_cycles_s{s}_n{frames}"] = (
                ms[f"s{s}_n{frames}"] / frames * 1e6 * clock.mhz / 1e3)
        # A round: the blocks that run at once, SMs x the resident blocks a
        # SM (one for a build without the query: 139,776 B of shared
        # memory a block at 129 bins).
        rounds = -(-2048 // (sms * (resident[label] or 1)))
        row["rounds_s2048"] = rounds
        row["per_frame_cycles_a_round_s2048"] = (
            row[f"per_frame_cycles_s2048_n{frames}"] / rounds)
        lines.append({**row, "sm_mhz": clock.mhz, "card": card})
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
