#!/usr/bin/env python3
"""The pipelined feed's host gather on one thread against the same gather
split over 2, 4 and 8 worker threads, on one GPU.

    python3 port_tools/gather_threads.py [--reps 7]

`segmented_pitch_analysis(transfer="pipelined")` over the 30-minute
`mixed_scene(seed=0)` recording chip_smoke.py uses, with
`models/segmented.py` `_gather_block` replaced by each variant in turns
(each round in the other order), every output bitwise to the resident
run; then the 21 gathers of that call alone into a page-locked [128,
34,304] buffer.  Prints, per variant, the wall's median, min and max and
the gathers' median ms and GB/s, and the host's CPU count.  Nothing in the
package changes.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SR = 44100.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    if not torch.cuda.is_available():
        print("gather_threads: no CUDA device", file=sys.stderr)
        return 1
    audio = gen.mixed_scene(1800.0, SR, seed=0)
    one_thread = segmented._gather_block

    def threaded(n: int):
        pool = ThreadPoolExecutor(n)

        def gather(host, audio, starts, offset):
            parts = [p for p in np.array_split(np.arange(len(starts)), n)
                     if len(p)]
            for f in [pool.submit(one_thread, host[p[0]:p[-1] + 1], audio,
                                  starts[p[0]:p[-1] + 1], offset)
                      for p in parts]:
                f.result()
        return gather

    variants = {1: one_thread, 2: threaded(2), 4: threaded(4),
                8: threaded(8)}
    want = segmented.segmented_pitch_analysis(audio, SR, transfer="resident")
    plan = segmented._plan_streams(
        segmented.num_frames(len(audio), 2048, 512), 128, 128, 64, 2048, 512)
    host = torch.empty((128, plan.chunk_samples), pin_memory=True).numpy()
    starts = plan.stream_start * 512
    walls = {k: [] for k in variants}
    gathers = {k: [] for k in variants}
    order = list(variants.items())
    try:
        for rep in range(args.reps):
            for k, fn in (order if rep % 2 == 0 else order[::-1]):
                segmented._gather_block = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = segmented.segmented_pitch_analysis(
                    audio, SR, transfer="pipelined")
                walls[k].append(time.perf_counter() - t0)
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
                t0 = time.perf_counter()
                for step in range(plan.steps):
                    fn(host, audio, starts, step * 64 * 512)
                gathers[k].append(time.perf_counter() - t0)
    finally:
        segmented._gather_block = one_thread
    for k in variants:
        g = statistics.median(gathers[k])
        print(f"threads {k}: 30-min pipelined wall median "
              f"{statistics.median(walls[k]):.4f} s (min {min(walls[k]):.4f}"
              f", max {max(walls[k]):.4f}); {plan.steps} gathers alone "
              f"{g * 1e3:.1f} ms ({plan.steps * host.nbytes / g / 1e9:.2f} "
              f"GB/s)")
    print(f"cpus {os.cpu_count()}; {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
