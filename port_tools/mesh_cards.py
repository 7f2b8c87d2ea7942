#!/usr/bin/env python3
"""The mesh across cards: the port's data-parallel paths on N GPUs, one
NCCL rank a card, against one card in the same call.

    python3 port_tools/mesh_cards.py [--ranks 4]
    python3 port_tools/mesh_cards.py --device cpu --ranks 4 --minutes 0.5 \\
        --streams 8 --slots 24 --lanes 8     # a rehearsal on gloo

Each rank (spawned by `parallel.dryrun.run_world`, rank r on card r) builds
the same scene, `mixed_scene(minutes, 44.1 kHz, seed=0)`, then:
  1. `segmented_pitch_analysis(mesh=...)` over it (default geometry,
     segments shared over the ranks), cold then warm, the host clock
     around the call after a barrier; rank 0 first runs it mesh-free on
     its card, and the mesh's result (the same all-gathered arrays on
     every rank) must equal that bit for bit;
  2. `make_batched_full_step(mesh, 48000.0)` over `--streams` streams
     (windows of the scene, as chip_smoke.py phase 12 makes its fleet),
     each rank its share, `--steps` chunks of `--slots` slots chained:
     the host ms a warm step (each step ends in the fleet all-reduce and a
     synchronize) against rank 0's mesh-free step over all streams; then
     one step from fresh states, all-gathered and held bit for bit to the
     mesh-free step's;
  3. the pooled wave (`make_pooled_wave_step`), `--lanes` lanes x 3 waves,
     bitwise to the one-card pool step (`dryrun.pooled_wave_check`).
Prints each card's name and power limit, one JSON object of results, and
exits 1 if a bitwise gate fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SR, FULL_SR = 44100.0, 48000.0
STREAM_STRIDE = 600_000          # a stream's window into the scene (phase 12)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bits_equal(a, b) -> bool:
    """Bit for bit, NaNs compared by position."""
    import torch
    if not a.is_floating_point():
        return torch.equal(a, b)
    an, bn = torch.isnan(a), torch.isnan(b)
    return (torch.equal(an, bn) and torch.equal(
        torch.where(an, 0, a.view(torch.int32)),
        torch.where(bn, 0, b.view(torch.int32))))


def rank_main(rank: int, world: int, args: dict) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from audio_analyzer_rs_tpu_torch.models import generators as gen
    from audio_analyzer_rs_tpu_torch.models import segmented
    from audio_analyzer_rs_tpu_torch.parallel import dryrun, sharding
    from audio_analyzer_rs_tpu_torch.parallel import mesh as pmesh
    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    mesh = pmesh.make_mesh(device)
    sh = pmesh.batch_sharding(mesh)
    out = {"rank": rank}
    audio = gen.mixed_scene(args["minutes"] * 60.0, SR, seed=0)

    # 1. The segmented pitch path.
    if rank == 0:
        segmented.segmented_pitch_analysis(audio, SR, device=dev)
        t0 = time.perf_counter()
        ref = segmented.segmented_pitch_analysis(audio, SR, device=dev)
        out["pitch_one_card_s"] = time.perf_counter() - t0
    dist.barrier()
    times = []
    for _ in range(2):
        dist.barrier()
        t0 = time.perf_counter()
        got = segmented.segmented_pitch_analysis(audio, SR, mesh=mesh,
                                                 device=dev)
        times.append(time.perf_counter() - t0)
    out["pitch_mesh_cold_s"], out["pitch_mesh_warm_s"] = times
    out["frames"] = int(got[0].shape[0])
    if rank == 0:
        out["pitch_bitwise"] = all(np.array_equal(a, b)
                                   for a, b in zip(got, ref))
    del got

    # 2. The full step.
    t_chunk = args["slots"] * 1024
    span = args["steps"] * t_chunk
    b = args["streams"]
    stride = min(STREAM_STRIDE, (len(audio) - span) // max(b - 1, 1))
    if stride < 0:
        raise ValueError("the scene is too short for the fleet")
    fleet = np.stack([audio[k * stride:k * stride + span]
                      for k in range(b)])
    chunks = [torch.from_numpy(np.ascontiguousarray(
        fleet[:, k * t_chunk:(k + 1) * t_chunk])).to(dev)
        for k in range(args["steps"])]

    def run(m, label):
        step = sharding.make_batched_full_step(m, FULL_SR, device=dev)
        st = sharding.init_stream_states(b, device=dev)
        xs = chunks
        if m is not None:
            st, xs = sh.shard(st), [sh.shard(x) for x in chunks]
        step(st, xs[0])                       # warm
        _sync(dev)
        ms = []
        for x in xs:
            t0 = time.perf_counter()
            st, o = step(st, x)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"step_{label}_ms"] = ms
        return step

    if rank == 0:
        one = run(None, "one_card")
    dist.barrier()
    step = run(mesh, "mesh")
    _, o = step(sh.shard(sharding.init_stream_states(b, device=dev)),
                sh.shard(chunks[0]))
    gathered = sh.gather(tuple(o[:5]))
    if rank == 0:
        _, r = one(sharding.init_stream_states(b, device=dev), chunks[0])
        out["step_bitwise"] = all(
            _bits_equal(x, y) for x, y in zip(gathered, r[:5]))
    del chunks, fleet

    # 3. The pooled wave.
    out["pool"] = dryrun.pooled_wave_check(mesh, args["lanes"], 3, seed=5,
                                           device=device)
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def main() -> int:
    sys.path.insert(0, str(REPO))
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--slots", type=int, default=468)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    import torch
    from audio_analyzer_rs_tpu_torch.parallel import dryrun
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"mesh_cards: {args.ranks} ranks need as many cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    t0 = time.perf_counter()
    ranks = dryrun.run_world(
        rank_main, args.ranks, vars(args),
        backend="nccl" if args.device == "cuda" else "gloo",
        timeout=args.timeout)
    r0 = ranks[0]
    gates = {
        "pitch_bitwise": r0["pitch_bitwise"],
        "step_bitwise": r0["step_bitwise"],
        "pool_bitwise": all(r["pool"]["lanes"] == args.lanes // args.ranks
                            for r in ranks),
    }
    secs = args.slots * 1024 / FULL_SR
    result = {
        "ranks": args.ranks, "device": args.device,
        "cards": [r.get("card") for r in ranks],
        "wall_s": time.perf_counter() - t0,
        "frames": r0["frames"],
        "pitch_one_card_s": r0["pitch_one_card_s"],
        "pitch_mesh_warm_s": [r["pitch_mesh_warm_s"] for r in ranks],
        "pitch_mesh_cold_s": r0["pitch_mesh_cold_s"],
        "step_one_card_ms": r0["step_one_card_ms"],
        "step_mesh_ms": [r["step_mesh_ms"] for r in ranks],
        "audio_s_per_wall_s_one_card": args.streams * secs / (
            sorted(r0["step_one_card_ms"])[len(r0["step_one_card_ms"]) // 2]
            / 1e3),
        "audio_s_per_wall_s_mesh": args.streams * secs / (
            sorted(r0["step_mesh_ms"])[len(r0["step_mesh_ms"]) // 2] / 1e3),
        "gates": gates,
    }
    print(json.dumps(result))
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
