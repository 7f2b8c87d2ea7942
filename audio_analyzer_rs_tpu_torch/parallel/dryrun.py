"""The multichip dry run of the port (twin of the JAX package's
`__graft_entry__.dryrun_multichip`), and `run_world`, which runs a function
on every rank of a process group of its own.

    python -m audio_analyzer_rs_tpu_torch.parallel.dryrun 4

JAX validates its mesh on an n-device virtual CPU mesh in one process;
torch.distributed is one process a rank, so the dry run spawns n processes
with the gloo backend on the CPU (a `FileStore` in a fresh directory, one
thread each), and each rank runs:
  - the full step (`make_batched_full_step`) over 2 streams a rank x 36,864
    samples, 3 steps chained with the states carried; the fleet statistics
    are all-reduced, so every rank must see the same ones;
  - the pooled wave (`make_pooled_wave_step`): 2 lanes a rank x 3 chained
    waves, held bit for bit, carries and packed outputs, to the single-
    process pool step over all 2n lanes, which each rank also runs.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 300.0


def _rank_main(rank: int, world: int, workdir: str, backend: str, fn,
               args) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(workdir) / f"rank{rank}.pkl"
    try:
        store = dist.FileStore(str(Path(workdir) / "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            result = {"ok": fn(rank, world, *args)}
        finally:
            dist.destroy_process_group()
    except Exception:
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_world(fn, world: int, *args, backend: str = "gloo",
              workdir: str | None = None,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """fn(rank, world, *args) on each of `world` spawned processes joined in
    one process group (`backend`, a FileStore under `workdir`, a fresh
    temporary directory by default) → the ranks' results, in rank order.
    `fn` must be importable by name (a module-level function).  Raises
    with the rank's traceback if a rank fails, and TimeoutError if the
    ranks have not all ended within `timeout` seconds (the rest are then
    killed); the process group is destroyed on every path."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, backend, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"run_world: {fn.__name__} on {world} "
                                   f"ranks did not end in {timeout:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pkl"
            if not path.exists():
                raise RuntimeError(f"run_world: rank {r} exited with code "
                                   f"{p.exitcode} and no result")
            with open(path, "rb") as f:
                res = pickle.load(f)
            if "error" in res:
                raise RuntimeError(f"run_world: rank {r} failed:\n"
                                   f"{res['error']}")
            results.append(res["ok"])
        return results


SAMPLE_RATE = 48000.0
STREAMS_A_RANK = 2
CHUNK = 36864                # 69 pitch and 572 onset frames a step
FULL_STEPS = 3
LANES_A_RANK = 2
WAVES = 3
SLOT = 1024


def pool_wave_inputs(lanes: int, waves: int, seed: int, device="cpu"):
    """Fresh carries for `lanes` engines at the steady ring-tail geometry
    (random tails) and `waves` waves of host rows: (per-engine carries,
    [waves] x [lanes, L] host rows, p_tail_len, o_tail_len)."""
    from ..models.analyzer import PoolCarries
    from ..ops import noisefloor, onset as onset_ops, tracker
    from ..ops.stft import ONSET_HOP, ONSET_WINDOW, PITCH_HOP, PITCH_WINDOW
    from ..utils.framing import num_frames
    p_len, o_len = PITCH_WINDOW - PITCH_HOP, 192
    n_o = num_frames(o_len + SLOT, ONSET_WINDOW, ONSET_HOP)
    rng = np.random.default_rng(seed)

    def tail(n):
        return torch.from_numpy((rng.standard_normal(n) * 0.1)
                                .astype(np.float32)).to(device)
    states = [PoolCarries(
        noisefloor.init_state(PITCH_WINDOW // 2 + 1, device, (1,)),
        tracker.init_state(device, (1,)),
        onset_ops.init_state(ONSET_WINDOW // 2 + 1, device, (1,)),
        torch.zeros(1, dtype=torch.bool, device=device), tail(p_len),
        tail(o_len)) for _ in range(lanes)]
    rows = [np.stack([np.concatenate([
        (rng.standard_normal(SLOT) * 0.1).astype(np.float32),
        np.asarray([1e-3, 1e-3, 0.0], np.float32),
        np.zeros(n_o, np.float32)]) for _ in range(lanes)])
        for _ in range(waves)]
    return states, rows, p_len, o_len


def pooled_wave_check(mesh, lanes: int, waves: int, seed: int,
                      device="cpu") -> dict:
    """The pooled wave with `lanes` lanes shared over `mesh`, `waves` waves
    chained, against the single-card pool step over all lanes (run here
    too): every lane's packed outputs and carries bit for bit.  Returns
    counts for the caller's report; raises on a difference."""
    from ..models import analyzer
    from .mesh import batch_sharding
    from .sharding import make_pooled_wave_step
    states, rows, p_len, o_len = pool_wave_inputs(lanes, waves, seed, device)
    counts = analyzer.slot_frame_counts(SLOT, 1, p_len, o_len)
    place, step = make_pooled_wave_step(mesh, SAMPLE_RATE, SLOT,
                                        device=device)
    lo, hi = batch_sharding(mesh).bounds(lanes)
    stacked, _ = place(analyzer.stack_carries(states), None)
    ref = states
    for w, host in enumerate(rows):
        ref, ref_packed = analyzer.fused_slot_pool_step(
            ref, torch.from_numpy(host).to(device), SAMPLE_RATE, SLOT, 1)
        _, local = place(None, host)
        stacked, packed = step(stacked, local, p_len, o_len)
        want = analyzer.unpack_fused_pool_out(ref_packed.cpu().numpy(),
                                              lanes, counts)[0][lo:hi]
        got = analyzer.unpack_fused_pool_out(packed.cpu().numpy(), hi - lo,
                                             counts)[0]
        for k, (a, b) in enumerate(zip(want, got)):
            for x, y in zip((*a[:3], *a.onset), (*b[:3], *b.onset)):
                if not np.array_equal(np.asarray(x).view(np.uint8),
                                      np.asarray(y).view(np.uint8)):
                    raise AssertionError(f"pooled wave {w}, lane {lo + k}: "
                                         "outputs differ")
    ref_stacked = analyzer.stack_carries(ref)
    for a, b in zip(_leaves(ref_stacked), _leaves(stacked)):
        if not torch.equal(_bits(a[lo:hi]), _bits(b)):
            raise AssertionError("pooled wave: carries differ")
    return {"lanes": hi - lo, "waves": waves}


def _leaves(tree):
    for part in tree:
        if isinstance(part, tuple):
            yield from _leaves(part)
        else:
            yield part


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _dryrun_rank(rank: int, world: int) -> dict:
    from .mesh import batch_sharding, make_mesh
    from .sharding import init_stream_states, make_batched_full_step
    mesh = make_mesh("cpu")
    batch = STREAMS_A_RANK * world
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((batch, CHUNK)) * 0.1).astype(np.float32)
    sharding = batch_sharding(mesh)
    local = sharding.shard(torch.from_numpy(audio))
    step = make_batched_full_step(mesh, SAMPLE_RATE, slot_len=SLOT,
                                  device="cpu")
    states = sharding.shard(init_stream_states(batch, device="cpu"))
    for _ in range(FULL_STEPS):
        states, out = step(states, local)
    assert out.stable_freqs.shape[0] == STREAMS_A_RANK
    assert bool(torch.isfinite(out.global_noise_floor_db))
    pool = pooled_wave_check(mesh, LANES_A_RANK * world, WAVES, seed=4)
    return {"floor_db": float(out.global_noise_floor_db),
            "onsets": int(out.global_onset_count), **pool}


def dryrun_multichip(n_ranks: int) -> None:
    """The mesh over `n_ranks` gloo processes on the CPU: the full step (2
    streams a rank, 3 chained steps, the fleet statistics equal on every
    rank) and the pooled wave (2 lanes a rank, 3 waves) bitwise to one
    process.  Raises on any failure."""
    results = run_world(_dryrun_rank, n_ranks)
    stats = {(r["floor_db"], r["onsets"]) for r in results}
    if len(stats) != 1:
        raise AssertionError(f"the ranks' fleet statistics differ: {stats}")
    (floor_db, onsets), = stats
    print(f"dryrun_multichip full-step OK: {n_ranks} ranks, batch "
          f"{STREAMS_A_RANK * n_ranks}, {CHUNK} samples/step x "
          f"{FULL_STEPS} steps, global_noise_floor_db={floor_db:.1f}, "
          f"global_onsets={onsets}")
    print(f"dryrun_multichip pool OK: {LANES_A_RANK * n_ranks} live "
          f"sessions' slot waves shared across {n_ranks} ranks x {WAVES} "
          "chained waves == single-process pool step bitwise")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else os.cpu_count() or 1)
