"""Segment-parallel offline pitch and onset analysis of one long recording
(port of audio_analyzer_rs_tpu/models/segmented.py).

The recording is split into S contiguous segments analyzed together as one
[S, ...] batch of scan streams; every segment except the first warms its
state (noise floor and tracker, or the onset floors and EMAs) on
`warmup_frames` of look-back audio whose outputs are discarded (see the JAX
module for the sweeps that set the defaults).  Segment 0 starts from the
fresh state, so its outputs equal the sequential `PitchAnalyzer` or
`OnsetAnalyzer` run; for pitch on CUDA bitwise so, because kernel K1's
reduction order does not depend on the batch geometry.

Two host-to-device feeds give the same bits.  "resident": the recording
is padded on the host, uploaded once and sliced on the device, or the
caller passes it already on the device (`device_audio`, which
`analysis.analyze_buffer_segmented` shares between its passes).
"pipelined" (`_pipelined_blocks`): each step's [S, chunk] block is gathered
on the host into one of two page-locked staging buffers (int16 stays
int16) and copied on a CUDA stream of its own while the card computes the
step before, so the first kernel starts after one block and the host
never copies the whole recording.  "auto" picks by the crossover measured
on the card (`AUTO_PIPELINED_MIN_SECONDS`).

With `mesh` (a 1-D DeviceMesh from `parallel.mesh.make_mesh`) every rank
of the mesh calls the entry point with the same arguments; the segment (or
flat recording x segment) axis is snapped (or padded) to a multiple of the
mesh's size, each rank runs its contiguous share of the rows, and the
per-frame results are all-gathered in row order, so every rank returns
what `mesh=None` returns.  A row's results do not depend on the rows
beside it (K1 sums a frame in a fixed order; every other stage is per
row), so the two are bitwise equal on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import noisefloor, onset as onset_ops, tracker
from ..ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                        PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW)
from ..utils.framing import frame_signal, num_frames
from .analyzer import (floor_warmup_frames, onset_analyze_frames,
                       pitch_extract_frames)

DEFAULT_WARMUP_FRAMES = 128
# Onset state converges much faster than the pitch floor (EMA memories
# 0.84-0.95, rise-once burst floors) and frames are short (hop 64); the JAX
# package's sweep found 128 frames give identical onset sets over 1 h.
DEFAULT_ONSET_WARMUP_FRAMES = 128

# transfer="auto": the shortest recording at which the pipelined pitch
# path's warm wall beats the resident one's by more than the two walls'
# spread (max - min of 3 calls each, in turns), measured by chip_smoke.py
# phase 4 on mixed_scene(seed=0) at 44.1 kHz, float32 input, on NVIDIA
# H100 80GB HBM3, 700.00 W: resident / pipelined medians 0.066 / 0.068 s
# at 5 min (a tie), 0.098 / 0.047 s at 10, 0.215 / 0.115 s at 30 and
# 0.412 / 0.235 s at 60.  Resident pays a padded host copy of the whole
# recording and a pageable upload (6.4 GB/s) before its first kernel;
# pipelined gathers a block at a time into page-locked buffers (copied
# at 54 GB/s).  Onsets resolve to resident, as in the JAX package.
AUTO_PIPELINED_MIN_SECONDS = 600.0

_TRANSFER_MODES = ("auto", "resident", "pipelined")


def _resolve_transfer(transfer: str, kind: str, n_samples: int,
                      sample_rate: float, device_audio) -> str:
    """transfer="auto" → "resident" or "pipelined" (see
    AUTO_PIPELINED_MIN_SECONDS); `kind` is "pitch" or "onset"."""
    if transfer not in _TRANSFER_MODES:
        raise ValueError(
            f"transfer={transfer!r}: expected one of {_TRANSFER_MODES}")
    if transfer != "auto":
        return transfer
    if device_audio is not None or kind == "onset":
        return "resident"
    long_enough = n_samples >= AUTO_PIPELINED_MIN_SECONDS * sample_rate
    return "pipelined" if long_enough else "resident"


class LeanPitchOut(NamedTuple):
    """Per-step outputs the segmented path consumes."""
    stable_freqs: torch.Tensor   # [S, chunk, 8]
    stable_scores: torch.Tensor  # [S, chunk, 8]
    stable_valid: torch.Tensor   # [S, chunk, 8]


def _chunks_to_f32(audio_chunks: torch.Tensor) -> torch.Tensor:
    """int16 converts on the device by the exact power-of-two scale; float32
    passes through."""
    if audio_chunks.dtype == torch.int16:
        return audio_chunks.float() * (1.0 / 32768.0)
    return audio_chunks


def _vmapped_step(nf_states, tr_states, audio_chunks, global_floor, onsets,
                  sample_rate: float, window: int, hop: int,
                  backend: str = PITCH_BACKEND):
    """One step of S streams: audio_chunks [S, chunk_samples] (float32 or
    int16) → (nf_states, tr_states, LeanPitchOut [S, chunk, 8])."""
    frames = frame_signal(_chunks_to_f32(audio_chunks), window, hop)
    nf_states, pf, _, _ = pitch_extract_frames(nf_states, frames,
                                               global_floor, sample_rate,
                                               window, hop, backend)
    tr_states, (sf, ss, sv) = tracker.tracker_scan_batched(
        tr_states, pf.freqs, pf.scores, pf.valid, onsets)
    return nf_states, tr_states, LeanPitchOut(sf, ss, sv)


def _as_host_audio(audio) -> np.ndarray:
    """float32 passthrough; int16 kept raw for the half-size upload."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    return audio


def _upload_f32(padded: np.ndarray, device) -> torch.Tensor:
    """Host audio → float32 device tensor; int16 uploads raw and converts on
    the device (x / 32768 is exact, so results equal a host conversion)."""
    return _chunks_to_f32(torch.from_numpy(np.ascontiguousarray(padded))
                          .to(device))


def _padded_audio(audio: np.ndarray, max_sample: int, device,
                  device_audio) -> torch.Tensor:
    """The recording as float32 on the device, zero-padded to max_sample:
    uploaded from the host, or `device_audio` (float32, len(audio) samples,
    already on a device of `device`'s type) padded there."""
    pad = max(0, max_sample - len(audio))
    if device_audio is None:
        return _upload_f32(np.pad(audio, (0, pad)), device)
    if (device_audio.dtype != torch.float32 or device_audio.dim() != 1
            or device_audio.shape[0] != len(audio)):
        raise ValueError(
            f"device_audio must be float32 [{len(audio)}], got "
            f"{device_audio.dtype} {tuple(device_audio.shape)}")
    if device_audio.device.type != torch.device(device).type:
        raise ValueError(f"device_audio is on {device_audio.device}, the "
                         f"analysis on {device}")
    return torch.nn.functional.pad(device_audio, (0, pad))


def _snap_to_mesh(segments: int, mesh) -> int:
    """Sharding needs the segment axis divisible by the mesh; snap down
    (at minimum one segment a rank)."""
    if mesh is None:
        return segments
    size = mesh.size()
    return max((segments // size) * size, size)


def _shard_batch(tree, mesh):
    """This rank's share of every leaf's leading (row) axis."""
    if mesh is None:
        return tree
    from ..parallel.mesh import batch_sharding
    return batch_sharding(mesh).shard(tree)


def _gather_rows(tree, mesh):
    """The ranks' rows of every tensor leaf put back together in row order,
    on every rank."""
    if mesh is None:
        return tree
    from ..parallel.mesh import batch_sharding
    return batch_sharding(mesh).gather(tree)


def _check_mesh(mesh, device) -> None:
    if mesh is not None:
        from ..parallel.mesh import check_mesh
        check_mesh(mesh, device)


def _slice_streams(audio_dev: torch.Tensor, stream_starts: np.ndarray,
                   stream_samples: int) -> torch.Tensor:
    """[S] sample offsets into the padded recording → [S, stream_samples]."""
    return torch.stack([audio_dev[int(s):int(s) + stream_samples]
                        for s in stream_starts])


def _resident_blocks(seg_streams: torch.Tensor, steps: int,
                     step_samples: int, chunk_samples: int):
    """Each step's [S, chunk_samples] block of the device-resident streams:
    a view, which kernel K1 reads in place."""
    for step in range(steps):
        off = step * step_samples
        yield seg_streams[:, off:off + chunk_samples]


def _gather_block(host: np.ndarray, audio: np.ndarray, starts: np.ndarray,
                  offset: int) -> None:
    """host[r] = audio[starts[r] + offset:][:chunk], zero past the end (the
    bits of the resident path's padding)."""
    chunk = host.shape[1]
    for r, s in enumerate(starts):
        o = int(s) + offset
        n = max(0, min(chunk, len(audio) - o))
        host[r, :n] = audio[o:o + n]
        host[r, n:] = 0


def _pipelined_blocks(audio: np.ndarray, starts: np.ndarray, steps: int,
                      step_samples: int, chunk_samples: int, device):
    """Double-buffered host→device feed: yields each step's [rows,
    chunk_samples] block on `device` (float32 or int16, as `audio`) while
    the next block's copy is in flight.

    On CUDA two page-locked staging buffers are allocated once a call; the
    host gathers block k + 1 straight from `audio` into the free one (no
    padded copy of the recording) and copies it with non_blocking=True on
    a stream of its own, an event behind the copy.  The compute stream
    waits on that event (`wait_event`), never the host; the host waits
    only before refilling a buffer, on the event behind the copy out of it
    two blocks back.  A device block is made on the copy stream and marked
    used by the compute stream (`record_stream`), so the caching allocator
    does not hand its memory out before the step that read it has run.
    On the CPU the same schedule runs with plain tensors."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = torch.from_numpy(audio[:0]).dtype
    staging = [torch.empty((len(starts), chunk_samples), dtype=dtype,
                           pin_memory=cuda) for _ in range(min(steps, 2))]
    copied = [None] * len(staging)   # the event behind each buffer's copy
    if cuda:
        copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)

    def put(k: int):
        i = k % len(staging)
        if copied[i] is not None:
            copied[i].synchronize()
        _gather_block(staging[i].numpy(), audio, starts, k * step_samples)
        if not cuda:
            return staging[i].clone()
        with torch.cuda.stream(copy_stream):
            block = staging[i].to(dev, non_blocking=True)
            copied[i] = torch.cuda.Event()
            copied[i].record(copy_stream)
        block.record_stream(compute)
        return block, copied[i]

    pending = put(0)
    for k in range(steps):
        nxt = put(k + 1) if k + 1 < steps else None
        if cuda:
            block, ready = pending
            compute.wait_event(ready)
        else:
            block = pending
        yield block
        pending = nxt


def _feed(audio: np.ndarray, plan: _StreamPlan, chunk_frames: int, hop: int,
          transfer: str, device, device_audio, mesh):
    """This rank's rows of the streams as per-step device blocks, by the
    resolved `transfer` → (blocks, rows, device)."""
    starts = _shard_batch(plan.stream_start * hop, mesh)
    step_samples = chunk_frames * hop
    if transfer == "pipelined" and device_audio is None:
        dev = torch.device(device)
        return (_pipelined_blocks(audio, starts, plan.steps, step_samples,
                                  plan.chunk_samples, dev), len(starts), dev)
    audio_dev = _padded_audio(audio, plan.max_sample, device, device_audio)
    seg_streams = _slice_streams(audio_dev, starts, plan.stream_samples)
    return (_resident_blocks(seg_streams, plan.steps, step_samples,
                             plan.chunk_samples), len(starts),
            seg_streams.device)


class _StreamPlan(NamedTuple):
    """Warmup-overlap stream geometry (see the JAX module): every stream is
    warmup + payload frames; segment 0 owns its whole stream, segment s >= 1
    owns [stream_len + (s-1)*payload, stream_len + s*payload)."""
    segments: int
    warmup_frames: int
    payload: int
    stream_len: int
    steps: int
    stream_start: np.ndarray   # [S] stream start offsets, in frames
    chunk_samples: int
    stream_samples: int
    max_sample: int

    def payload_range(self, s: int, n_total: int) -> tuple[int, int]:
        if s == 0:
            return 0, min(self.stream_len, n_total)
        lo = self.stream_len + (s - 1) * self.payload
        return lo, min(lo + self.payload, n_total)


def _plan_streams(n_total: int, segments: int, warmup_frames: int,
                  chunk_frames: int, window: int, hop: int) -> _StreamPlan:
    payload = -(-max(n_total - warmup_frames, 1) // segments)
    payload = -(-payload // chunk_frames) * chunk_frames
    stream_len = warmup_frames + payload
    steps = -(-stream_len // chunk_frames)
    stream_start = np.array(
        [0] + [stream_len + (s - 1) * payload - warmup_frames
               for s in range(1, segments)])
    if (stream_start < 0).any():
        raise ValueError("negative stream start")
    chunk_samples = (chunk_frames - 1) * hop + window
    stream_samples = (steps - 1) * chunk_frames * hop + chunk_samples
    max_sample = int(stream_start.max()) * hop + stream_samples
    return _StreamPlan(segments, warmup_frames, payload, stream_len, steps,
                       stream_start, chunk_samples, stream_samples,
                       max_sample)


def auto_segments(n_total: int, warmup_frames: int, cap: int = 128) -> int:
    """Segment count for n_total frames: each segment's payload near >= 10x
    the discarded warmup, snapped to a power of two, capped at `cap`."""
    ideal = min(cap, n_total // (warmup_frames * 10))
    if ideal <= 1:
        return 1
    lower = 1 << (ideal.bit_length() - 1)
    upper = min(lower * 2, cap)
    return upper if ideal >= lower + lower // 2 else lower


def _run_streams(blocks, rows: int, dev, plan: _StreamPlan,
                 chunk_frames: int, sample_rate: float, window: int,
                 hop: int, backend: str, gf_lin: float, mesh=None):
    """All steps over the per-step [rows, chunk_samples] `blocks` from fresh
    states; one readback at the end → three arrays [rows, steps*chunk, 8].
    With `mesh` the blocks are this rank's rows and the arrays all ranks'."""
    nf_states = noisefloor.init_state(window // 2 + 1, dev, (rows,))
    tr_states = tracker.init_state(dev, (rows,))
    gf = torch.full((rows, chunk_frames), gf_lin, dtype=torch.float32,
                    device=dev)
    onsets = torch.zeros((rows, chunk_frames), dtype=torch.bool, device=dev)
    step_outs = []
    for block in blocks:
        nf_states, tr_states, out = _vmapped_step(
            nf_states, tr_states, block, gf, onsets, sample_rate, window,
            hop, backend)
        step_outs.append(out)
    # [rows, steps, chunk, 8] → each stream contiguous over steps.
    outs = tuple(
        torch.stack([getattr(o, f) for o in step_outs], 1)
        .reshape(rows, plan.steps * chunk_frames, 8)
        for f in LeanPitchOut._fields)
    return tuple(o.cpu().numpy() for o in _gather_rows(outs, mesh))


def _unpack(outs, plan: _StreamPlan, n_total: int, row0: int = 0):
    """Stream outputs → the recording's (freqs, scores, valid) [n_total, 8]."""
    sf, ss, sv = outs
    out_freqs = np.zeros((n_total, 8), np.float32)
    out_scores = np.zeros((n_total, 8), np.float32)
    out_valid = np.zeros((n_total, 8), bool)
    for s in range(plan.segments):
        lo, hi = plan.payload_range(s, n_total)
        if lo >= hi:
            continue
        r = row0 + s
        src = lo - int(plan.stream_start[s])   # warmup offset in the stream
        out_freqs[lo:hi] = sf[r, src:src + (hi - lo)]
        out_scores[lo:hi] = ss[r, src:src + (hi - lo)]
        out_valid[lo:hi] = sv[r, src:src + (hi - lo)]
    return out_freqs, out_scores, out_valid


def _empty():
    return (np.zeros((0, 8), np.float32), np.zeros((0, 8), np.float32),
            np.zeros((0, 8), bool))


def segmented_pitch_analysis(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             warmup_frames: int = DEFAULT_WARMUP_FRAMES,
                             chunk_frames: int = 64,
                             window: int = PITCH_WINDOW,
                             hop: int = PITCH_HOP,
                             backend: str = PITCH_BACKEND,
                             global_floor_db: float = -96.0,
                             mesh=None, device_audio=None,
                             transfer: str = "auto",
                             warmup_mode: str = "full",
                             device: str | torch.device = "cuda"):
    """Analyze one long mono buffer (float32 or int16) with S parallel
    segments on `device`.  Returns numpy (stable_freqs [N, 8],
    stable_scores [N, 8], stable_valid [N, 8]) for all N frames, in order.

    `segments=None` picks the count with `auto_segments`.  `device_audio`:
    the recording already on the device (float32, len(audio) samples), in
    place of an upload.  `mesh`: a 1-D DeviceMesh over which the segments
    are shared (see the module docstring); every rank of it calls with the
    same arguments and gets the whole result.

    `transfer`: "resident" uploads the recording once and slices it on
    the device (and is what `device_audio` runs); "pipelined" feeds each
    step's block through page-locked double buffers on a copy stream, so
    the copies overlap the steps and no padded host copy is made
    (`_pipelined_blocks`); "auto" (default) picks "pipelined" for
    recordings of at least AUTO_PIPELINED_MIN_SECONDS, measured on the
    card.  Both give the same bits.

    `warmup_mode`: "full" (default) runs the complete pipeline on every
    discarded look-back frame; "floor" seeds the noise floor with an
    STFT + floor pass over the look-back and re-warms only the tracker on
    its last TRACKER_REWARM_FRAMES frames (`_segmented_pitch_floor_warmup`;
    gated on frame agreement with "full", not bitwise; resident only)."""
    _check_mesh(mesh, device)
    if warmup_mode not in ("full", "floor"):
        raise ValueError(f"warmup_mode={warmup_mode!r}: expected 'full' or "
                         "'floor'")
    audio = _as_host_audio(audio)
    transfer = _resolve_transfer(transfer, "pitch", len(audio), sample_rate,
                                 device_audio)
    n_total = num_frames(len(audio), window, hop)
    if n_total <= 0:
        return _empty()
    if segments is None:
        segments = auto_segments(n_total, warmup_frames)
    if warmup_mode == "floor":
        return _segmented_pitch_floor_warmup(
            audio, sample_rate, _snap_to_mesh(segments, mesh), warmup_frames,
            chunk_frames, window, hop, backend, global_floor_db, mesh,
            device_audio, n_total, device)
    segments = max(1, min(segments, max(n_total // max(chunk_frames, 1), 1)))
    segments = _snap_to_mesh(segments, mesh)
    plan = _plan_streams(n_total, segments, warmup_frames, chunk_frames,
                         window, hop)
    gf_lin = float(noisefloor.global_floor_linear(global_floor_db,
                                                  window // 2 + 1))
    blocks, rows, dev = _feed(audio, plan, chunk_frames, hop, transfer,
                              device, device_audio, mesh)
    outs = _run_streams(blocks, rows, dev, plan, chunk_frames, sample_rate,
                        window, hop, backend, gf_lin, mesh)
    return _unpack(outs, plan, n_total)


# Tracker re-warmup length for warmup_mode="floor": a fresh tracker state
# converges to the sequential tracker's within ~30 frames (the freq/score
# EMAs forget at 0.6/frame -> 0.6^32 ~ 8e-8 relative; hysteresis absorbs
# the residual).  The floor recurrence, the slow one, is seeded by running
# it over the whole look-back in phase 1, so only the tracker needs these
# full-pipeline frames.
TRACKER_REWARM_FRAMES = 32


def _segmented_pitch_floor_warmup(audio, sample_rate, segments,
                                  warmup_frames, chunk_frames, window, hop,
                                  backend, global_floor_db, mesh,
                                  device_audio, n_total, device):
    """`segmented_pitch_analysis(warmup_mode="floor")`: a two-phase warmup
    that skips the comb on most look-back frames.

      phase 1: the first `warmup_frames - TRACKER_REWARM_FRAMES` look-back
               frames run STFT + floor scan only (the floor state seeded by
               the real recurrence, as "full" converges it);
      phase 2: the remaining TRACKER_REWARM_FRAMES look-back frames plus
               the payload run the full pipeline with a fresh tracker.

    Every segment owns `payload2` frames, with payload2 +
    TRACKER_REWARM_FRAMES a whole number of chunks; segment 0 (no
    look-back) starts its stream at frame 0.  Segments too short for a
    whole look-back, or a single segment, fall back to "full".  Not bitwise
    to "full" (phase 1's floor scan sees the frames in other calls);
    gated on frame agreement.  With `mesh` each rank runs its share of the
    segments (a multiple of the mesh's size) and the outputs are gathered."""
    tw = TRACKER_REWARM_FRAMES
    base = -(-n_total // segments)
    payload2 = -(-(base + tw) // chunk_frames) * chunk_frames - tw
    if payload2 < warmup_frames or segments == 1:
        return segmented_pitch_analysis(
            audio, sample_rate, segments, warmup_frames, chunk_frames,
            window, hop, backend, global_floor_db, mesh, device_audio,
            transfer="resident", warmup_mode="full", device=device)
    steps2 = (tw + payload2) // chunk_frames
    wf = warmup_frames - tw
    starts = np.array([0] + [s * payload2 - tw for s in range(1, segments)])
    warm_starts = np.array([0] + [s * payload2 - warmup_frames
                                  for s in range(1, segments)])
    chunk_samples = (chunk_frames - 1) * hop + window
    stream_samples = (steps2 * chunk_frames - 1) * hop + window
    warm_samples = (wf - 1) * hop + window
    max_sample = int(starts.max()) * hop + stream_samples

    half = window // 2 + 1
    gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
    audio_dev = _padded_audio(audio, max_sample, device, device_audio)
    dev = audio_dev.device
    starts, warm_starts = _shard_batch((starts, warm_starts), mesh)
    rows = len(starts)                      # this rank's segments
    nf_states = noisefloor.init_state(half, dev, (rows,))
    tr_states = tracker.init_state(dev, (rows,))
    gf_warm = torch.full((rows, wf), gf_lin, dtype=torch.float32, device=dev)
    gf = torch.full((rows, chunk_frames), gf_lin, dtype=torch.float32,
                    device=dev)
    onsets = torch.zeros((rows, chunk_frames), dtype=torch.bool, device=dev)
    warm_streams = _slice_streams(audio_dev, warm_starts * hop, warm_samples)
    seg_streams = _slice_streams(audio_dev, starts * hop, stream_samples)

    # Phase 1: floor seeding without the comb; segment 0's row ran on the
    # stream head (it has no look-back) and goes back to the fresh state.
    nf_states = floor_warmup_frames(
        nf_states, frame_signal(_chunks_to_f32(warm_streams), window, hop),
        gf_warm, sample_rate, window, backend)
    if mesh is None or _shard_batch(np.arange(segments), mesh)[0] == 0:
        fresh = noisefloor.init_state(half, dev)
        nf_states = noisefloor.NoiseFloorState(*(
            torch.cat([f[None], a[1:]]) for f, a in zip(fresh, nf_states)))

    # Phase 2: the full pipeline over tw + payload2 frames a segment.
    step_outs = []
    for block in _resident_blocks(seg_streams, steps2, chunk_frames * hop,
                                  chunk_samples):
        nf_states, tr_states, out = _vmapped_step(
            nf_states, tr_states, block, gf, onsets, sample_rate, window,
            hop, backend)
        step_outs.append(out)
    sf, ss, sv = (o.cpu().numpy() for o in _gather_rows(tuple(
        torch.stack([getattr(o, f) for o in step_outs], 1)
        .reshape(rows, steps2 * chunk_frames, 8)
        for f in LeanPitchOut._fields), mesh))

    out_freqs = np.zeros((n_total, 8), np.float32)
    out_scores = np.zeros((n_total, 8), np.float32)
    out_valid = np.zeros((n_total, 8), bool)
    for s in range(segments):
        lo = s * payload2
        hi = min(lo + payload2, n_total)
        if lo >= hi:
            continue
        src = 0 if s == 0 else tw
        out_freqs[lo:hi] = sf[s, src:src + (hi - lo)]
        out_scores[lo:hi] = ss[s, src:src + (hi - lo)]
        out_valid[lo:hi] = sv[s, src:src + (hi - lo)]
    return out_freqs, out_scores, out_valid


# ── Segment-parallel onsets ───────────────────────────────────────────────


class OnsetStreamsOut(NamedTuple):
    """Per-frame onset outputs the segmented path reads back."""
    fired: np.ndarray      # [rows, steps*chunk] bool
    velocity: np.ndarray   # [rows, steps*chunk] float32
    flux: np.ndarray       # [rows, steps*chunk] float32
    energy: np.ndarray     # [rows, steps*chunk] float32


def _vmapped_onset_chunks(states, audio_chunks, global_floor, tick_sup,
                          hold, window: int, backend: str, hop: int):
    """One step of S onset streams: audio_chunks [S, chunk_samples]
    (float32 or int16), framed as a view → (states, OnsetChunkOut [S,
    chunk])."""
    frames = frame_signal(_chunks_to_f32(audio_chunks), window, hop)
    return onset_analyze_frames(states, frames, global_floor, tick_sup, hold,
                                window, backend)


def _run_onset_streams(blocks, rows: int, dev, chunk_frames: int,
                       window: int, hop: int, backend: str, gf_lin: float,
                       mesh=None) -> OnsetStreamsOut:
    """All onset steps over the per-step [rows, chunk_samples] `blocks` from
    fresh states; one readback at the end.  With `mesh` the blocks are this
    rank's rows and the outputs all ranks'."""
    states = onset_ops.init_state(window // 2 + 1, dev, (rows,))
    gf = torch.full((rows, chunk_frames), gf_lin, dtype=torch.float32,
                    device=dev)
    ts = torch.zeros((rows, chunk_frames), dtype=torch.bool, device=dev)
    hold = torch.zeros_like(ts)
    step_outs = []
    for block in blocks:
        states, out = _vmapped_onset_chunks(states, block, gf, ts, hold,
                                            window, backend, hop)
        step_outs.append(out)
    outs = tuple(torch.cat([getattr(o, f) for o in step_outs], 1)
                 for f in OnsetStreamsOut._fields)
    return OnsetStreamsOut(*(o.cpu().numpy()
                             for o in _gather_rows(outs, mesh)))


def _unpack_onsets(outs: OnsetStreamsOut, plan: _StreamPlan, n_total: int,
                   row0: int = 0):
    """Stream outputs → the recording's (fired, velocity, flux, energy)
    [n_total]."""
    result = (np.zeros(n_total, bool), np.zeros(n_total, np.float32),
              np.zeros(n_total, np.float32), np.zeros(n_total, np.float32))
    for s in range(plan.segments):
        lo, hi = plan.payload_range(s, n_total)
        if lo >= hi:
            continue
        src = lo - int(plan.stream_start[s])
        for dst, col in zip(result, outs):
            dst[lo:hi] = col[row0 + s, src:src + (hi - lo)]
    return result


def _empty_onsets():
    z = np.zeros(0, np.float32)
    return np.zeros(0, bool), z, z.copy(), z.copy()


def segmented_onset_analysis(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             warmup_frames: int = DEFAULT_ONSET_WARMUP_FRAMES,
                             chunk_frames: int = 4096,
                             window: int = ONSET_WINDOW,
                             hop: int = ONSET_HOP,
                             backend: str = DEFAULT_BACKEND,
                             global_floor_db: float = -96.0,
                             mesh=None, device_audio=None,
                             transfer: str = "auto",
                             device: str | torch.device = "cuda"):
    """Segment-parallel offline onset detection over one long mono buffer
    (float32 or int16) on `device`, with the warmup-overlap scheme of
    `segmented_pitch_analysis`; segment 0 equals the sequential
    `OnsetAnalyzer` run.  Returns numpy (fired [N] bool, velocity [N],
    flux [N], energy [N]) for all N onset frames, in order.
    `device_audio`, `mesh` and `transfer` as in `segmented_pitch_analysis`,
    except that "auto" always resolves to "resident" here: the onset steps
    are too cheap to hide a copy behind."""
    _check_mesh(mesh, device)
    audio = _as_host_audio(audio)
    transfer = _resolve_transfer(transfer, "onset", len(audio), sample_rate,
                                 device_audio)
    n_total = num_frames(len(audio), window, hop)
    if n_total <= 0:
        return _empty_onsets()
    if segments is None:
        segments = auto_segments(n_total, warmup_frames)
    segments = max(1, min(segments, max(n_total // max(chunk_frames, 1), 1)))
    segments = _snap_to_mesh(segments, mesh)
    plan = _plan_streams(n_total, segments, warmup_frames, chunk_frames,
                         window, hop)
    gf_lin = float(noisefloor.global_floor_linear(global_floor_db,
                                                  window // 2 + 1))
    blocks, rows, dev = _feed(audio, plan, chunk_frames, hop, transfer,
                              device, device_audio, mesh)
    outs = _run_onset_streams(blocks, rows, dev, chunk_frames, window, hop,
                              backend, gf_lin, mesh)
    return _unpack_onsets(outs, plan, n_total)


# ── Batched multi-recording analysis (serving many short takes) ──────────
# Recordings x segments form one flat row axis of independent scan streams,
# so B takes x S segments run as one batch through the same step.


def _pow2_floor(v: int) -> int:
    return 1 << (max(int(v), 1).bit_length() - 1)


def _batch_plan(n_list, segments_per_recording, warmup_frames, chunk_frames,
                window, hop, rows_target: int = 128) -> _StreamPlan:
    """One stream plan for the whole batch, sized for the longest recording;
    S is picked so B*S lands near `rows_target`."""
    n_max = max(n_list)
    if segments_per_recording is None:
        cap = _pow2_floor(max(1, rows_target // max(len(n_list), 1)))
        segments_per_recording = auto_segments(n_max, warmup_frames, cap=cap)
    s = max(1, min(segments_per_recording,
                   max(n_max // max(chunk_frames, 1), 1)))
    return _plan_streams(n_max, s, warmup_frames, chunk_frames, window, hop)


def _pack_batch(hosts, plan: _StreamPlan, hop: int, mesh=None):
    """Recordings → one flat upload array + per-row stream starts (samples).
    Each recording is zero-padded to plan.max_sample, so a row never reads
    into the next recording.  int16 stays int16 iff every recording is.
    With `mesh`, the rows pad up to a multiple of its size with dummy rows
    (start 0; their outputs are discarded)."""
    b = len(hosts)
    dtype = np.int16 if all(h.dtype == np.int16 for h in hosts) \
        else np.float32
    flat = np.zeros(b * plan.max_sample, dtype)
    for i, h in enumerate(hosts):
        flat[i * plan.max_sample:i * plan.max_sample + len(h)] = \
            h if h.dtype == dtype else h.astype(np.float32)
    starts = np.array([rec * plan.max_sample + int(plan.stream_start[s]) * hop
                       for rec in range(b) for s in range(plan.segments)],
                      np.int64)
    if mesh is not None:
        rows_pad = -(-len(starts) // mesh.size()) * mesh.size()
        starts = np.pad(starts, (0, rows_pad - len(starts)))
    return flat, starts


def segmented_pitch_analysis_batch(audios, sample_rate: float,
                                   segments_per_recording: int | None = None,
                                   warmup_frames: int = DEFAULT_WARMUP_FRAMES,
                                   chunk_frames: int = 64,
                                   window: int = PITCH_WINDOW,
                                   hop: int = PITCH_HOP,
                                   backend: str = PITCH_BACKEND,
                                   global_floor_db: float = -96.0,
                                   mesh=None,
                                   device: str | torch.device = "cuda"):
    """Analyze a batch of independent mono recordings as one set of streams.
    Returns a list of (stable_freqs [Ni, 8], stable_scores [Ni, 8],
    stable_valid [Ni, 8]) — `segmented_pitch_analysis`'s contract per
    recording.  With `mesh`, the flat recording x segment row axis is
    shared over its ranks (padded to a multiple of its size) and every
    rank gets the whole result."""
    _check_mesh(mesh, device)
    hosts = [_as_host_audio(a) for a in audios]
    if not hosts:
        return []
    n_list = [num_frames(len(h), window, hop) for h in hosts]
    if max(n_list) <= 0:
        return [_empty() for _ in hosts]
    plan = _batch_plan(n_list, segments_per_recording, warmup_frames,
                       chunk_frames, window, hop)
    flat, starts = _pack_batch(hosts, plan, hop, mesh)
    gf_lin = float(noisefloor.global_floor_linear(global_floor_db,
                                                  window // 2 + 1))
    seg_streams = _slice_streams(_upload_f32(flat, device),
                                 _shard_batch(starts, mesh),
                                 plan.stream_samples)
    blocks = _resident_blocks(seg_streams, plan.steps, chunk_frames * hop,
                              plan.chunk_samples)
    outs = _run_streams(blocks, seg_streams.shape[0], seg_streams.device,
                        plan, chunk_frames, sample_rate, window, hop, backend,
                        gf_lin, mesh)
    return [_unpack(outs, plan, n_total, row0=b * plan.segments)
            for b, n_total in enumerate(n_list)]


def segmented_onset_analysis_batch(audios, sample_rate: float,
                                   segments_per_recording: int | None = None,
                                   warmup_frames: int =
                                   DEFAULT_ONSET_WARMUP_FRAMES,
                                   chunk_frames: int = 4096,
                                   window: int = ONSET_WINDOW,
                                   hop: int = ONSET_HOP,
                                   backend: str = DEFAULT_BACKEND,
                                   global_floor_db: float = -96.0,
                                   mesh=None,
                                   device: str | torch.device = "cuda"):
    """Batch analog of `segmented_onset_analysis`: a list of recordings in,
    a list of (fired [Ni], velocity [Ni], flux [Ni], energy [Ni]) out, the
    recordings x segments as one flat row axis of streams (see
    `segmented_pitch_analysis_batch`), `mesh` as there."""
    _check_mesh(mesh, device)
    hosts = [_as_host_audio(a) for a in audios]
    if not hosts:
        return []
    n_list = [num_frames(len(h), window, hop) for h in hosts]
    if max(n_list) <= 0:
        return [_empty_onsets() for _ in hosts]
    plan = _batch_plan(n_list, segments_per_recording, warmup_frames,
                       chunk_frames, window, hop)
    flat, starts = _pack_batch(hosts, plan, hop, mesh)
    gf_lin = float(noisefloor.global_floor_linear(global_floor_db,
                                                  window // 2 + 1))
    seg_streams = _slice_streams(_upload_f32(flat, device),
                                 _shard_batch(starts, mesh),
                                 plan.stream_samples)
    blocks = _resident_blocks(seg_streams, plan.steps, chunk_frames * hop,
                              plan.chunk_samples)
    outs = _run_onset_streams(blocks, seg_streams.shape[0],
                              seg_streams.device, chunk_frames, window, hop,
                              backend, gf_lin, mesh)
    return [_unpack_onsets(outs, plan, n_total, row0=b * plan.segments)
            for b, n_total in enumerate(n_list)]
