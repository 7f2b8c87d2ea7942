"""The batched full step: the complete per-stream analysis chain over B
independent streams on one card (port of
audio_analyzer_rs_tpu/parallel/sharding.py).

Each step takes a fixed-length chunk of each stream and runs reducer
conditioning (kernel K6) -> AGC (kernel K7) -> the pitch pipeline (the
"fft" STFT at full width, the noise floor K5, extraction with the comb K2,
the tracker K3) -> the onset pipeline (the "fft" STFT, the onset scan K4),
every stage once over the whole batch, each stream's states carried to its
next chunk.  The JAX package vmaps one stream's chain and shards the batch
over a device mesh with `shard_map`, whose only collectives are the fleet
statistics; on one card those are plain sums over B.  The mesh is not
ported yet: `mesh` must be None.

Each pitch and onset frame reads the AGC noise floor of the slot holding
its last sample (the reference's STFT worker reads the floor right after
the slot that completed the frame, ref src/audio_io/stft.rs:322-324).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import dynamics, noisefloor, onset as onset_ops, pitch as pitch_ops
from ..ops import reducer, tracker
from ..ops.stft import ONSET_WINDOW, PITCH_WINDOW, windowed_mags
from ..utils.framing import frame_signal


class FullStepOut(NamedTuple):
    stable_freqs: torch.Tensor    # [B, Np, 8]
    stable_valid: torch.Tensor    # [B, Np, 8]
    onset_fired: torch.Tensor     # [B, No]
    onset_velocity: torch.Tensor  # [B, No]
    dyn_level: torch.Tensor       # [B, S]
    global_noise_floor_db: torch.Tensor  # scalar: the fleet's mean floor
    global_onset_count: torch.Tensor     # scalar: the fleet's onsets


class StreamStates(NamedTuple):
    """Per-stream carried state for the full chain ([B, ...] leaves)."""
    red: reducer.ReducerState
    dyn: dynamics.DynamicsState
    nf: noisefloor.NoiseFloorState
    tr: tracker.TrackerState
    on: onset_ops.OnsetState


def init_stream_states(batch: int, half: int = PITCH_WINDOW // 2 + 1,
                       device="cuda") -> StreamStates:
    return StreamStates(
        red=reducer.reducer_init(device, (batch,)),
        dyn=dynamics.init_state(device, (batch,)),
        nf=noisefloor.init_state(half, device, (batch,)),
        tr=tracker.init_state(device, (batch,)),
        on=onset_ops.init_state(onset_ops.HALF, device, (batch,)),
    )


def _batched_stream_step(states: StreamStates, audio: torch.Tensor,
                         sample_rate: float, slot_len: int, pitch_hop: int,
                         onset_hop: int, dyn_mode: str):
    """Every stream's chain on its chunk: audio [B, T] float32 →
    (states, (stable freqs, stable valid, fired, velocity, level, the last
    slot's floor [B]))."""
    red, y = reducer.reduce_signal(states.red, audio, sample_rate)
    b = y.shape[0]
    n_slots = y.shape[1] // slot_len
    slots = y[:, :n_slots * slot_len].reshape(b, n_slots, slot_len)
    dyn, douts, gained = dynamics.dynamics_scan(
        states.dyn, slots.contiguous(), sample_rate, slot_len, dyn_mode)
    cond = gained.reshape(b, -1)
    floors_db = douts.noise_floor_db

    def causal_floor_db(n_frames: int, window: int, hop: int):
        # The floor as of the slot holding each frame's last sample.
        last = (torch.arange(n_frames, dtype=torch.int64, device=y.device)
                * hop + (window - 1))
        return floors_db[:, (last // slot_len).clamp(max=n_slots - 1)]

    # Pitch pipeline.
    pframes = frame_signal(cond, PITCH_WINDOW, pitch_hop)
    n_p = pframes.shape[1]
    pmags = windowed_mags(pframes, PITCH_WINDOW)
    half = PITCH_WINDOW // 2 + 1
    gfp = noisefloor.global_floor_linear(
        causal_floor_db(n_p, PITCH_WINDOW, pitch_hop), half)
    bin_width = sample_rate / PITCH_WINDOW
    nf, eff = noisefloor.noise_floor_scan(
        states.nf, pmags, gfp, pitch_ops.candidate_band(bin_width, half))
    pf = pitch_ops.extract_pitches(pmags.reshape(b * n_p, -1),
                                   eff.reshape(b * n_p, -1), bin_width)
    pf = pitch_ops.PitchFrame(*(a.reshape(b, n_p, -1) for a in pf))
    no_onsets = torch.zeros((b, n_p), dtype=torch.bool, device=y.device)
    tr, (sf, _, sv) = tracker.tracker_scan_batched(
        states.tr, pf.freqs, pf.scores, pf.valid, no_onsets)

    # Onset pipeline.
    oframes = frame_signal(cond, ONSET_WINDOW, onset_hop)
    n_o = oframes.shape[1]
    omags = windowed_mags(oframes, ONSET_WINDOW)
    gfo = noisefloor.global_floor_linear(
        causal_floor_db(n_o, ONSET_WINDOW, onset_hop), ONSET_WINDOW // 2 + 1)
    no_ticks = torch.zeros((b, n_o), dtype=torch.bool, device=y.device)
    on, oouts = onset_ops.onset_scan(states.on, omags, gfo, no_ticks)

    new_states = StreamStates(red, dyn, nf, tr, on)
    return new_states, (sf, sv, oouts.fired, oouts.velocity, douts.level,
                        floors_db[:, -1])


def make_batched_full_step(mesh, sample_rate: float, slot_len: int = 1024,
                           pitch_hop: int = 512, onset_hop: int = 64,
                           dyn_mode: str = "hist", device="cuda"):
    """Build the full step: ([B, ...] states, [B, T] audio) → (states,
    FullStepOut).  `audio` is a float32 tensor or array (uploaded to
    `device`); the states come from `init_stream_states(B, device=...)`.
    T must hold at least one slot and one pitch frame.  `dyn_mode`: the AGC
    percentiles, "hist" (default) or "exact".  `mesh` must be None (one
    card): the mesh is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("mesh is not ported yet")
    if dyn_mode not in ("hist", "exact"):
        raise ValueError(f"dyn_mode={dyn_mode!r}: expected 'hist' or "
                         "'exact'")

    def step(states: StreamStates, audio):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        if audio.dim() != 2:
            raise ValueError(f"audio must be [B, T], got "
                             f"{tuple(audio.shape)}")
        if audio.shape[1] < max(slot_len, PITCH_WINDOW):
            raise ValueError(f"a chunk of {audio.shape[1]} samples holds no "
                             f"slot of {slot_len} or no pitch frame")
        states, (sf, sv, fired, vel, level, gf_db) = _batched_stream_step(
            states, audio.contiguous(), sample_rate, slot_len, pitch_hop,
            onset_hop, dyn_mode)
        # The fleet statistics (the JAX step's psums over the mesh): the
        # mean of the streams' last-slot floors, the total of their onsets.
        b = audio.shape[0]
        global_floor = gf_db.sum() * float(np.float32(1.0 / b))
        global_onsets = fired.to(torch.int32).sum().to(torch.int32)
        return states, FullStepOut(sf, sv, fired, vel, level, global_floor,
                                   global_onsets)

    return step
