"""The batched full step: the complete per-stream analysis chain over B
independent streams on one card (port of
audio_analyzer_rs_tpu/parallel/sharding.py).

Each step takes a fixed-length chunk of each stream and runs reducer
conditioning (kernel K6) -> AGC (kernel K7) -> the pitch pipeline (the
"fft" STFT banded to the bins the extraction reads, with each stream's
first frame at full width, `pitch_mags`; the noise floor K5, extraction
with the comb K2, the tracker K3) -> the onset pipeline (the "fft" STFT,
the onset scan K4),
every stage once over the whole batch, each stream's states carried to its
next chunk.  The JAX package vmaps one stream's chain and shards the batch
over a device mesh with `shard_map`, whose only collectives are the fleet
statistics (three `psum`s).  Here `mesh=None` runs the whole batch on one
card; with a mesh (parallel/mesh.py) every rank passes its [B / world, T]
rows and their states, gets its own rows back, and the fleet statistics
are all-reduced over the mesh, so every rank sees the same scalars.

`make_pooled_wave_step` shares an engine pool's lanes over a mesh: the
lanes never communicate, so each rank runs its own with no collective.

Each pitch and onset frame reads the AGC noise floor of the slot holding
its last sample (the reference's STFT worker reads the floor right after
the slot that completed the frame, ref src/audio_io/stft.rs:322-324).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from ..ops import dynamics, hopper_rfft, noisefloor, onset as onset_ops
from ..ops import pitch as pitch_ops, reducer, tracker
from ..ops.fft import hann
from ..ops.stft import ONSET_WINDOW, PITCH_WINDOW, windowed_mags
from ..utils.framing import frame_signal
from .mesh import check_mesh, replicated


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


def pitch_mags(frames: torch.Tensor, band: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's pitch STFT as its readers take it: frames [B, N, W] →
    (magnitudes of bins [0, band) [B, N, band], each stream's first frame
    at full width [B, W/2 + 1]).  The extraction reads bins [0, kc + 1),
    the noise floor [0, kc) and, on a fresh stream, the first frame above
    kc (its state's tail seed).  On CUDA tensors one K11 launch writes both
    (`hopper_rfft.rfft_mag_first`); on CPU tensors both are slices of
    `windowed_mags` at full width.  Either way the bits of each bin are
    those of the full width's."""
    if frames.device.type == "cpu":
        full = windowed_mags(frames, PITCH_WINDOW)
        return full[..., :band], full[..., 0, :].contiguous()
    return hopper_rfft.rfft_mag_first(frames, band,
                                      hann(PITCH_WINDOW, frames.device))


def _batched_stream_step(states: StreamStates, audio: torch.Tensor,
                         sample_rate: float, slot_len: int, pitch_hop: int,
                         onset_hop: int, dyn_mode: str):
    """Every stream's chain on its chunk: audio [B, T] float32 →
    (states, (stable freqs, stable valid, fired, velocity, level, the last
    slot's floor [B]))."""
    with spans.span("full_step.conditioning"):
        red, y = reducer.reduce_signal(states.red, audio, sample_rate)
        b = y.shape[0]
        n_slots = y.shape[1] // slot_len
        slots = y[:, :n_slots * slot_len].reshape(b, n_slots, slot_len)
        dyn, douts, gained = dynamics.dynamics_scan(
            states.dyn, slots.contiguous(), sample_rate, slot_len,
            dyn_mode)
        cond = gained.reshape(b, -1)
        floors_db = douts.noise_floor_db

    def causal_floor_db(n_frames: int, window: int, hop: int):
        # The floor as of the slot holding each frame's last sample.
        last = (torch.arange(n_frames, dtype=torch.int64, device=y.device)
                * hop + (window - 1))
        return floors_db[:, (last // slot_len).clamp(max=n_slots - 1)]

    # Pitch pipeline.
    with spans.span("full_step.pitch"):
        pframes = frame_signal(cond, PITCH_WINDOW, pitch_hop)
        n_p = pframes.shape[1]
        half = PITCH_WINDOW // 2 + 1
        bin_width = sample_rate / PITCH_WINDOW
        kc = pitch_ops.candidate_band(bin_width, half)
        pmags, pfirst = pitch_mags(pframes, kc + 1)
        gfp = noisefloor.global_floor_linear(
            causal_floor_db(n_p, PITCH_WINDOW, pitch_hop), half)
        nf, eff = noisefloor.noise_floor_scan(states.nf, pmags, gfp, kc,
                                              pfirst)
        pf = pitch_ops.extract_pitches(pmags.reshape(b * n_p, -1),
                                       eff.reshape(b * n_p, -1), bin_width,
                                       true_half=half)
        pf = pitch_ops.PitchFrame(*(a.reshape(b, n_p, -1) for a in pf))
        no_onsets = torch.zeros((b, n_p), dtype=torch.bool, device=y.device)
        tr, (sf, _, sv) = tracker.tracker_scan_batched(
            states.tr, pf.freqs, pf.scores, pf.valid, no_onsets)

    # Onset pipeline.
    with spans.span("full_step.onsets"):
        oframes = frame_signal(cond, ONSET_WINDOW, onset_hop)
        n_o = oframes.shape[1]
        omags = windowed_mags(oframes, ONSET_WINDOW)
        gfo = noisefloor.global_floor_linear(
            causal_floor_db(n_o, ONSET_WINDOW, onset_hop),
            ONSET_WINDOW // 2 + 1)
        no_ticks = torch.zeros((b, n_o), dtype=torch.bool, device=y.device)
        on, oouts = onset_ops.onset_scan(states.on, omags, gfo, no_ticks)

    new_states = StreamStates(red, dyn, nf, tr, on)
    return new_states, (sf, sv, oouts.fired, oouts.velocity, douts.level,
                        floors_db[:, -1])


def fleet_statistics(gf_db: torch.Tensor, fired: torch.Tensor,
                     psum=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The fleet's mean last-slot floor and its onsets from this card's
    streams: the JAX step's `psum(sum(gf_db)) / total_b` and
    `psum(sum(fired))`, with `psum` the sum over the mesh (None: one card).
    The mean is the floor sum times the float32 reciprocal of the stream
    count, the form XLA gives JAX's division: the per-device sums added,
    then multiplied by 1 / total_b rounded to float32 (bit for bit against
    the JAX package's step on 1 and 8 devices at B = 3 and 40, where a
    division rounds differently: tests/test_torch_fleet_stats.py)."""
    psum = psum or (lambda t: t)
    floor_sum = psum(gf_db.sum().reshape(1))
    counts = psum(torch.stack([
        torch.full((), gf_db.shape[0], dtype=torch.int64,
                   device=gf_db.device),
        fired.to(torch.int64).sum()]))
    global_floor = floor_sum[0] * (1.0 / counts[0].to(torch.float32))
    return global_floor, counts[1].to(torch.int32)


def make_batched_full_step(mesh, sample_rate: float, slot_len: int = 1024,
                           pitch_hop: int = 512, onset_hop: int = 64,
                           dyn_mode: str = "hist", device="cuda"):
    """Build the full step: ([B, ...] states, [B, T] audio) → (states,
    FullStepOut).  `audio` is a float32 tensor or array (uploaded to
    `device`); the states come from `init_stream_states(B, device=...)`.
    T must hold at least one slot and one pitch frame.  `dyn_mode`: the AGC
    percentiles, "hist" (default) or "exact".

    `mesh`: None (one card, the whole batch) or a 1-D DeviceMesh: every
    rank of it calls the step with its own [B / world, T] rows and their
    states and gets its rows' states and outputs back; the fleet
    statistics are the all-reduced sums (`fleet_statistics`), the same on
    every rank.  At world size 1 the step is bitwise the mesh-free one.

    While `spans` records (spans.py), each call is one step span,
    "full_step", holding "full_step.conditioning" (K6, K7), ".pitch" (K11,
    K5, K10, K3), ".onsets" (K11, K4) and ".fleet" (the fleet statistics),
    each around the host code that launches its stage's work."""
    if mesh is not None:
        check_mesh(mesh, device)
    if dyn_mode not in ("hist", "exact"):
        raise ValueError(f"dyn_mode={dyn_mode!r}: expected 'hist' or "
                         "'exact'")

    def step(states: StreamStates, audio):
        with spans.span("full_step"):
            audio = torch.as_tensor(audio, dtype=torch.float32,
                                    device=device)
            if audio.dim() != 2:
                raise ValueError(f"audio must be [B, T], got "
                                 f"{tuple(audio.shape)}")
            if audio.shape[1] < max(slot_len, PITCH_WINDOW):
                raise ValueError(f"a chunk of {audio.shape[1]} samples "
                                 f"holds no slot of {slot_len} or no pitch "
                                 "frame")
            states, (sf, sv, fired, vel, level, gf_db) = \
                _batched_stream_step(states, audio.contiguous(), sample_rate,
                                     slot_len, pitch_hop, onset_hop,
                                     dyn_mode)
            # The fleet statistics (the JAX step's psums over the mesh):
            # the mean of the streams' last-slot floors, the total of their
            # onsets.
            with spans.span("full_step.fleet"):
                global_floor, global_onsets = fleet_statistics(
                    gf_db, fired,
                    None if mesh is None else replicated(mesh).sum)
            return states, FullStepOut(sf, sv, fired, vel, level,
                                       global_floor, global_onsets)

    return step


def make_pooled_wave_step(mesh, sample_rate: float, slot_len: int = 1024,
                          n_slots: int = 1, device="cuda"):
    """The multi-card classroom: an engine pool's slot waves with its C lanes
    shared over a mesh (port of the JAX `make_pooled_wave_step`).

    The lanes never communicate, so each rank runs its own share with no
    collective.  Returns `(place, step)`:

      place(stacked, host_vecs) -> this rank's lanes of the pre-stacked
          carries of all C lanes (`models.analyzer.stack_carries`) and of
          the [C, L] host rows of a wave, on `device` (C a multiple of the
          mesh's size); either argument may be None, and comes back None
          (the carries are placed once, each wave's rows as they come);
      step(stacked, host_vecs, p_tail_len, o_tail_len) ->
          (new_stacked, packed): `fused_slot_pool_step_stacked` with this
          wave geometry over the rank's lanes; `packed` holds their
          outputs, leaf-major and lane-minor (`unpack_fused_pool_out` with
          this rank's lane count).

    Every lane's carries and outputs are bitwise those of the
    single-card pool step (held by the multichip dryrun,
    parallel/dryrun.py, and the tests)."""
    from ..models.analyzer import fused_slot_pool_step_stacked
    from .mesh import batch_sharding
    check_mesh(mesh, device)
    sharding = batch_sharding(mesh)

    def to_device(t):
        return torch.as_tensor(t).to(device).contiguous()

    def place(stacked, host_vecs):
        if stacked is not None:
            stacked = type(stacked)(*(
                type(part)(*map(to_device, sharding.shard(part)))
                if isinstance(part, tuple) else to_device(sharding.shard(part))
                for part in stacked))
        if host_vecs is not None:
            host_vecs = to_device(sharding.shard(host_vecs))
        return stacked, host_vecs

    def step(stacked, host_vecs, p_tail_len: int, o_tail_len: int):
        tails = (stacked.p_tail.shape[-1], stacked.o_tail.shape[-1])
        if tails != (p_tail_len, o_tail_len):
            raise ValueError(f"tails of {tails} samples, the wave geometry "
                             f"says {(p_tail_len, o_tail_len)}")
        return fused_slot_pool_step_stacked(stacked, host_vecs, sample_rate,
                                            slot_len, n_slots)

    return place, step


# ── NumPy oracle, for the machine without JAX ──────────────────────────
# A copy of the JAX package's, its source unchanged (float64 or
# float32 loops that transcribe the Rust reference); it calls nothing
# of torch.  tests/test_torch_oracles.py holds it to the JAX
# package's function by syntax tree and by bits.
# The JAX package's `_single_stream_step` is `_batched_stream_step` at
# B = 1 here.

def full_chain_np(audio, sample_rate: float, slot_len: int = 1024,
                  pitch_hop: int = 512, onset_hop: int = 64):
    """Exact NumPy oracle of `_single_stream_step` (one chunk, fresh state).

    Composes the exact-mode oracles end to end: sequential biquad + gate
    (reduce_signal_np — no blocked-scan approximation), sort-based AGC
    percentiles (DynamicsTrackerNp — no histogram quantization), per-slot
    causal floors, then the *_np pitch and onset pipelines.  Used to
    quantify the fast-mode (blocked biquad + hist AGC) divergence of the
    batched full step on realistic scenes (tools/fullchain_divergence.py,
    tests/test_fullchain_divergence.py).

    Returns a dict: stable (list of per-frame [(freq, score), ...]),
    onset_fired [No] bool, onset_velocity [No] f32, floors_db [S] f32.
    """
    import numpy as np

    from ..ops.pitch import extract_pitches_np
    from ..ops.stft import stft_mags_np
    from ..ops.tracker import PitchTrackerNp
    from ..utils.framing import num_frames

    audio = np.asarray(audio, np.float32)
    y = reducer.reduce_signal_np(audio, sample_rate)
    n_slots = len(y) // slot_len
    dyn = dynamics.DynamicsTrackerNp(sample_rate, slot_len)
    gained = np.empty(n_slots * slot_len, np.float32)
    floors_db = np.empty(n_slots, np.float32)
    for s in range(n_slots):
        out = dyn.process_slot(y[s * slot_len:(s + 1) * slot_len])
        gained[s * slot_len:(s + 1) * slot_len] = out["slot"]
        floors_db[s] = out["noise_floor_db"]

    def per_frame_floor_lin(n_frames, window, hop, half):
        last = np.arange(n_frames) * hop + (window - 1)
        idx = np.minimum(last // slot_len, n_slots - 1)
        return (10.0 ** (floors_db[idx].astype(np.float64) / 20.0)
                * (half / 2.0)).astype(np.float32)

    # Pitch chain.
    n_p = num_frames(len(gained), PITCH_WINDOW, pitch_hop)
    half = PITCH_WINDOW // 2 + 1
    pmags = stft_mags_np(gained, PITCH_WINDOW, pitch_hop).astype(np.float32)
    gfp = per_frame_floor_lin(n_p, PITCH_WINDOW, pitch_hop, half)
    eff = noisefloor.noise_floor_np(pmags, gfp)
    bin_width = float(np.float32(sample_rate) / np.float32(PITCH_WINDOW))
    tracker_np = PitchTrackerNp()
    stable = []
    for i in range(n_p):
        raw = extract_pitches_np(pmags[i], eff[i], bin_width)
        stable.append(tracker_np.process(raw, onset=False))

    # Onset chain.
    ohalf = ONSET_WINDOW // 2 + 1
    n_o = num_frames(len(gained), ONSET_WINDOW, onset_hop)
    omags = stft_mags_np(gained, ONSET_WINDOW, onset_hop).astype(np.float32)
    gfo = per_frame_floor_lin(n_o, ONSET_WINDOW, onset_hop, ohalf)
    oout = onset_ops.onset_np(omags, gfo, np.zeros(n_o, bool))
    return {"stable": stable, "onset_fired": oout["fired"],
            "onset_velocity": oout["velocity"], "floors_db": floors_db}
