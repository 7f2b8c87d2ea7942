"""Pitch and onset analyzer pipelines and the live engine's fused per-slot
step (port of audio_analyzer_rs_tpu/models/analyzer.py; ref
src/audio_io/stft.rs:155-441, src/analysis/onset.rs:104-546).

Pitch: frame → Hann × rDFT magnitude (K1) → per-bin noise-floor scan (K5)
→ harmonic-comb pitch extraction (K2) → PitchTracker scan (K3).  Onset:
frame → Hann × FFT magnitude (cuFFT) → onset scan (K4).  The functions take
a leading stream axis S: state leaves [S, ...], frames [S, N, W], per-frame
inputs [S, N].  `fused_slot_step` runs both flows for one live audio slot
with its carries on the device, for one engine or for the K lanes of an
engine pool (S = K); `fused_slot_agg_step` chains A slots and
`fused_slot_pool_step` is the pool's wave.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import noisefloor, onset as onset_ops, pitch as pitch_ops, tracker
from ..ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                        PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW, windowed_mags)
from ..utils.framing import frame_signal, num_frames


class PitchChunkOut(NamedTuple):
    raw_freqs: torch.Tensor      # [..., N, 8]
    raw_scores: torch.Tensor     # [..., N, 8]
    raw_valid: torch.Tensor      # [..., N, 8]
    stable_freqs: torch.Tensor   # [..., N, 8]
    stable_scores: torch.Tensor  # [..., N, 8]
    stable_valid: torch.Tensor   # [..., N, 8]
    mags: torch.Tensor           # [..., N, B]
    eff_floor: torch.Tensor      # [..., N, H] (empty [..., 0, 0] unless
                                 # return_floor)


def pitch_extract_frames(nf_state, frames, global_floor, sample_rate: float,
                         window: int = PITCH_WINDOW, hop: int = PITCH_HOP,
                         backend: str = PITCH_BACKEND,
                         return_floor: bool = False):
    """The frame-parallel front of the pitch pipeline (no tracker): frames
    [S, N, window] → (nf_state, PitchFrame [S, N, 8], mags, eff_floor).

    A backend suffixed "_band" (the default "dft_band") computes only the
    candidate-band bins [0, kc+1) — everything the pitch stages read — and
    the floor recurrence runs on [0, kc) (floors above the candidate band
    are never read).  `return_floor` (the devtools recorder, which wants
    the full surface) computes all window//2+1 bins with the "_band"
    backend's full-width base and runs the floor recurrence over all of
    them."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    band = None if return_floor else pitch_ops.candidate_band(bin_width,
                                                              half)
    if backend.endswith("_band"):
        mags = windowed_mags(frames, window, backend[:-len("_band")],
                             None if band is None else band + 1)
    else:
        mags = windowed_mags(frames, window, backend)
    nf_state, eff_floor = noisefloor.noise_floor_scan(nf_state, mags,
                                                      global_floor, band)
    s, n = mags.shape[:2]
    pf = pitch_ops.extract_pitches(mags.reshape(s * n, -1),
                                   eff_floor.reshape(s * n, -1), bin_width,
                                   true_half=half)
    pf = pitch_ops.PitchFrame(*(a.reshape(s, n, -1) for a in pf))
    return nf_state, pf, mags, eff_floor


def floor_warmup_frames(nf_state, frames, global_floor, sample_rate: float,
                        window: int = PITCH_WINDOW,
                        backend: str = PITCH_BACKEND):
    """STFT + noise-floor scan only: frames [S, N, window] → nf_state, the
    comb and tracker skipped.  The segment-parallel warmup
    (models/segmented.py `warmup_mode="floor"`) discards every output of
    its look-back frames, so only the floor state is needed there; the
    banding and magnitudes are `pitch_extract_frames`'s, so the floor
    recurrence sees the inputs the full step would."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    band = pitch_ops.candidate_band(bin_width, half)
    if backend.endswith("_band"):
        mags = windowed_mags(frames, window, backend[:-len("_band")],
                             band + 1)
    else:
        mags = windowed_mags(frames, window, backend)
    nf_state, _ = noisefloor.noise_floor_scan(nf_state, mags, global_floor,
                                              band)
    return nf_state


def pitch_analyze_frames(nf_state, tr_state, frames, global_floor, onsets,
                         sample_rate: float, window: int = PITCH_WINDOW,
                         hop: int = PITCH_HOP, backend: str = PITCH_BACKEND,
                         return_floor: bool = False):
    """Frames [S, N, window] → (nf_state, tr_state, PitchChunkOut): the
    frame-parallel stages, then the batched tracker scan.  `return_floor`
    as `pitch_extract_frames`; without it `eff_floor` is empty."""
    nf_state, pf, mags, eff_floor = pitch_extract_frames(
        nf_state, frames, global_floor, sample_rate, window, hop, backend,
        return_floor)
    tr_state, (sf, ss, sv) = tracker.tracker_scan_batched(
        tr_state, pf.freqs, pf.scores, pf.valid, onsets)
    if not return_floor:
        eff_floor = mags[..., :0, :0]
    return nf_state, tr_state, PitchChunkOut(pf.freqs, pf.scores, pf.valid,
                                             sf, ss, sv, mags, eff_floor)


@dataclass
class PitchAnalyzer:
    """Streaming pitch detection (ring buffer + device scans).

    Samples accumulate until >= window, then frames advance by hop
    (ref stft.rs:268-273,436-437).  State lives on `device`; each call
    uploads its samples once and reads the outputs back once."""
    sample_rate: float
    window: int = PITCH_WINDOW
    hop: int = PITCH_HOP
    backend: str = PITCH_BACKEND
    device: str = "cuda"
    # devtools.DebugRecorder (optional): while set, each call computes the
    # full-width spectrum and floor and logs one record a frame.  The
    # engine reads it to leave its fused path.
    debug_recorder: object = None
    # Frames per device call; longer inputs are split with the state
    # carried (the pipeline is a scan, so results are identical).
    max_chunk_frames: int = 4096
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.nf_state = noisefloor.init_state(self.window // 2 + 1,
                                              self.device, (1,))
        self.tr_state = tracker.init_state(self.device, (1,))
        self.frames_consumed = 0

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                onset_pending: Optional[np.ndarray] = None,
                onset_first: bool = False):
        """Feed a chunk; returns per-frame outputs as numpy arrays (a
        PitchChunkOut with [n, ...] leaves), or None when no frame
        completed.  `onset_pending`: optional [n_frames] bool onset flags
        (ref stft.rs:387); `onset_first` marks just the first frame."""
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        self._tail = buf[n * self.hop:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        if onset_pending is not None:
            onsets = np.asarray(onset_pending, bool)[:n]
        else:
            onsets = np.zeros(n, bool)
            if onset_first:
                onsets[0] = True
        buf_dev = torch.from_numpy(buf).to(self.device)
        onsets_dev = torch.from_numpy(onsets).to(self.device)
        record = self.debug_recorder is not None
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)[None]
            gf = torch.full((1, c1 - c0), gf_lin, dtype=torch.float32,
                            device=self.device)
            self.nf_state, self.tr_state, out = pitch_analyze_frames(
                self.nf_state, self.tr_state, frames, gf,
                onsets_dev[None, c0:c1], self.sample_rate, self.window,
                self.hop, self.backend, return_floor=record)
            outs.append(out)
        out = PitchChunkOut(*(torch.cat(parts, 1)[0].cpu().numpy()
                              for parts in zip(*outs)))
        if record:
            bin_width = self.sample_rate / self.window
            for i in range(n):
                stable = [(float(f), float(s)) for f, s, v in
                          zip(out.stable_freqs[i], out.stable_scores[i],
                              out.stable_valid[i]) if v]
                self.debug_recorder.log_pitch_frame(
                    self.frames_consumed + i, out.mags[i], out.eff_floor[i],
                    bin_width, stable)
        self.frames_consumed += n
        return out


class OnsetChunkOut(NamedTuple):
    fired: torch.Tensor          # [..., N] bool
    detected: torch.Tensor       # [..., N] bool
    velocity: torch.Tensor       # [..., N] float32
    flux: torch.Tensor           # [..., N] float32
    energy: torch.Tensor         # [..., N] float32
    burst_count: torch.Tensor    # [..., N] int32
    energy_rising: torch.Tensor  # [..., N] bool
    frames_since: torch.Tensor   # [..., N] int32


def onset_analyze_frames(state, frames, global_floor, tick_suppressed,
                         calibration_hold=None, window: int = ONSET_WINDOW,
                         backend: str = DEFAULT_BACKEND):
    """Frames [S, N, window] → (state, OnsetChunkOut [S, N]): the windowed
    magnitudes (backend "fft": torch.fft, cuFFT on the card, as the JAX
    package uses jnp.fft), then the onset scan (K4 on CUDA tensors)."""
    mags = windowed_mags(frames, window, backend=backend)
    state, out = onset_ops.onset_scan(state, mags, global_floor,
                                      tick_suppressed, calibration_hold)
    return state, OnsetChunkOut(*out)


class FusedSlotOut(NamedTuple):
    """Per-slot result of `fused_slot_step` (the live engine's fused path):
    the tracker's stable outputs [n_p, 8] (all the live tuner consumes, ref
    stft.rs:387-390) and the full onset per-frame record ([n_o] each).  The
    ring tails and the pending flag are not here: they stay on the device
    from slot to slot as separate carries."""
    stable_freqs: torch.Tensor
    stable_scores: torch.Tensor
    stable_valid: torch.Tensor
    onset: OnsetChunkOut


def pack_fused_out(out: FusedSlotOut) -> torch.Tensor:
    """A FusedSlotOut flattened into one float32 vector, so that a slot reads
    back one buffer: the leaves in field order (the JAX package's
    `pack_fused_out` order), each leaf raveled, so a leaf with a lane axis
    K is lane-minor within it.  Bool and int32 leaves cast exactly (0/1
    flags; counters far below 2^24)."""
    leaves = (out.stable_freqs, out.stable_scores, out.stable_valid,
              *out.onset)
    return torch.cat([leaf.reshape(-1).float() for leaf in leaves])


def fused_out_len(n_p: int, n_o: int) -> int:
    """Packed length of one FusedSlotOut with n_p pitch / n_o onset frames."""
    return 3 * n_p * 8 + 8 * n_o


def _take_leaves(vec: np.ndarray, lanes: int, frame_counts) -> list:
    """Unpack `vec`, the packed FusedSlotOuts of len(frame_counts) chained
    sub-slots with `lanes` lanes each (leaf-major, lane-minor), into
    outs[sub-slot][lane] → FusedSlotOut of numpy leaves."""
    vec = np.asarray(vec, np.float32)
    want = lanes * sum(fused_out_len(n_p, n_o) for n_p, n_o in frame_counts)
    if len(vec) != want:
        raise ValueError(f"unpack: {len(vec)} values, expected {want}")
    off = 0

    def take(n, shape, dtype):
        nonlocal off
        part = vec[off:off + n].reshape(shape)
        off += n
        if dtype is bool:
            return part > 0.5
        return part.astype(dtype) if dtype is not np.float32 else part

    result = []
    for n_p, n_o in frame_counts:
        sf = take(lanes * n_p * 8, (lanes, n_p, 8), np.float32)
        ss = take(lanes * n_p * 8, (lanes, n_p, 8), np.float32)
        sv = take(lanes * n_p * 8, (lanes, n_p, 8), bool)
        o = [take(lanes * n_o, (lanes, n_o), d) for d in
             (bool, bool, np.float32, np.float32, np.float32, np.int32, bool,
              np.int32)]
        result.append([FusedSlotOut(sf[k], ss[k], sv[k],
                                    OnsetChunkOut(*(x[k] for x in o)))
                       for k in range(lanes)])
    return result


def unpack_fused_out(vec: np.ndarray, n_p: int, n_o: int) -> FusedSlotOut:
    """Host-side inverse of `pack_fused_out` for one lane: numpy leaves."""
    return _take_leaves(vec, 1, [(n_p, n_o)])[0][0]


def unpack_fused_pool_out(vec: np.ndarray, n_engines: int,
                          frame_counts) -> list:
    """Host-side inverse of a packed `fused_slot_pool_step` readback:
    `frame_counts` is the [(n_p, n_o)] list of the chained sub-slots
    (shared by every lane of the wave).  Returns outs[sub-slot][engine] →
    FusedSlotOut of numpy leaves.  Port of the JAX package's
    `unpack_fused_pool_out` (models/analyzer.py:578), which reads the same
    layout."""
    return _take_leaves(vec, int(n_engines), frame_counts)


def _k1_frames(frames: torch.Tensor) -> torch.Tensor:
    """Pitch frames [K, N, W] as kernel K1 reads them in place: a copy when
    the lanes' base or row stride is not 16-byte aligned (a view into a
    chained host vector), the view itself otherwise.  Values unchanged."""
    if frames.data_ptr() % 16 or (frames.shape[0] > 1
                                  and frames.stride(0) % 4):
        return frames.contiguous()
    return frames


def fused_slot_step(nf_state, tr_state, onset_state, pending, p_tail, o_tail,
                    host_vec, sample_rate: float, slot_len: int,
                    p_window: int = PITCH_WINDOW, p_hop: int = PITCH_HOP,
                    o_window: int = ONSET_WINDOW, o_hop: int = ONSET_HOP,
                    pitch_backend: str = PITCH_BACKEND,
                    onset_backend: str = DEFAULT_BACKEND):
    """One live audio slot through both flows for K lanes (K engines, or
    one), with every carry on the device: the ring tails, the three states
    and the onset->pitch `pending` flag go in and come out as tensors and
    are never read back.  No input is written: every carry out is a new
    tensor or a view of one.

    State leaves carry the lane axis K; `pending` is bool [K]; the tails
    are float32 [K, p_tail_len] / [K, o_tail_len]; `host_vec` is the
    lanes' one upload, float32 [K, L] on the device, a row a lane:
        [slot | gf_pitch_lin | gf_onset_lin | calibration_hold |
         tick_suppressed (n_o entries, 0/1)]
    with n_p / n_o = num_frames(tail + slot) implied by the lengths (the
    lanes share the tails' geometry).  One lane may also come without the
    axis: tails [L] and host_vec [L] (the solo engine's call), with states
    and `pending` still of one lane; its tails come back 1-D.
    Returns (nf_state, tr_state, onset_state, pending, p_tail, o_tail, out),
    `out` the slot's FusedSlotOut packed into one float32 vector, each leaf
    [K, ...] raveled (`pack_fused_out`; the host reads it back once and
    unpacks it with `unpack_fused_out` or `unpack_fused_pool_out`).  The K
    lanes reach each kernel as one launch at S = K.

    Semantics are those of the engine's sequential consumers, lane by lane:
    the onset flow first, then the pitch flow with onsets[0] = pending |
    any(fired).  While a lane's `calibration_hold` is set, its fires do not
    reach its tracker (the sequential path never sets the engine's pending
    flag before calibration).  A ramp-up slot with no pitch frame (n_p ==
    0) leaves the flag set for the next one; a slot with no onset frame
    (n_o == 0) runs no onset kernel.  Port of the JAX package's
    `fused_slot_step` (models/analyzer.py:308), with its `jax.vmap` over
    engines (`fused_slot_pool_step`) as the lane axis."""
    if host_vec.dim() == 1:
        (nf_state, tr_state, onset_state, pending, p_tail, o_tail,
         out) = fused_slot_step(
            nf_state, tr_state, onset_state, pending, p_tail[None],
            o_tail[None], host_vec[None], sample_rate, slot_len, p_window,
            p_hop, o_window, o_hop, pitch_backend, onset_backend)
        return (nf_state, tr_state, onset_state, pending, p_tail[0],
                o_tail[0], out)
    dev = host_vec.device
    k = host_vec.shape[0]
    p_tail_len, o_tail_len = p_tail.shape[-1], o_tail.shape[-1]
    n_p = num_frames(p_tail_len + slot_len, p_window, p_hop)
    n_o = num_frames(o_tail_len + slot_len, o_window, o_hop)
    if host_vec.shape != (k, slot_len + 3 + n_o):
        raise ValueError(f"fused_slot_step: host_vec must be "
                         f"[{slot_len + 3 + n_o}] a lane, got "
                         f"{tuple(host_vec.shape)}")
    if (pending.shape != (k,) or p_tail.shape != (k, p_tail_len)
            or o_tail.shape != (k, o_tail_len)):
        raise ValueError(f"fused_slot_step: pending {tuple(pending.shape)} "
                         f"and tails {tuple(p_tail.shape)}, "
                         f"{tuple(o_tail.shape)} do not have {k} lanes")
    slot = host_vec[:, :slot_len]
    gf_p = host_vec[:, slot_len:slot_len + 1]
    gf_o = host_vec[:, slot_len + 1:slot_len + 2]
    hold = host_vec[:, slot_len + 2] > 0.5
    tick_sup = host_vec[:, slot_len + 3:] > 0.5

    o_buf = torch.cat([o_tail, slot], 1) if o_tail_len else slot
    fired_any = torch.zeros(k, dtype=torch.bool, device=dev)
    if n_o:
        o_frames = frame_signal(o_buf[:, :(n_o - 1) * o_hop + o_window],
                                o_window, o_hop)
        onset_state, o_out = onset_analyze_frames(
            onset_state, o_frames, gf_o.expand(k, n_o).contiguous(),
            tick_sup, hold[:, None].expand(k, n_o).contiguous(), o_window,
            onset_backend)
        fired_any = o_out.fired.any(-1) & ~hold
    else:                                               # ramp-up variants
        zf = torch.zeros((k, 0), dtype=torch.float32, device=dev)
        zb = torch.zeros((k, 0), dtype=torch.bool, device=dev)
        zi = torch.zeros((k, 0), dtype=torch.int32, device=dev)
        o_out = OnsetChunkOut(zb, zb, zf, zf, zf, zi, zb, zi)
    o_new_tail = o_buf[:, n_o * o_hop:]

    p_buf = torch.cat([p_tail, slot], 1) if p_tail_len else slot
    if n_p:
        p_frames = _k1_frames(frame_signal(
            p_buf[:, :(n_p - 1) * p_hop + p_window], p_window, p_hop))
        onsets = torch.zeros((k, n_p), dtype=torch.bool, device=dev)
        onsets[:, 0] = pending | fired_any
        nf_state, tr_state, pout = pitch_analyze_frames(
            nf_state, tr_state, p_frames, gf_p.expand(k, n_p).contiguous(),
            onsets, sample_rate, p_window, p_hop, pitch_backend)
        sf, ss, sv = pout.stable_freqs, pout.stable_scores, pout.stable_valid
        pending = torch.zeros_like(pending)
    else:
        sf = torch.zeros((k, 0, 8), dtype=torch.float32, device=dev)
        ss = torch.zeros((k, 0, 8), dtype=torch.float32, device=dev)
        sv = torch.zeros((k, 0, 8), dtype=torch.bool, device=dev)
        pending = pending | fired_any
    p_new_tail = p_buf[:, n_p * p_hop:]
    return (nf_state, tr_state, onset_state, pending, p_new_tail, o_new_tail,
            pack_fused_out(FusedSlotOut(sf, ss, sv, o_out)))


def slot_frame_counts(slot_len: int, n_slots: int, p_tail_len: int,
                      o_tail_len: int, p_window: int = PITCH_WINDOW,
                      p_hop: int = PITCH_HOP, o_window: int = ONSET_WINDOW,
                      o_hop: int = ONSET_HOP) -> list:
    """[(n_p, n_o)] of `n_slots` chained slots from the given tail lengths
    (the ring tails advance by the slot less what the frames consumed)."""
    counts = []
    for _ in range(n_slots):
        n_p = num_frames(p_tail_len + slot_len, p_window, p_hop)
        n_o = num_frames(o_tail_len + slot_len, o_window, o_hop)
        counts.append((n_p, n_o))
        p_tail_len += slot_len - n_p * p_hop
        o_tail_len += slot_len - n_o * o_hop
    return counts


def fused_slot_agg_step(nf_state, tr_state, onset_state, pending, p_tail,
                        o_tail, host_vec, sample_rate: float, slot_len: int,
                        n_slots: int, p_window: int = PITCH_WINDOW,
                        p_hop: int = PITCH_HOP, o_window: int = ONSET_WINDOW,
                        o_hop: int = ONSET_HOP,
                        pitch_backend: str = PITCH_BACKEND,
                        onset_backend: str = DEFAULT_BACKEND):
    """`n_slots` consecutive live slots chained in one call, the carries
    passed from slot to slot on the device: `fused_slot_step` A times.

    `host_vec` is the concatenation (along its last axis) of the A
    per-slot host vectors, each sampled by the host at its own slot, so
    the per-slot floor, hold and tick values are those of A separate
    calls.  Arguments and lane forms as `fused_slot_step`.  Returns the
    carries and one packed float32 vector: the A slots' packed
    FusedSlotOuts in slot order (the JAX package's `pack_fused_out` over
    the tuple of A outs), so one readback covers the aggregate.

    Every output and every carry is bitwise equal to A separate
    `fused_slot_step` calls, the noise-floor leaves included: the loop runs
    the same ops on the same tensors.  (The JAX package's XLA program may
    contract the floor EMAs differently in its chained module and allows
    those leaves ulp drift; this port needs no such allowance.)  Port of
    `fused_slot_agg_step` (models/analyzer.py:403)."""
    counts = slot_frame_counts(slot_len, n_slots, p_tail.shape[-1],
                               o_tail.shape[-1], p_window, p_hop, o_window,
                               o_hop)
    want = sum(slot_len + 3 + n_o for _, n_o in counts)
    if host_vec.shape[-1] != want:
        raise ValueError(f"fused_slot_agg_step: host_vec must be [{want}] a "
                         f"lane for {n_slots} slots, got "
                         f"{tuple(host_vec.shape)}")
    outs = []
    off = 0
    for _, n_o in counts:
        sub = host_vec[..., off:off + slot_len + 3 + n_o]
        (nf_state, tr_state, onset_state, pending, p_tail, o_tail,
         out) = fused_slot_step(nf_state, tr_state, onset_state, pending,
                                p_tail, o_tail, sub, sample_rate, slot_len,
                                p_window, p_hop, o_window, o_hop,
                                pitch_backend, onset_backend)
        outs.append(out)
        off += slot_len + 3 + n_o
    return (nf_state, tr_state, onset_state, pending, p_tail, o_tail,
            outs[0] if len(outs) == 1 else torch.cat(outs))


class PoolCarries(NamedTuple):
    """One engine's fused carries as `fused_slot_pool_step` takes them: its
    three states (leaves with a stream axis of 1), `pending` bool [1] and
    the tails float32 [L]."""
    nf_state: noisefloor.NoiseFloorState
    tr_state: tracker.TrackerState
    onset_state: onset_ops.OnsetState
    pending: torch.Tensor
    p_tail: torch.Tensor
    o_tail: torch.Tensor


def stack_carries(states) -> PoolCarries:
    """K engines' carries → one PoolCarries of [K, ...] tensors: one
    concatenation a leaf, whatever K."""
    nf, tr, os_, pend, pt, ot = zip(*states)

    def cat(cls, members):
        return cls(*(torch.cat(leaves) for leaves in zip(*members)))
    return PoolCarries(cat(type(nf[0]), nf), cat(type(tr[0]), tr),
                       cat(type(os_[0]), os_), torch.cat(pend),
                       torch.stack(pt), torch.stack(ot))


def unstack_carries(stacked: PoolCarries, n: int) -> list:
    """The first `n` lanes of stacked carries as per-engine PoolCarries:
    views, no copy."""
    nf, tr, os_, pend, pt, ot = stacked

    def lane(state, k):
        return type(state)(*(leaf[k:k + 1] for leaf in state))
    return [PoolCarries(lane(nf, k), lane(tr, k), lane(os_, k),
                        pend[k:k + 1], pt[k], ot[k]) for k in range(n)]


def _pool_wave_stacked(stacked: PoolCarries, host_vecs: torch.Tensor,
                       sample_rate: float, slot_len: int, n_slots: int,
                       p_window: int, p_hop: int, o_window: int, o_hop: int,
                       pitch_backend: str, onset_backend: str):
    """The pool wave over pre-stacked [C, ...] carries: the body of both
    `fused_slot_pool_step` and `fused_slot_pool_step_stacked` (JAX
    `_pool_wave_stacked`, models/analyzer.py:528).  The lanes are
    `fused_slot_agg_step`'s lane axis, where the JAX package vmaps one
    engine's program."""
    if host_vecs.shape[0] != stacked.pending.shape[0]:
        raise ValueError(f"pool wave: {stacked.pending.shape[0]} lanes, "
                         f"{host_vecs.shape[0]} host vectors")
    *new, out = fused_slot_agg_step(
        *stacked, host_vecs, sample_rate, slot_len, n_slots, p_window, p_hop,
        o_window, o_hop, pitch_backend, onset_backend)
    return PoolCarries(*new), out


def fused_slot_pool_step(states, host_vecs: torch.Tensor, sample_rate: float,
                         slot_len: int, n_slots: int,
                         p_window: int = PITCH_WINDOW, p_hop: int = PITCH_HOP,
                         o_window: int = ONSET_WINDOW, o_hop: int = ONSET_HOP,
                         pitch_backend: str = PITCH_BACKEND,
                         onset_backend: str = DEFAULT_BACKEND):
    """One call per slot wave: C engines' fused slot steps as the C lanes of
    one program (api/pool.EnginePool, the classroom), each kernel launched
    once a wave at S = C (x the pitch or onset frames a slot).

    `states` is a sequence over engines of PoolCarries (or tuples in its
    order); `host_vecs` [C, L] stacks their host vectors, each row the
    `n_slots` chained per-slot vectors of `fused_slot_agg_step`.  The
    carries stack to [C, ...] (one concatenation a leaf), the lanes run,
    and the new carries come back as per-engine views, so between waves
    every engine owns its carries: it can leave the pool, checkpoint, or
    be driven solo at any wave boundary.  Returns (per-engine PoolCarries,
    packed outputs): the A sub-slots' FusedSlotOuts with [C, ...] leaves,
    leaf-major and lane-minor (`unpack_fused_pool_out`).

    Each lane's results are bitwise those of its engine's own
    `fused_slot_agg_step`, since every op is per lane; that holds on the
    card (K1's frames, K2-K5's streams and the plain ops are independent of
    the batch) and on the CPU while the plain matmul's rounding does not
    depend on its row count (2C frames <= 128 with one thread).  Port of
    `fused_slot_pool_step` (models/analyzer.py:478); its body is
    `_pool_wave_stacked`, shared with `fused_slot_pool_step_stacked`."""
    new, out = _pool_wave_stacked(
        stack_carries(states), host_vecs, sample_rate, slot_len, n_slots,
        p_window, p_hop, o_window, o_hop, pitch_backend, onset_backend)
    return unstack_carries(new, len(states)), out


def fused_slot_pool_step_stacked(stacked: PoolCarries, host_vecs: torch.Tensor,
                                 sample_rate: float, slot_len: int,
                                 n_slots: int, p_window: int = PITCH_WINDOW,
                                 p_hop: int = PITCH_HOP,
                                 o_window: int = ONSET_WINDOW,
                                 o_hop: int = ONSET_HOP,
                                 pitch_backend: str = PITCH_BACKEND,
                                 onset_backend: str = DEFAULT_BACKEND):
    """`fused_slot_pool_step` over PRE-STACKED carries (`stack_carries`: one
    PoolCarries of [C, ...] leaves): the multi-card classroom form.  The
    lanes never communicate, so a rank that holds some lanes' carries and
    host rows runs them alone (parallel/sharding.py
    `make_pooled_wave_step`).  Returns (new stacked PoolCarries, packed
    outputs over these lanes, leaf-major and lane-minor).  Port of
    `fused_slot_pool_step_stacked` (models/analyzer.py:552)."""
    return _pool_wave_stacked(stacked, host_vecs, sample_rate, slot_len,
                              n_slots, p_window, p_hop, o_window, o_hop,
                              pitch_backend, onset_backend)


@dataclass
class OnsetAnalyzer:
    """Streaming onset detection (window 256 / hop 64).  State lives on
    `device`; each call uploads its samples once and reads the outputs back
    once."""
    sample_rate: float
    window: int = ONSET_WINDOW
    hop: int = ONSET_HOP
    backend: str = DEFAULT_BACKEND
    device: str = "cuda"
    # Frames per device call; longer inputs are split with the state carried
    # (the scan makes the results identical).  Onset arrays are [n, 129], so
    # the bound is looser than PitchAnalyzer's.
    max_chunk_frames: int = 131072
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.reset()

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.state = onset_ops.init_state(self.window // 2 + 1, self.device,
                                          (1,))
        self.frames_consumed = 0

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                tick_suppressed: Optional[np.ndarray] = None,
                calibration_hold: bool = False):
        """Feed a chunk; returns per-frame outputs as numpy arrays (an
        OnsetChunkOut with [n] leaves), or None when no frame completed.
        `tick_suppressed`: optional [n_frames] bool; `calibration_hold`
        applies to every frame of the chunk."""
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        self._tail = buf[n * self.hop:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        ts = (np.zeros(n, bool) if tick_suppressed is None
              else np.asarray(tick_suppressed, bool)[:n])
        buf_dev = torch.from_numpy(buf).to(self.device)
        ts_dev = torch.from_numpy(np.ascontiguousarray(ts)).to(self.device)
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)[None]
            gf = torch.full((1, c1 - c0), gf_lin, dtype=torch.float32,
                            device=self.device)
            hold = torch.full((1, c1 - c0), bool(calibration_hold),
                              dtype=torch.bool, device=self.device)
            self.state, out = onset_analyze_frames(
                self.state, frames, gf, ts_dev[None, c0:c1].contiguous(),
                hold, self.window, self.backend)
            outs.append(out)
        self.frames_consumed += n
        return OnsetChunkOut(*(torch.cat(parts, 1)[0].cpu().numpy()
                               for parts in zip(*outs)))
