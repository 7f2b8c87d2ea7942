"""K6 — the reducer scan (HPF -> LPF -> noise gate, sample by sample) over
B streams, as one Hopper kernel (csrc/reducer.cu).

Replaces: the `lax.scan`s of audio_analyzer_rs_tpu/ops/reducer.py
`reduce_signal` (:215, the exact mode's fused per-sample scan) and
`noise_gate` (:153, the fast mode's gate), which XLA compiles to device
loops.  They have no Pallas twin; as plain PyTorch each sample is ~20 small
launches on [B] tensors, so the scan is a kernel here.

What bounds it on an H100: the chain.  Each stream is T dependent steps
(two biquads' feedback FMAs and the envelope's compare-select-FMA a
sample); the bytes (audio in, conditioned audio out: 2 x B x T x 4) are a
small share of the time at any B the full step uses.

Design (the source note in csrc/reducer.cu has the detail): a block of 16
streams, a lane a stream and a warp a stage, the stages a pipeline over
128-sample tiles in a ring in shared memory.  A producer warp brings each
tile in by TMA (16 x 32 boxes from a tensor map over x) and sends the
gated tile back the same way; warps for the HPF, the LPF, the envelope,
its gain below the threshold and the hold each keep their state in
registers and hand the tile on through mbarriers, with no block barrier.
The hold counter runs as a count of samples below the threshold against
the count at which the hold ends.  Where T % 4 != 0 the rows are not
16-byte aligned and the tiles move by plain loads and stores.

`reduce_scan` is the wrapper: on CPU tensors the plain version
(`reducer.reduce_exact_plain`, or `reducer.gate_plain` for the gate-only
entry), on CUDA tensors the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0


def check_args(state, x: torch.Tensor) -> None:
    """Raise ValueError on what the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"reduce_scan: x must be [B, T], got "
                         f"{tuple(x.shape)}")
    b = x.shape[0]
    leaves = (*state.hp, *state.lp, *state.gate)
    for i, t in enumerate(leaves):
        dtype = torch.int32 if i == len(leaves) - 1 else torch.float32
        if t.dtype != dtype or tuple(t.shape) != (b,):
            raise ValueError(f"reduce_scan: state leaf {i} must be {dtype} "
                             f"({b},), got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("reduce_scan: all tensors must share one device")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("reduce_scan: x must be contiguous float32")


def reduce_scan(state, x: torch.Tensor, sample_rate: float, gate_only: bool):
    """state: ReducerState with leaves [B]; x [B, T] float32 → (state,
    y [B, T]).  gate_only: run the noise gate alone (the biquad leaves pass
    through)."""
    from . import reducer
    if x.device.type == "cpu":
        if gate_only:
            gate, y = reducer.gate_plain(state.gate, x, sample_rate)
            return reducer.ReducerState(state.hp, state.lp, gate), y
        return reducer.reduce_exact_plain(state, x, sample_rate)
    if x.device.type != "cuda":
        raise ValueError(f"reduce_scan: unsupported device {x.device}")
    check_args(state, x)
    b, t = x.shape
    y = torch.empty_like(x)
    if b == 0 or t == 0:
        return state, y
    st_in = torch.stack([*state.hp, *state.lp, state.gate.envelope], 1)
    st_out = torch.empty_like(st_in)
    hold_out = torch.empty_like(state.gate.hold_remaining)
    hp = reducer.biquad_coeffs(reducer.HPF_FREQ, sample_rate, False)
    lp = reducer.biquad_coeffs(reducer.LPF_FREQ, sample_rate, True)
    rel, c1, hold_samples = reducer.gate_params(sample_rate)
    code = _build.lib().aat_reducer_scan(
        x.data_ptr(), y.data_ptr(), st_in.data_ptr(),
        state.gate.hold_remaining.data_ptr(), st_out.data_ptr(),
        hold_out.data_ptr(), b, t, int(gate_only),
        *(float(c) for c in (*hp, *lp)), rel, c1, hold_samples,
        ctypes.c_void_p(_build.stream_ptr(x)))
    _build.check(code, "aat_reducer_scan")
    global LAUNCHES
    LAUNCHES += 1
    leaves = st_out.unbind(1)
    return reducer.ReducerState(
        reducer.BiquadState(*leaves[:4]), reducer.BiquadState(*leaves[4:8]),
        reducer.GateState(leaves[8], hold_out)), y
