"""States carried across between the JAX package and this port.

The JAX package's `NoiseFloorState`, `TrackerState`, `OnsetState`,
`ReducerState` (of `BiquadState`s and a `GateState`), `DynamicsState` and
the full step's `StreamStates` are (nested) NamedTuples of arrays; given as numpy arrays (with or without a leading
stream axis S) they become this port's states on a device, and back.  Field
names and order are the same in both packages, so a state converts leaf by
leaf.  The live engine's fused path carries three more values from slot to
slot (the pitch and onset ring tails and the onset->pitch pending flag);
`fused_carries` converts them, and `pool_carries` a JAX `EnginePool`
member's whole set (its unbatched states and its `_resident` carries) as
the port's pool wave takes them.  The system has no weights: its constant
tables (Hann, rDFT trig) are rebuilt from the same numpy formulas on both
sides.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.analyzer import PoolCarries
from .ops.dynamics import DynamicsState
from .ops.noisefloor import NoiseFloorState
from .ops.onset import OnsetState
from .ops.reducer import BiquadState, GateState, ReducerState
from .ops.tracker import TrackerState
from .parallel.sharding import StreamStates

# Each state's leaf dtypes in field order (checkpoint.py uses them too).
STATE_DTYPES = {
    NoiseFloorState: (torch.float32, torch.float32, torch.float32, torch.bool),
    TrackerState: (torch.float32, torch.float32, torch.int32, torch.bool,
                   torch.int32, torch.int32),
    OnsetState: (torch.float32, torch.float32, torch.bool, torch.float32,
                 torch.float32, torch.int32),
    BiquadState: (torch.float32,) * 4,
    GateState: (torch.float32, torch.int32),
    DynamicsState: (torch.float32, torch.int32, torch.bool, torch.float32,
                    torch.int32, torch.bool, torch.float32, torch.int32,
                    torch.int32),
}


def _to_torch(state, cls, device) -> NamedTuple:
    fields = getattr(state, "_fields", None)
    if fields != cls._fields:
        raise ValueError(f"expected a state with fields {cls._fields}, got "
                         f"{fields}")
    return cls(*(torch.from_numpy(np.array(leaf)).to(device=device,
                                                    dtype=dtype)
                 for leaf, dtype in zip(state, STATE_DTYPES[cls])))


def noise_floor_state(state, device="cuda") -> NoiseFloorState:
    """A JAX-package NoiseFloorState (leaves as numpy arrays) → this port's."""
    return _to_torch(state, NoiseFloorState, device)


def tracker_state(state, device="cuda") -> TrackerState:
    """A JAX-package TrackerState (leaves as numpy arrays) → this port's."""
    return _to_torch(state, TrackerState, device)


def onset_state(state, device="cuda") -> OnsetState:
    """A JAX-package OnsetState (leaves as numpy arrays) → this port's."""
    return _to_torch(state, OnsetState, device)


def reducer_state(state, device="cuda") -> ReducerState:
    """A JAX-package ReducerState (leaves as numpy arrays) → this port's."""
    if getattr(state, "_fields", None) != ReducerState._fields:
        raise ValueError(f"expected a state with fields "
                         f"{ReducerState._fields}")
    return ReducerState(_to_torch(state.hp, BiquadState, device),
                        _to_torch(state.lp, BiquadState, device),
                        _to_torch(state.gate, GateState, device))


def dynamics_state(state, device="cuda") -> DynamicsState:
    """A JAX-package DynamicsState (leaves as numpy arrays) → this port's."""
    return _to_torch(state, DynamicsState, device)


def stream_states(states, device="cuda") -> StreamStates:
    """The JAX full step's StreamStates ([B, ...] leaves as numpy arrays) →
    this port's, which `make_batched_full_step` carries on."""
    if getattr(states, "_fields", None) != StreamStates._fields:
        raise ValueError(f"expected states with fields "
                         f"{StreamStates._fields}")
    return StreamStates(reducer_state(states.red, device),
                        dynamics_state(states.dyn, device),
                        noise_floor_state(states.nf, device),
                        tracker_state(states.tr, device),
                        onset_state(states.on, device))


def to_numpy(state: NamedTuple) -> NamedTuple:
    """A port state → the same NamedTuple with numpy leaves; the JAX
    package's class of the same name takes them as `Cls(*leaves)`."""
    return type(state)(*(leaf.detach().cpu().numpy() for leaf in state))


class FusedCarries(NamedTuple):
    """The fused slot program's carries besides the three states, as
    `fused_slot_step` takes them: pending bool [1], the tails float32."""
    pending: torch.Tensor
    p_tail: torch.Tensor
    o_tail: torch.Tensor


def fused_carries(pending, p_tail, o_tail, device="cuda") -> FusedCarries:
    """The JAX engine's fused carries (its `_resident` "pending", "p_tail"
    and "o_tail", as numpy: pending a bool scalar, the tails 1-D) → this
    port's, on `device`.  With the three states converted as above, a port
    engine or `fused_slot_step` continues from the JAX one's mid-session
    state."""
    pending = np.asarray(pending, bool).reshape(-1)
    if pending.shape != (1,):
        raise ValueError(f"pending must be one flag, got shape "
                         f"{np.shape(pending)}")
    tails = tuple(np.asarray(t, np.float32) for t in (p_tail, o_tail))
    if any(t.ndim != 1 for t in tails):
        raise ValueError("the tails must be 1-D")
    return FusedCarries(torch.from_numpy(pending.copy()).to(device),
                        *(torch.from_numpy(t.copy()).to(device)
                          for t in tails))


def pool_carries(nf_state, tr_state, onset_state, pending, p_tail, o_tail,
                 device="cuda") -> PoolCarries:
    """A JAX engine's fused carries, as one of its `EnginePool`'s members
    holds them between waves (the analyzers' unbatched states and the
    `_resident` "pending", "p_tail" and "o_tail"; leaves as numpy) → this
    port's `PoolCarries` on `device`: each state gets its stream axis of
    1.  Set them on a port member (its analyzers' states and `_resident`)
    and the port's pool continues from the JAX pool's mid-session
    state."""
    def batched(state, cls):
        return _to_torch(cls(*(np.asarray(leaf)[None] for leaf in state)),
                         cls, device)
    carries = fused_carries(pending, p_tail, o_tail, device)
    return PoolCarries(batched(nf_state, NoiseFloorState),
                       batched(tr_state, TrackerState),
                       batched(onset_state, OnsetState), *carries)
