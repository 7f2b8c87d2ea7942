"""Driver of the batched full chain: `parallel/sharding.py`
`make_batched_full_step(None, sample_rate)` over B streams, closed loop.

A request is one step: the next chunk of every stream (a ring of
distinct [B, T] chunks made on the card from the seed), the step's
call, and its `FullStepOut` read to host memory: into page-locked
buffers allocated once, as a service that reads every step's results
would keep them (a pageable `.cpu()` of each output made a 128-stream
step take 10.5 to 20 ms from one process to the next on one card).
The streams' states carry from step to step, so the next step follows
the last one's outputs.  Set-up builds the ring and the step and runs
the first `warm_steps` steps from fresh states.

The check follows five streams from the start: a step k of the window
is drawn from the seed, and one stream of each kind of scene that step
sends, each from its own fifth of the batch.  The reference runs each of
them from its own fresh state through the same chunks, steps 0 to k,
and every step's outputs are held against the program's, and the
states after step k against the program's carried state.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp

import numpy as np

import checks
import scene
import work
from reference import chain as ref

CHECK_STREAMS = len(scene.KINDS)


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device,
                 spans):
        import torch
        from audio_analyzer_rs_tpu_torch.parallel import sharding
        self.torch, self.spans, self.device = torch, spans, device
        self.sr = float(config["sample_rate"])
        self.slot = int(config["slot_samples"])
        self.t = int(config["chunk_slots"]) * self.slot
        self.b = int(workload["streams"])
        self.ring_n = int(workload["ring"])
        self.warm_steps = int(workload["warm_steps"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.ring = torch.empty((self.ring_n, self.b, self.t),
                                dtype=torch.float32, device=device)
        self.kinds = [scene.render(self.b, self.t, self.sr, gen,
                                   out=self.ring[r]).cpu().numpy()
                      for r in range(self.ring_n)]
        self.geometry = {k: int(config[k]) for k in (
            "pitch_window", "pitch_hop", "onset_window", "onset_hop")}
        self.kc = work.candidate_band(self.sr,
                                      self.geometry["pitch_window"]) - 1
        self.step = sharding.make_batched_full_step(
            None, self.sr, slot_len=self.slot,
            pitch_hop=self.geometry["pitch_hop"],
            onset_hop=self.geometry["onset_hop"],
            dyn_mode=config["agc"], device=device)
        self.states = sharding.init_stream_states(self.b, device=device)
        rng = np.random.default_rng(seed)
        self.check_step = self.warm_steps + int(rng.integers(0, 4))
        self.lanes = self._lanes(self.check_step, rng)
        self.audio = [self.ring[r][self.lanes].cpu().numpy()
                      for r in range(self.ring_n)]
        self.kept: dict = {}
        self.final = None
        self.pinned = None
        self.i = 0

    def _lanes(self, step: int, rng) -> list[int]:
        """One stream of each kind, each from its own fifth of the batch,
        where the batch allows."""
        kinds = self.kinds[step % self.ring_n]
        q = self.b // CHECK_STREAMS
        order = rng.permutation(CHECK_STREAMS)
        lanes = []
        for j, kind in enumerate(order):
            part = np.arange(j * q, (j + 1) * q)
            pick = part[kinds[part] == kind]
            if not len(pick):
                pick = np.flatnonzero(kinds == kind)
            pick = [p for p in pick if p not in lanes] or list(part)
            lanes.append(int(rng.choice(pick)))
        return lanes

    def min_requests(self) -> int:
        return self.check_step - self.warm_steps + 1

    def audio_seconds(self) -> float:
        return self.b * self.t / self.sr

    def work(self):
        return work.full_step(self.b, self.t, self.sr, slot=self.slot,
                              **self.geometry)

    def warm(self):
        for _ in range(self.warm_steps):
            self.request()
            self.after()

    def after(self):
        """Outside the timed request: keep the checked streams' outputs
        of every step up to the checked one, and their states after it."""
        i = self.i - 1
        if i <= self.check_step:
            self.kept[i] = [h[self.lanes] for h in self.host[:5]]
        if i == self.check_step:
            self.final = _lane_states(self.states, self.lanes, self.kc)
        self.host = None

    def request(self):
        torch = self.torch
        i = self.i
        chunk = self.ring[i % self.ring_n]
        with self.spans("call"):
            states, out = self.step(self.states, chunk)
            done = torch.cuda.Event() if self.device == "cuda" else None
            if done is not None:
                done.record()
        with self.spans("wait"):
            if done is not None:
                done.synchronize()
        with self.spans("readback"):
            if self.pinned is None:
                self.pinned = [torch.empty(
                    t.shape, dtype=t.dtype,
                    pin_memory=self.device == "cuda") for t in out]
            for h, t in zip(self.pinned, out):
                h.copy_(t, non_blocking=True)
            if done is not None:
                done.record()
                done.synchronize()
            self.host = [h.numpy() for h in self.pinned]
        self.states = states
        self.i += 1

    def release(self):
        """Free the program's device state before the reference runs."""
        del self.ring, self.states, self.step
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, control: str | None = None) -> dict:
        steps = self.check_step + 1
        precisions = ["float64"] + ([control] if control else [])
        with cf.ProcessPoolExecutor(
                max_workers=min(8, len(self.lanes) * len(precisions)),
                mp_context=mp.get_context("spawn")) as pool:
            futs = {(p, j): pool.submit(
                ref.follow, [self.audio[i % self.ring_n][j]
                             for i in range(steps)], self.sr, precision=p,
                slot=self.slot, pitch_hop=self.geometry["pitch_hop"],
                onset_hop=self.geometry["onset_hop"])
                    for p in precisions for j in range(len(self.lanes))}
            res = {k: f.result() for k, f in futs.items()}
        parts = []
        for j in range(len(self.lanes)):
            r_outs, r_state = res["float64", j]
            if control:
                p_outs, p_state = res[control, j]
                p_outs = [(o["freqs"], o["valid"], o["fired"], o["velocity"])
                          for o in p_outs]
            else:
                p_outs = [tuple(self.kept[i][k][j] for k in range(4))
                          for i in range(steps)]
                p_state = self.final[j]
            for i, (r, (pf, pv, fired, vel)) in enumerate(zip(r_outs,
                                                              p_outs)):
                part = {"pitch": checks.pitch(pf, pv, r["freqs"],
                                              r["valid"]),
                        "velocity": checks.velocity(vel, r["velocity"]),
                        "onsets": checks.onsets(fired, r["fired"])}
                if i == steps - 1:
                    p_leaves = _leaves(p_state, self.kc)
                    r_leaves = _leaves(r_state, self.kc)
                    part["state"] = {k: (p_leaves[k], r_leaves[k])
                                     for k in r_leaves}
                parts.append(part)
        return checks.summarise(parts)


def _lane_states(states, lanes, kc: int) -> list[dict]:
    """The program's carried state of some streams, in the reference's
    form (the noise floor over the band [0, kc) that the pitch chain
    reads)."""
    def h(t):
        return t[lanes].cpu().numpy()
    red, dyn, nf, tr, on = states
    hp = np.stack([h(v) for v in red.hp], 1)
    lp = np.stack([h(v) for v in red.lp], 1)
    env, hold = h(red.gate.envelope), h(red.gate.hold_remaining)
    dyn_h = {k: h(getattr(dyn, k)) for k in (
        "long_hist", "long_pos", "long_filled", "play_hist", "play_pos",
        "play_filled", "gain_linear")}
    nf_h = {k: h(getattr(nf, k)) for k in (
        "floor", "prev_mag", "volatility", "initialized")}
    tr_h = {k: h(getattr(tr, k)) for k in ("freq", "score", "life",
                                            "valid", "seq")}
    on_h = {k: h(getattr(on, k)) for k in on._fields}
    out = []
    for j in range(len(lanes)):
        order = np.argsort(tr_h["seq"][j], kind="stable")
        tracks = [[float(tr_h["freq"][j][s]), float(tr_h["score"][j][s]),
                   int(tr_h["life"][j][s])]
                  for s in order if tr_h["valid"][j][s]]
        out.append({
            "hp": [float(v) for v in hp[j]], "lp": [float(v) for v in lp[j]],
            "envelope": float(env[j]), "hold": int(hold[j]),
            "long": dyn_h["long_hist"][j].astype(np.float64),
            "long_pos": int(dyn_h["long_pos"][j]),
            "long_filled": bool(dyn_h["long_filled"][j]),
            "play": dyn_h["play_hist"][j].astype(np.float64),
            "play_pos": int(dyn_h["play_pos"][j]),
            "play_filled": bool(dyn_h["play_filled"][j]),
            "gain": float(dyn_h["gain_linear"][j]),
            "nf": {"floor": nf_h["floor"][j][:kc].astype(np.float64),
                   "prev": nf_h["prev_mag"][j][:kc].astype(np.float64),
                   "vol": nf_h["volatility"][j][:kc].astype(np.float64),
                   "init": bool(nf_h["initialized"][j])},
            "tracks": tracks,
            "on_prev": on_h["prev_mag"][j].astype(np.float64),
            "on_floor": on_h["floor"][j].astype(np.float64),
            "on_init": bool(on_h["floor_init"][j]),
            "threshold": float(on_h["threshold"][j]),
            "energy_ema": float(on_h["energy_ema"][j]),
            "frames_since": int(on_h["frames_since_onset"][j])})
    return out


def _leaves(st: dict, kc: int) -> dict:
    """The carried state's leaves the check compares: the AGC's gain, the
    pitch floors over the band, the onset floors and flux trackers.  (The
    reducer's biquad and gate state is left out: its float32 drift over a
    chunk, ~1e-4, is as large as the control's gap on the other leaves.)"""
    return {"agc_gain": np.array([st["gain"]]),
            "pitch_floor": st["nf"]["floor"][:kc],
            "onset_floor": st["on_floor"],
            "onset_flux": np.array([st["threshold"], st["energy_ema"]])}

