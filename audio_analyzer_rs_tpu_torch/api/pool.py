"""EnginePool — K live AudioEngines, ONE batched slot program a wave (port of
audio_analyzer_rs_tpu/api/pool.py).

The reference runs exactly one realtime engine per process (its engine owns
the cpal device callbacks and global singletons, ref src/audio_io/mod.rs:
960-1129); serving K simultaneous live sessions means K processes.  A single
engine's slot program is a few hundred small launches that leave the card
idle most of the slot, so K sessions share it: the pool steps its member
engines in lockstep, collects each engine's fused-eligible slot, and runs
the whole wave as the C lanes of one program
(models/analyzer.fused_slot_pool_step), so each kernel launches once a wave
at S = C, with ONE packed deferred readback a wave.  `aggregate_slots`
additionally chains A waves a dispatch.

Per-engine semantics are unchanged: between waves every engine owns its
carries (per-engine views of the wave's stacked tensors), so any member can
leave the pool, checkpoint (checkpoint.save_engine flushes via
engine.flush_analysis -> pool.flush), pause a flow (it falls back to its
own sequential path and skips waves), or be driven solo, at any wave
boundary.  Every output and carry equals K independently driven engines,
bit for bit (tests/test_torch_pool.py; the JAX package allows its
noise-floor leaves ulp drift, which this port does not need).

Usage:
    pool = EnginePool([e1, e2, ...], pipeline_depth=1, aggregate_slots=4)
    pool.run_realtime(10.0)      # or pool.advance(seconds)
    ...poll each engine's tuner/onset surfaces as usual...
    pool.flush()                 # surface any deferred wave results
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from ..models.analyzer import (PoolCarries, fused_slot_pool_step,
                               slot_frame_counts, unpack_fused_pool_out)
from .engine import Readback, upload


class _Entry(NamedTuple):
    engine: object
    slot: np.ndarray
    pc: object
    oc: object
    host_vec: np.ndarray
    meta: tuple       # (n_p, n_o, p_base, o_base, tick_sup, anchor)
    p_len: int
    o_len: int
    hold: bool
    mirrors: tuple    # pre-slot host mirrors (p_tail, o_tail, fc_p, fc_o)


class EnginePool:
    """Lockstep scheduler over K AudioEngines sharing one device.

    `pipeline_depth` / `aggregate_slots` mirror the single-engine knobs
    (api/engine.py) but apply per WAVE: depth defers each dispatch's
    packed readback by N dispatches; aggregation chains A waves into one
    dispatch.  A member whose latency calibration is still running is
    dispatched per wave in its own group, SPECULATIVELY: calibration
    acceptance rewrites that engine's onset scan state between slots (ref
    onset.rs:404-440), but the transition happens at most ONCE (click
    acceptance or timeout), so each wave dispatches the next calibration
    slot optimistically and drains the previous wave's result afterwards.
    When a drained result IS the transition
    (`_OnsetConsumer._calibration_transition`), the one in-flight
    speculative dispatch is rolled back (no op writes into a carry, so the
    snapshot is the pre-dispatch tensors) and the slot is rebuilt with
    post-transition inputs and redispatched: the solo engine's synchronous
    order.  The other members keep their aggregation and pipelining, so a
    student joining mid-class does not stall the classroom.  Every
    dispatch is padded with inert lanes up to `capacity`, so a wave keeps
    one shape through joins, leaves and calibration splits.
    """

    def __init__(self, engines=(), pipeline_depth: int = 0,
                 aggregate_slots: int = 1, capacity: int = 0):
        # `capacity`: provision dispatch lanes for this many members (the
        # serving analog of a max batch size).  Every dispatch is padded
        # with inert lanes to max(wave size, member count, capacity), so
        # any membership up to capacity runs waves of one shape.  0
        # (default) provisions for the current member count.
        self.capacity = max(int(capacity), 0)
        self._engines: List = []
        self._collect = None      # non-None while a wave is being collected
        self._queue: List[dict] = []   # deferred packed readbacks (FIFO)
        # Calibrating members' per-wave dispatches (drained with a
        # one-wave lag at the next _wave_dispatch — see there).
        self._hold_queue: List[dict] = []
        self._acc = None          # accumulating aggregate of waves
        self._dummies: dict = {}  # inert pad lanes, cached per geometry
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self.aggregate_slots = max(int(aggregate_slots), 1)
        self.waves = 0            # observability: dispatched wave count
        self._agg_dispatches = 0  # observability: aggregate dispatches
        self._rollbacks = 0       # observability: speculative rollbacks
        self._wave_no = 0         # monotonic wave id (speculation ordering)
        self._pad_high = 0        # high-water dispatch lanes (see below)
        for e in engines:
            self.add(e)

    # ── membership ───────────────────────────────────────────────────────

    def add(self, engine) -> None:
        if engine._pool is self:
            return
        if engine._pool is not None:
            raise ValueError("engine already belongs to another pool")
        if self._engines:
            e0 = self._engines[0]
            if (engine.sample_rate != e0.sample_rate
                    or engine.buffer_size != e0.buffer_size):
                raise ValueError(
                    "pool engines must share sample_rate and buffer_size")
            if engine.torch_device != e0.torch_device:
                raise ValueError(
                    f"pool engines must share one torch device "
                    f"({engine.torch_device} != {e0.torch_device})")
        engine._pool = self
        self._engines.append(engine)

    def remove(self, engine) -> None:
        """Detach an engine (its deferred results surface first)."""
        if engine not in self._engines:
            return
        self.flush()
        engine._pool = None
        self._engines.remove(engine)

    @property
    def engines(self):
        return tuple(self._engines)

    # ── lockstep stepping ────────────────────────────────────────────────

    def advance(self, seconds: float) -> None:
        """Run virtual time forward on every member engine, one slot wave
        per buffer period (the pool twin of AudioEngine.advance)."""
        if not self._engines:
            return
        e0 = self._engines[0]
        n = int(round(seconds * e0.sample_rate)) // e0.buffer_size
        for _ in range(n):
            self.step_wave()

    def run_realtime(self, seconds: float) -> None:
        """Wall-clock-paced lockstep (the pool twin of run_realtime)."""
        if not self._engines:
            return
        e0 = self._engines[0]
        period = e0.buffer_size / e0.sample_rate
        n = int(round(seconds * e0.sample_rate)) // e0.buffer_size
        next_t = time.monotonic()
        for _ in range(n):
            self.step_wave()
            next_t += period
            sleep = next_t - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)

    def step_wave(self) -> None:
        """Advance every engine one buffer; fused-eligible slots batch into
        one device dispatch (engines whose fused conditions lapsed — a
        paused flow — consume sequentially inside their own device step and
        simply skip the wave).

        The collected wave is dispatched even if a member's step raised:
        the members stepped before it already advanced their transports and
        reducers for this buffer, and dropping their slots would leave them
        a slot behind their own clocks.  The step's exception is then
        re-raised; if the dispatch raises too, the step's exception is
        re-raised with the dispatch error as its cause."""
        self._collect = []
        step_error = None
        try:
            for e in self._engines:
                e.device.step()
        except BaseException as exc:
            step_error = exc
        entries, self._collect = self._collect, None
        if entries:
            try:
                self._wave_dispatch(entries)
            except BaseException as dispatch_error:
                if step_error is None:
                    raise
                raise step_error from dispatch_error
        if step_error is not None:
            raise step_error
        for e in self._engines:
            e._practice_ticks()

    # ── wave dispatch ────────────────────────────────────────────────────

    def _wave_dispatch(self, collected) -> None:
        self._wave_no += 1

        # Validate analyzer geometry BEFORE any host state advances: a
        # mismatched member must be rejected while every engine's host
        # mirrors still agree with its device carries.
        g0 = None
        for (e, slot, pc, oc) in collected:
            g = (pc.analyzer.window, pc.analyzer.hop, pc.analyzer.backend,
                 oc.analyzer.window, oc.analyzer.hop, oc.analyzer.backend)
            if g0 is None:
                g0 = g
            elif g != g0:
                raise ValueError("pool engines must share analyzer geometry")

        prepared: List[_Entry] = []
        for (e, slot, pc, oc) in collected:
            slot = np.asarray(slot, np.float32)
            res = e._resident
            if res is None:
                # Entering fused mode under the pool: the single-engine
                # path's residency (api/engine.py _enter_fused).
                res = e._enter_fused(pc, oc)
            while res["queue"]:
                # Solo-driven deferred results predate this wave: surface
                # them first so per-engine slot order is preserved.
                e._fused_drain_entry(res["queue"].pop(0), pc, oc)
            hv, n_p, n_o, tick_sup, hold, p_len, o_len = \
                e._fused_inputs(slot, pc, oc)
            meta = (n_p, n_o, pc.analyzer.frames_consumed,
                    oc.analyzer.frames_consumed, tick_sup,
                    e._stamp_anchor())
            # Pre-slot host mirrors: a speculative calibration dispatch
            # that gets invalidated rebuilds this slot's inputs from these
            # (see _redispatch_lane).
            mirrors = (pc.analyzer._tail, oc.analyzer._tail,
                       pc.analyzer.frames_consumed,
                       oc.analyzer.frames_consumed)
            prepared.append(_Entry(e, slot, pc, oc, hv, meta, p_len, o_len,
                                   hold, mirrors))
        for en in prepared:
            en.engine._fused_slots += 1
            en.engine._fused_advance_host(en.slot, en.pc, en.oc,
                                          en.meta[0], en.meta[1])

        # Every dispatch below is padded to the provisioned lane count, so
        # a calibration split, a paused member, a join below capacity or a
        # member leaving keeps the wave's shape.  The high-water mark keeps
        # it from shrinking after a remove().
        self._pad_high = max(self._pad_high, len(prepared),
                             len(self._engines), self.capacity)
        pad_to = self._pad_high

        # Calibrating members: per-wave dispatch in their own group(s),
        # SPECULATIVE: dispatched now with optimistically built inputs,
        # drained at the END of the next wave, rolled back and rebuilt in
        # the at-most-one wave where the calibration transition lands.
        # The steady members below keep their aggregation and pipelining.
        holds = [en for en in prepared if en.hold]
        hgroups: dict = {}
        for en in holds:
            hgroups.setdefault((len(en.slot), en.p_len, en.o_len),
                               []).append(en)
        for key, entries in hgroups.items():
            slot_len, p_len, o_len = key
            wave = [(en.engine, en.pc, en.oc) for en in entries]
            payload = [(en.host_vec, en.meta) for en in entries]
            spec = [{"slot": en.slot, "mirrors": en.mirrors}
                    for en in entries]
            self._dispatch_group(wave, [payload], slot_len, p_len, o_len,
                                 depth=0, pad_to=pad_to, hold=True,
                                 spec=spec)

        # Steady members share ring-tail geometry in lockstep; a mixed wave
        # (an engine mid-(re)join with different tails) splits into
        # per-geometry groups, each its own dispatch.
        steady = [en for en in prepared if not en.hold]
        groups: dict = {}
        for en in steady:
            groups.setdefault((len(en.slot), en.p_len, en.o_len),
                              []).append(en)
        multi_group = len(groups) > 1
        for key, entries in groups.items():
            slot_len, p_len, o_len = key
            wave = [(en.engine, en.pc, en.oc) for en in entries]
            payload = [(en.host_vec, en.meta) for en in entries]
            agg = self.aggregate_slots
            if agg <= 1 or multi_group:
                self._flush_acc()
                self._dispatch_group(wave, [payload], slot_len, p_len,
                                     o_len, self.pipeline_depth,
                                     pad_to=pad_to)
                continue
            acc = self._acc
            if acc is not None and (acc["wave"] != wave
                                    or acc["next"] != key
                                    or acc["pad_to"] != pad_to):
                self._flush_acc()
                acc = None
            if acc is None:
                acc = self._acc = {
                    "wave": wave, "slot_len": slot_len, "p_len0": p_len,
                    "o_len0": o_len, "payloads": [], "next": key,
                    "pad_to": pad_to,
                }
            acc["payloads"].append(payload)
            # Advance the expected tail geometry for the next wave.
            pa, oa = wave[0][1].analyzer, wave[0][2].analyzer
            p_next, o_next = self._next_tails(pa, oa, slot_len, p_len, o_len)
            acc["next"] = (slot_len, p_next, o_next)
            if len(acc["payloads"]) >= agg:
                self._flush_acc()

        # Drain last wave's calibration results LAST: by now this wave's
        # dispatches are queued, so the readback had a slot period to land.
        # The rollback machinery in _drain_entry restores the solo order:
        # the result being drained decides whether the speculative dispatch
        # issued above stays valid.  (Entries appended during the drain —
        # a rebuilt slot — carry the current wave id and stay queued.)
        while (self._hold_queue
               and self._hold_queue[0]["wave_no"] < self._wave_no):
            self._drain_entry(self._hold_queue.pop(0))

    @staticmethod
    def _next_tails(pa, oa, slot_len: int, p_len: int, o_len: int):
        """The ring tails' lengths after one more slot."""
        (n_p, n_o), = slot_frame_counts(slot_len, 1, p_len, o_len,
                                        pa.window, pa.hop, oa.window, oa.hop)
        return p_len + slot_len - n_p * pa.hop, o_len + slot_len - n_o * oa.hop

    def _flush_acc(self) -> None:
        acc, self._acc = self._acc, None
        if not acc or not acc["payloads"]:
            return
        if len(acc["payloads"]) >= self.aggregate_slots:
            self._dispatch_group(acc["wave"], acc["payloads"],
                                 acc["slot_len"], acc["p_len0"],
                                 acc["o_len0"], self.pipeline_depth,
                                 pad_to=acc["pad_to"])
            return
        # A partial chain (flush mid-aggregate, membership change)
        # decomposes into per-wave dispatches, as the JAX package does;
        # per-wave dispatch is the reference semantics, so it is exact.
        pa, oa = acc["wave"][0][1].analyzer, acc["wave"][0][2].analyzer
        slot_len = acc["slot_len"]
        p_len, o_len = acc["p_len0"], acc["o_len0"]
        for payload in acc["payloads"]:
            self._dispatch_group(acc["wave"], [payload], slot_len, p_len,
                                 o_len, self.pipeline_depth,
                                 pad_to=acc["pad_to"])
            p_len, o_len = self._next_tails(pa, oa, slot_len, p_len, o_len)

    @staticmethod
    def _dummy_state(pa, oa, p_len: int, o_len: int, device) -> PoolCarries:
        """An inert lane for dispatch padding: fresh analyzer states and
        zero ring tails at the group's geometry.  Its outputs are never
        posted and its next state is discarded."""
        from ..ops import noisefloor, onset as onset_ops, tracker

        return PoolCarries(
            noisefloor.init_state(pa.window // 2 + 1, device, (1,)),
            tracker.init_state(device, (1,)),
            onset_ops.init_state(oa.window // 2 + 1, device, (1,)),
            torch.zeros(1, dtype=torch.bool, device=device),
            torch.zeros(p_len, dtype=torch.float32, device=device),
            torch.zeros(o_len, dtype=torch.float32, device=device))

    def _dispatch_group(self, wave, payloads, slot_len: int, p_len0: int,
                        o_len0: int, depth: int, pad_to: int = 0,
                        hold: bool = False, spec=None,
                        count_wave: bool = True) -> None:
        """Dispatch one group: `wave` = [(engine, pc, oc)] (K members),
        `payloads` = [per-wave [(host_vec, meta)] aligned with `wave`]
        (A chained sub-slots).  ONE upload of the [C, L] host vectors, one
        `fused_slot_pool_step` (each kernel launched once at S = C), ONE
        packed deferred readback.  Lanes are padded with inert states up to
        `pad_to`; `hold=True` queues the readback on the calibration queue
        (drained at the end of the NEXT wave) instead of the pipelined one,
        with `spec` (per-lane {"slot", "mirrors"}) carrying what a rollback
        needs: this method adds each lane's pre-dispatch carries ("snap",
        the very tensors about to be replaced)."""
        K, A = len(wave), len(payloads)
        e0, pc0, oc0 = wave[0]
        pa0, oa0 = pc0.analyzer, oc0.analyzer
        rows = [np.concatenate([payloads[a][k][0] for a in range(A)])
                for k in range(K)]
        states = []
        for (e, pc, oc) in wave:
            res = e._resident
            states.append(PoolCarries(
                pc.analyzer.nf_state, pc.analyzer.tr_state,
                oc.analyzer.state, res["pending"], res["p_tail"],
                res["o_tail"]))
        lanes = max(pad_to, K)
        if lanes > K:
            # One cached inert lane per geometry, shared by every pad lane
            # of every wave: carries are never written, so it stays fresh.
            key = (pa0.window, oa0.window, p_len0, o_len0)
            dummy = self._dummies.get(key)
            if dummy is None:
                dummy = self._dummies[key] = self._dummy_state(
                    pa0, oa0, p_len0, o_len0, e0.torch_device)
            rows.extend(np.zeros_like(rows[0]) for _ in range(lanes - K))
            states.extend(dummy for _ in range(lanes - K))
        new_states, packed = fused_slot_pool_step(
            states, upload(np.stack(rows), e0.torch_device), e0.sample_rate,
            slot_len, A, pa0.window, pa0.hop, oa0.window, oa0.hop,
            pa0.backend, oa0.backend)
        for (e, pc, oc), st in zip(wave, new_states):
            pc.analyzer.nf_state, pc.analyzer.tr_state = st[0], st[1]
            oc.analyzer.state = st[2]
            res = e._resident
            res["pending"], res["p_tail"], res["o_tail"] = st[3], st[4], st[5]
        if count_wave:
            self.waves += A
        if A > 1:
            self._agg_dispatches += 1
        # Per-sub-slot frame counts are shared by the group (engine 0's
        # metas); metas stay per engine for posting.
        entry = {
            "readback": Readback(packed), "wave": wave, "lanes": lanes,
            "frame_counts": [(payloads[a][0][1][0], payloads[a][0][1][1])
                             for a in range(A)],
            "metas": [[payloads[a][k][1] for k in range(K)]
                      for a in range(A)],
        }
        if spec is not None:
            for k in range(K):
                spec[k]["snap"] = states[k]
            entry["spec"] = spec
            entry["invalid"] = set()
            entry["wave_no"] = self._wave_no
        if hold:
            # Drained one wave after dispatch (speculative order, see
            # _wave_dispatch); its device->host copy is already queued
            # behind the wave, so it lands while the host paces.
            self._hold_queue.append(entry)
            return
        self._queue.append(entry)
        while len(self._queue) > depth:
            self._drain_entry(self._queue.pop(0))

    def _drain_entry(self, q: dict) -> None:
        outs = unpack_fused_pool_out(q["readback"].wait(), q["lanes"],
                                     q["frame_counts"])
        spec = q.get("spec")
        invalid = q.get("invalid", ())
        for a, per_engine in enumerate(outs):
            # Padded lanes (beyond the real wave) are inert: drop them.
            for k, out in enumerate(per_engine[:len(q["wave"])]):
                if k in invalid:
                    # This lane's dispatch was speculative and a
                    # calibration transition invalidated it; the slot was
                    # rebuilt and redispatched: discard these results.
                    continue
                e, pc, oc = q["wave"][k]
                meta = q["metas"][a][k]
                if spec is not None and oc._calibration_transition(
                        out.onset, meta[3], meta[5]):
                    # The at-most-once calibration transition: the NEWER
                    # in-flight speculative dispatch (if any) ran from
                    # pre-transition state with pre-transition inputs.
                    # Roll its lane back BEFORE posting (acceptance's
                    # scan-state rewrite must land on the post-this-slot
                    # state, the solo synchronous order), post, then
                    # rebuild and redispatch that slot.
                    newer = self._find_inflight(e, q["wave_no"])
                    if newer is not None:
                        nq, lane = newer
                        e._rollback_spec(pc, oc, nq["spec"][lane]["snap"])
                        nq["invalid"].add(lane)
                        self._rollbacks += 1
                    e._fused_post((out,) + meta, pc, oc)
                    if newer is not None:
                        self._redispatch_lane(e, pc, oc, nq["spec"][lane])
                        # Post the rebuilt slot NOW (one blocking read,
                        # once a calibration): deferring it to the next
                        # wave's end would let the engine's first steady
                        # slot post before it at pipeline_depth=0.
                        self._drain_entry(self._hold_queue.pop())
                    continue
                e._fused_post((out,) + meta, pc, oc)

    def _find_inflight(self, engine, older_wave_no: int):
        """The (at most one) queued speculative dispatch of `engine` newer
        than `older_wave_no`: (entry, lane) or None."""
        for q in self._hold_queue:
            if q.get("wave_no", -1) <= older_wave_no:
                continue
            for lane, (e, _, _) in enumerate(q["wave"]):
                if e is engine and lane not in q["invalid"]:
                    return q, lane
        return None

    def _redispatch_lane(self, engine, pc, oc, info) -> None:
        """Rebuild an invalidated speculative slot with post-transition
        inputs (AudioEngine._rebuild_inputs) and dispatch it as a 1-member
        hold group, padded to the wave's lanes."""
        hv, meta, p_len, o_len = engine._rebuild_inputs(pc, oc, info)
        self._dispatch_group(
            [(engine, pc, oc)], [[(hv, meta)]], len(info["slot"]),
            p_len, o_len, 0,
            pad_to=self._pad_high, hold=True, count_wave=False,
            spec=[{"slot": info["slot"], "mirrors": info["mirrors"]}])

    def flush(self) -> None:
        """Surface every deferred wave result now (engine.flush_analysis /
        checkpoint.save_engine on any member routes here)."""
        while self._hold_queue:
            self._drain_entry(self._hold_queue.pop(0))
        self._flush_acc()
        while self._queue:
            self._drain_entry(self._queue.pop(0))

    # ── cold start ───────────────────────────────────────────────────────

    def prepare(self) -> dict:
        """Warm the pool's wave programs before the first live wave (the
        pool twin of AudioEngine.prepare): the kernels' build, the cuFFT
        plans at the wave's batch, one launch of each kernel at each
        ring-tail geometry.

        A scratch pool of max(members, capacity) throwaway engines with
        this pool's configuration and device streams silence through the
        REAL wave path in two phases: first uncalibrated (every wave a
        calibration-hold dispatch walking the ring-tail ramp, like a live
        classroom's first ~2 s), then with calibration marked done (the
        steady aggregate waves).  Every live dispatch is padded to the
        provisioned lanes, so these are the shapes a mid-session join or
        calibration split runs too.

        Returns {"variants": [(p_tail, o_tail), ...], "seconds": {...},
        "total_s": s} with the JAX package's keys ("pool<K>_<p>_<o>",
        "pool<K>_agg<A>_<p>_<o>"); on CUDA each wave's stream is waited
        on."""
        from .device import ArraySource
        from .engine import AudioEngine, _OnsetConsumer, _PitchConsumer
        from ..ops.stft import PITCH_WINDOW

        if not self._engines:
            raise ValueError("pool has no members to prepare for")
        e0 = self._engines[0]
        dev = e0.torch_device
        K = max(len(self._engines), self.capacity)
        agg = self.aggregate_slots
        # Ramp length adapts to buffer size (see AudioEngine.prepare).
        ramp_cap = max(16, 2 * (PITCH_WINDOW // e0.buffer_size) + 8)
        n_agg = 2 * agg if agg > 1 else 0
        scratch = []
        for _ in range(K):
            e = AudioEngine(
                input_source=ArraySource(
                    np.zeros((ramp_cap + n_agg + 1) * e0.buffer_size,
                             np.float32)),
                sample_rate=e0.sample_rate, buffer_size=e0.buffer_size,
                device=dev)
            e.start_tuner()
            e.start_onset_detection()
            scratch.append(e)
        spool = EnginePool(scratch, pipeline_depth=self.pipeline_depth,
                           aggregate_slots=agg)
        cons = []
        for e in scratch:
            pc = next(c for c in e._consumers.values()
                      if isinstance(c, _PitchConsumer))
            oc = next(c for c in e._consumers.values()
                      if isinstance(c, _OnsetConsumer))
            cons.append((pc, oc))
        seen: list = []
        seconds: dict = {}
        t_all = time.perf_counter()

        def timed_wave() -> float:
            t0 = time.perf_counter()
            spool.step_wave()
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            return time.perf_counter() - t0

        # Phase 1: every member calibrating: per-wave hold dispatches walk
        # the ramp until it cycles.
        pc0, oc0 = cons[0]
        for _ in range(ramp_cap):
            variant = (len(pc0.analyzer._tail), len(oc0.analyzer._tail))
            if variant in seen:
                break   # the ramp cycled: every variant has run
            seconds[f"pool{K}_{variant[0]}_{variant[1]}"] = timed_wave()
            seen.append(variant)
        # Phase 2: calibration done: aggregation engages.
        for e, (pc, oc) in zip(scratch, cons):
            oc.calibration_done = True
            e.transport.set_calibration_offset(0)
        for _ in range(n_agg):
            variant = (len(pc0.analyzer._tail), len(oc0.analyzer._tail))
            before = spool._agg_dispatches
            dt = timed_wave()
            if spool._agg_dispatches > before:
                seconds.setdefault(
                    f"pool{K}_agg{agg}_{variant[0]}_{variant[1]}", dt)
        if agg > 1 and spool._agg_dispatches < 2:
            raise RuntimeError(
                f"EnginePool.prepare(): expected >= 2 aggregate dispatches "
                f"in phase 2, saw {spool._agg_dispatches}")
        spool.flush()
        return {"variants": seen, "seconds": seconds,
                "total_s": time.perf_counter() - t_all}
