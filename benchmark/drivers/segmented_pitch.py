"""Driver of the offline pitch service: `models/segmented.py`
`segmented_pitch_analysis(audio, sample_rate, device_audio=...)` over
long recordings, one call after another (closed loop).

The recordings (a ring of distinct ones, made on the card from the seed,
with a host copy of each) are on the card before the window, as
`analysis.analyze_buffer_segmented` hands its pitch pass the recording it
uploaded once.  A request is one call, from the call to its numpy
results.  Set-up makes the ring and runs `warm_calls` calls.

The check holds one call of the window, drawn from the seed, against the
reference: five segments of its plan, each from its own fifth of the
recording and each holding a section of another kind of scene, analysed
by the reference from fresh states, on every frame of their payloads.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp

import numpy as np

import checks
import scene
import work
from reference import offline as ref

CHECK_SEGMENTS = len(scene.KINDS)


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device,
                 spans):
        import torch
        from audio_analyzer_rs_tpu_torch.models import segmented
        self.torch, self.spans, self.device = torch, spans, device
        self.analyse = segmented.segmented_pitch_analysis
        self.sr = float(config["sample_rate"])
        self.window, self.hop = int(config["window"]), int(config["hop"])
        self.chunk = int(config["chunk_frames"])
        self.warmup = int(config["warmup_frames"])
        self.floor_db = float(config["global_floor_db"])
        section = int(config["section_s"] * self.sr)
        sections = int(round(workload["recording_s"] / config["section_s"]))
        self.n = sections * section
        self.ring_n = int(workload["ring"])
        self.warm_calls = int(workload["warm_calls"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.ring = torch.empty((self.ring_n, self.n), dtype=torch.float32,
                                device=device)
        kinds = [scene.render(sections, section, self.sr, gen,
                              out=self.ring[r].view(sections, section)
                              ).cpu().numpy() for r in range(self.ring_n)]
        self.host = [self.ring[r].cpu().numpy() for r in range(self.ring_n)]
        self.plan = ref.plan(self.n, self.window, self.hop, self.chunk,
                             self.warmup)
        rng = np.random.default_rng(seed)
        self.check_call = self.warm_calls + int(rng.integers(0, 4))
        self.segments = self._segments(
            kinds[self.check_call % self.ring_n], section, rng)
        self.kept = None
        self.i = 0

    def _segments(self, kinds, section: int, rng) -> list[int]:
        """One segment of each kind, each from its own fifth of the plan,
        where the plan allows: a segment is of a kind when its payload
        overlaps a section of it."""
        parts = np.array_split(np.arange(self.plan["segments"]),
                               min(CHECK_SEGMENTS, self.plan["segments"]))
        order = rng.permutation(CHECK_SEGMENTS)
        out = []
        for kind, part in zip(order, parts):
            pick = [s for s in part if kind in self._kinds_of(s, kinds,
                                                               section)]
            out.append(int(rng.choice(pick or list(part))))
        return out

    def _kinds_of(self, s: int, kinds, section: int) -> set:
        lo, hi = ref.payload_range(self.plan, s)
        a = lo * self.hop // section
        b = ((hi - 1) * self.hop + self.window - 1) // section
        return set(kinds[a:min(b, len(kinds) - 1) + 1].tolist())

    def min_requests(self) -> int:
        return self.check_call - self.warm_calls + 1

    def audio_seconds(self) -> float:
        return self.n / self.sr

    def work(self):
        p = self.plan
        return work.segmented_pitch(self.n, p["segments"] * p["stream_frames"],
                                    p["frames"], self.sr, self.window)

    def warm(self):
        for _ in range(self.warm_calls):
            self.request()
            self.after()

    def after(self):
        """Outside the timed request: keep the checked call's results."""
        if self.i - 1 == self.check_call:
            self.kept = (self.out, (self.i - 1) % self.ring_n)
        self.out = None

    def request(self):
        r = self.i % self.ring_n
        with self.spans("call"):
            self.out = self.analyse(self.host[r], self.sr,
                                    window=self.window, hop=self.hop,
                                    chunk_frames=self.chunk,
                                    warmup_frames=self.warmup,
                                    global_floor_db=self.floor_db,
                                    device_audio=self.ring[r],
                                    device=self.device)
        self.i += 1

    def release(self):
        """Free the program's device state before the reference runs."""
        del self.ring
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, control: str | None = None) -> dict:
        (freqs, scores, valid), r = self.kept
        audio = self.host[r]
        precisions = ["float64"] + ([control] if control else [])
        with cf.ProcessPoolExecutor(
                max_workers=min(8, len(self.segments) * len(precisions)),
                mp_context=mp.get_context("spawn")) as pool:
            futs = {(p, s): pool.submit(
                ref.segment, ref.stream_audio(audio, self.plan, s, self.window,
                                           self.hop),
                self.sr, self.floor_db, self.window, self.hop, p)
                for p in precisions for s in self.segments}
            res = {k: f.result() for k, f in futs.items()}
        parts = []
        for s in self.segments:
            lo, hi = ref.payload_range(self.plan, s)
            off = lo - self.plan["starts"][s]
            rf, rs, rv = (a[off:off + hi - lo] for a in res["float64", s])
            if control:
                pf, ps, pv = (a[off:off + hi - lo] for a in res[control, s])
            else:
                pf, ps, pv = freqs[lo:hi], scores[lo:hi], valid[lo:hi]
            parts.append({"pitch": checks.pitch(pf, pv, rf, rv, ps, rs)})
        return checks.summarise(parts)
