"""ClockManager — student-tempo estimation + transport action decisions.

Port of ref src/practice/clock.rs:1-217: per-match local-tempo EWMA (α=0.4),
hesitation tempo when the frontier is overdue, FollowAlong stop-before-next-
unplayed (ε=0.001), seek rules (FollowAlong when |timing_err| > 15% of
duration; Rubato always; Performance never), SetBpm after a 3-streak of ±8%
deviation, doubled-note seek-back.  Returns ClockActions; never mutates the
transport itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .buffer import MeasureBuffer, NoteSlot, PENDING
from .types import Matched, Play, SeekToBeat, SetBpm, Stop


@dataclass
class ClockConfig:
    seek_threshold_pct: float = 0.15
    bpm_change_threshold_pct: float = 0.08
    bpm_change_streak: int = 3
    stop_lead_epsilon: float = 0.001
    seek_landing_epsilon: float = 0.001
    ewma_alpha: float = 0.4


class ClockManager:
    def __init__(self, transport, cfg: Optional[ClockConfig], initial_bpm: float):
        self.transport = transport
        self.cfg = cfg or ClockConfig()
        self.bpm_ewma = float(initial_bpm)
        self.streak_late = 0
        self.streak_early = 0
        self.last_match_real_beat: Optional[float] = None
        self.last_match_expected_beat: Optional[float] = None
        self.stopped_for_unplayed = False
        self.hesitation_tempo: Optional[float] = None

    def t_stu_bpm(self) -> float:
        return (self.hesitation_tempo if self.hesitation_tempo is not None
                else self.bpm_ewma)

    def on_doubled(self, slot: NoteSlot, mode: str) -> List:
        """ref clock.rs:69-77."""
        if mode == "Performance":
            return []
        if slot.matched_start_beat is None:
            return []
        return [SeekToBeat(slot.matched_start_beat + self.cfg.seek_landing_epsilon),
                Play()]

    def on_extra(self) -> List:
        return []

    def on_tick(self, buf: MeasureBuffer, frontier, transport_beat: float,
                mode: str) -> List:
        """ref clock.rs:80-131."""
        slot = buf.slot(frontier)
        frontier_pending = slot is not None and slot.status.kind == PENDING
        if frontier_pending:
            m = buf.measures[frontier[0]]
            frontier_beat = (m.global_start_beat
                             + m.notes[frontier[1]].start_beat_in_measure)
            if transport_beat > frontier_beat:
                if (self.last_match_real_beat is not None
                        and self.last_match_expected_beat is not None):
                    real_diff = transport_beat - self.last_match_real_beat
                    exp_diff = frontier_beat - self.last_match_expected_beat
                    if real_diff > 1e-6 and exp_diff > 0.0:
                        self.hesitation_tempo = (exp_diff / real_diff
                                                 * self.transport.get_bpm())
            else:
                self.hesitation_tempo = None
        else:
            self.hesitation_tempo = None

        if mode != "FollowAlong" or self.stopped_for_unplayed or not frontier_pending:
            return []

        nxt = buf.next_pending_after(frontier)
        if nxt is None:
            return []
        m = buf.measures[nxt[0]]
        next_beat = m.global_start_beat + m.notes[nxt[1]].start_beat_in_measure
        if transport_beat >= next_beat - self.cfg.stop_lead_epsilon:
            self.stopped_for_unplayed = True
            return [Stop()]
        return []

    def on_match(self, outcome, expected, transport_beat: float,
                 mode: str) -> List:
        """ref clock.rs:133-216."""
        if not isinstance(outcome, Matched):
            return []
        actions: List = []
        current_bpm = self.transport.get_bpm()

        if (self.last_match_real_beat is not None
                and self.last_match_expected_beat is not None):
            real_diff = transport_beat - self.last_match_real_beat
            exp_diff = expected.beat_position - self.last_match_expected_beat
            if real_diff > 1e-6:
                local_tempo = (exp_diff / real_diff) * current_bpm
                a = self.cfg.ewma_alpha
                self.bpm_ewma = a * local_tempo + (1.0 - a) * self.bpm_ewma
                pct = self.cfg.bpm_change_threshold_pct
                if local_tempo < current_bpm * (1.0 - pct):
                    self.streak_late += 1
                    self.streak_early = 0
                elif local_tempo > current_bpm * (1.0 + pct):
                    self.streak_early += 1
                    self.streak_late = 0
                else:
                    self.streak_late = 0
                    self.streak_early = 0
        self.last_match_real_beat = transport_beat
        self.last_match_expected_beat = expected.beat_position
        self.hesitation_tempo = None

        if mode == "FollowAlong":
            threshold = expected.duration_beats * self.cfg.seek_threshold_pct
            must_seek = (abs(outcome.timing_err) > threshold
                         or self.stopped_for_unplayed)
            if must_seek:
                eps = self.cfg.seek_landing_epsilon
                target = (expected.beat_position - eps
                          if transport_beat < expected.beat_position
                          else expected.beat_position + eps)
                actions.append(SeekToBeat(target))
            actions.append(Play())
            self.stopped_for_unplayed = False
        elif mode == "Rubato":
            eps = self.cfg.seek_landing_epsilon
            target = (expected.beat_position - eps
                      if transport_beat < expected.beat_position
                      else expected.beat_position + eps)
            actions.append(SeekToBeat(target))
            actions.append(Play())

        if mode != "Performance" and (
                self.streak_late >= self.cfg.bpm_change_streak
                or self.streak_early >= self.cfg.bpm_change_streak):
            pct = self.cfg.bpm_change_threshold_pct
            dev = abs(self.bpm_ewma - current_bpm) / max(current_bpm, 1.0)
            if dev > pct:
                actions.append(SetBpm(self.bpm_ewma))
                self.streak_late = 0
                self.streak_early = 0
        return actions
