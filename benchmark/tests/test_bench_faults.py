"""The check catches a broken timed path: each run below skips the
harness's look for a card, drives the rest of a run at a CPU size with a
fault planted under the entry the window drives, and must read
`correct` false against the real cells' limits.  The faults: a step that
returns its state unchanged; half of the batch left out, the fleet mean
taken over the rest; an answer altered where it is produced (a stable
frequency 1% off; in the full chain also every other onset dropped, or
an onset added every 100 frames).  (The cells run on one card, so no
exchange between cards can be left out.)  The sound run must read
true."""

from __future__ import annotations

import pytest
import torch

import run

from audio_analyzer_rs_tpu_torch.models import segmented
from audio_analyzer_rs_tpu_torch.parallel import sharding

SEED = 2 ** 31 + 4242


def broken_full_step(fault: str):
    real = sharding.make_batched_full_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def run_step(states, audio):
            if fault == "half_batch":
                half = audio.shape[0] // 2
                part = type(states)(*(torch.utils._pytree.tree_map(
                    lambda t: t[:half], s) for s in states))
                new, out = step(part, audio[:half])
                pad = [torch.zeros((audio.shape[0] - half,) + t.shape[1:],
                                   dtype=t.dtype, device=t.device)
                       for t in out[:5]]
                out = out._replace(**{f: torch.cat([t, p]) for f, t, p in zip(
                    out._fields, out[:5], pad)})
                new = type(states)(*(torch.utils._pytree.tree_map(
                    lambda a, b: torch.cat([a, b[half:]]), n, s)
                    for n, s in zip(new, states)))
                return new, out
            new, out = step(states, audio)
            if fault == "state_unchanged":
                return states, out
            if fault == "answer_altered":
                return new, out._replace(stable_freqs=out.stable_freqs * 1.01)
            fired = out.onset_fired
            if fault == "onsets_dropped":
                nth = fired.to(torch.int64).cumsum(1)
                return new, out._replace(onset_fired=fired & (nth % 2 == 0))
            if fault == "onsets_added":
                every = torch.arange(fired.shape[1],
                                     device=fired.device) % 100 == 0
                return new, out._replace(onset_fired=fired | every)
            return new, out
        return run_step
    return make


def broken_segment_step(fault: str):
    real = segmented._vmapped_step

    def step(nf, tr, audio, gf, onsets, *args, **kwargs):
        if fault == "half_batch":
            half = audio.shape[0] // 2
            cut = [torch.utils._pytree.tree_map(lambda t: t[:half], s)
                   for s in (nf, tr)]
            nf2, tr2, out = real(*cut, audio[:half], gf[:half],
                                 onsets[:half], *args, **kwargs)
            out = type(out)(*(torch.cat([t, torch.zeros(
                (audio.shape[0] - half,) + t.shape[1:], dtype=t.dtype,
                device=t.device)]) for t in out))
            join = [type(s)(*(torch.cat([a, b[half:]]) for a, b in zip(n, s)))
                    for n, s in ((nf2, nf), (tr2, tr))]
            return join[0], join[1], out
        nf2, tr2, out = real(nf, tr, audio, gf, onsets, *args, **kwargs)
        if fault == "state_unchanged":
            return nf, tr, out
        if fault == "answer_altered":
            return nf2, tr2, out._replace(stable_freqs=out.stable_freqs * 1.01)
        return nf2, tr2, out
    return step


FAULTS = ["sound", "state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS + ["onsets_dropped",
                                            "onsets_added"])
def test_full_step_faults_read_incorrect(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(sharding, "make_batched_full_step",
                        broken_full_step(fault))
    result = run.run_cell("tiny48k.b8", SEED, 0.5, False, root=tiny_root,
                          device="cpu")
    assert result["correct"] is (fault == "sound"), result["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_segmented_pitch_faults_read_incorrect(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(segmented, "_vmapped_step", broken_segment_step(fault))
    result = run.run_cell("tiny44k.min", SEED, 0.5, False, root=tiny_root,
                          device="cpu")
    assert result["correct"] is (fault == "sound"), result["checks"]
