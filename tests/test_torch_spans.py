"""The port's host spans (spans.py) inside the batched full step
(parallel/sharding.py `make_batched_full_step`), on the CPU: with spans on,
one "full_step" a call with its four stages nested inside it in order;
with spans off, no records and no clock read; the step's outputs and
carried states bitwise the same either way."""

import gc

import numpy as np
import pytest
import torch

from audio_analyzer_rs_tpu_torch import spans
from audio_analyzer_rs_tpu_torch.models import generators as gen
from audio_analyzer_rs_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

SR = 48000.0
B, T, CHUNKS = 3, 4096, 2
STAGES = ("full_step.conditioning", "full_step.pitch", "full_step.onsets",
          "full_step.fleet")


@pytest.fixture(scope="module")
def audio():
    """[B, CHUNKS * T]: mixed scenes over a tone, one stream silent."""
    n = CHUNKS * T
    rows = [(gen.mixed_scene(n / SR + 0.05, SR, seed=40 + i)[:n]
             + gen.tone_with_harmonics(330.0 * (i + 1), n / SR + 0.05, SR,
                                       amplitude=0.2)[:n]).astype(np.float32)
            for i in range(B)]
    rows[2][:] = 0.0
    return np.stack(rows)


@pytest.fixture
def recording():
    spans.drain()
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.drain()


def run_chunks(audio):
    step = tsh.make_batched_full_step(None, SR, device="cpu")
    states = tsh.init_stream_states(B, device="cpu")
    outs = []
    for c in range(CHUNKS):
        states, out = step(states, audio[:, c * T:(c + 1) * T])
        outs.append(out)
    return states, outs


@pytest.fixture(scope="module")
def spans_off(audio):
    spans.disable()
    spans.drain()
    return run_chunks(audio)


@pytest.fixture(scope="module")
def spans_on(audio):
    spans.drain()
    spans.enable()
    try:
        result = run_chunks(audio)
        return result, spans.drain()
    finally:
        spans.disable()


def test_one_full_step_a_call_with_increasing_ids(spans_on):
    _, records = spans_on
    steps = sorted((r for r in records if r.name == "full_step"),
                   key=lambda r: r.start_ns)
    assert len(steps) == CHUNKS
    assert all(r.parent is None for r in steps)
    ids = [r.step for r in steps]
    assert ids == sorted(set(ids))
    assert len(records) == CHUNKS * (1 + len(STAGES))


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_stages_nest_inside_their_step_in_order(spans_on, chunk):
    _, records = spans_on
    step = sorted((r for r in records if r.name == "full_step"),
                  key=lambda r: r.start_ns)[chunk]
    kids = sorted((r for r in records if r.parent is not None
                   and r.step == step.step), key=lambda r: r.start_ns)
    assert tuple(r.name for r in kids) == STAGES
    assert all(r.parent == "full_step" for r in kids)
    assert step.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= step.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.start_ns <= a.end_ns <= b.start_ns


def test_spans_off_records_nothing_and_reads_no_clock(audio, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with spans off")

    spans.disable()
    spans.drain()
    monkeypatch.setattr(spans, "perf_counter_ns", no_clock)
    step = tsh.make_batched_full_step(None, SR, device="cpu")
    step(tsh.init_stream_states(B, device="cpu"), audio[:, :T])
    assert spans.drain() == []


@pytest.mark.parametrize("name", ("full_step", *STAGES))
def test_spans_off_share_one_noop(name):
    spans.disable()
    cm = spans.span(name)
    assert cm is spans.span("another")
    with cm as entered:
        assert entered is None
    assert spans.drain() == []


def test_drain_hands_over_and_clears(recording):
    with spans.span("outer"):
        with spans.span("inner"):
            pass
    with spans.span("outer"):
        pass
    first = spans.drain()
    assert [(r.name, r.parent) for r in first] == [
        ("inner", "outer"), ("outer", None), ("outer", None)]
    assert first[0].step == first[1].step == first[2].step - 1
    assert spans.drain() == []


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


@pytest.mark.parametrize("what", ("outputs", "states"))
def test_step_bitwise_the_same_with_spans_on_and_off(spans_on, spans_off,
                                                     what):
    (on_states, on_outs), _ = spans_on
    off_states, off_outs = spans_off
    on = _leaves(on_outs if what == "outputs" else on_states)
    off = _leaves(off_outs if what == "outputs" else off_states)
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.view(bits), b.view(bits)
        assert torch.equal(a, b)


def test_kept_records_leave_the_collector(recording):
    """The records kept until `drain()` stop being tracked at the first
    young collection, so a long window's records set off no full one."""
    for _ in range(3):
        with spans.span("full_step"):
            pass
    gc.collect(0)
    assert not any(gc.is_tracked(r) for r in spans._records)
    assert all(isinstance(r, spans.Record) for r in spans.drain())
