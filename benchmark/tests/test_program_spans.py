"""The program's spans on a synthetic trace (benchmark/program_spans.py):
kernels credited to the span that launched them, idle gaps split over
the spans holding them, and every accepted per-layer metric reading what
it read before the program's spans joined the context."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import BENCH

import program_spans as ps
import run
import tracing
from audio_analyzer_rs_tpu_torch.spans import Record

MARK = 100.0        # the harness's mark, host clock (s)
SYNC_US = 10.0      # the synchronize's start on the trace's clock (us)
SHIFT = SYNC_US * 1e-6 - MARK   # host clock → the trace's (s)


def trace_us(host_s: float) -> float:
    """A host time on the trace's clock, in us."""
    return (host_s - MARK) * 1e6 + SYNC_US


def ev(name, cuda, a_us, b_us, corr):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=a_us, end=b_us), id=corr)


# (device op, its device start and end in us, its launch's host time):
# K6 starts as its launch call does (1500 us).
OPS = [("void reducer_kernel<false, true>", trace_us(100.00149), 3000,
        100.00149),
       ("elementwise_kernel", 3100, 3300, 100.0030),
       ("void rfft_mag_kernel<10, 32>", 3300, 4200, 100.0031),
       ("onset_kernel", 4200, 5000, 100.0041),
       ("reduce_kernel", 5400, 5500, 100.0053),
       ("Memcpy DtoH (Device -> Pinned)", 8100, 8300, 100.00801)]
HARNESS = [("request", 100.001, 100.010), ("call", 100.001, 100.006),
           ("wait", 100.006, 100.008), ("readback", 100.008, 100.010)]
PROGRAM = [("full_step", None, 100.0012, 100.0058),
           ("full_step.conditioning", "full_step", 100.0013, 100.0025),
           ("full_step.pitch", "full_step", 100.0025, 100.0040),
           ("full_step.onsets", "full_step", 100.0040, 100.0050),
           ("full_step.fleet", "full_step", 100.0052, 100.0056)]


class Prof:
    def __init__(self, launches=True, skew_us=0.0):
        self._events = [ev("cudaDeviceSynchronize", False, SYNC_US,
                           SYNC_US + 5, 1)]
        for i, (name, a, b, t) in enumerate(OPS, start=10):
            self._events.append(ev(name, True, a + skew_us, b + skew_us, i))
            if launches:
                self._events.append(ev("cudaLaunchKernel", False,
                                       trace_us(t), trace_us(t) + 3, i))

    def events(self):
        return self._events


class Work:
    def bound_s(self):
        return 0.5e-3


def contexts(launches=True, program=True, late=0.0, skew_us=0.0):
    prof = Prof(launches, skew_us)
    harness = run.Spans()
    harness.mark = MARK
    harness.done = list(HARNESS)
    ctx = tracing.context(prof, harness, SimpleNamespace(work=Work))
    records = [Record(n, p, 0, round(a * 1e9), round(b * 1e9))
               for n, p, a, b in PROGRAM] if program else []
    events = ps._events(prof)
    return ctx, ps.extend(ctx, events, SHIFT + late,
                          records, HARNESS)


def test_ops_keep_their_order_and_times():
    ctx, ext = contexts()
    assert [op[:3] for op in ext["launched"]] == ctx["ops"]


def test_kernels_are_credited_to_the_span_that_launched_them():
    _, ext = contexts()
    by = {name: span for name, _, _, _, span in ext["launched"]}
    # K6 runs on into the pitch stage's host time: its launch decides.
    assert by["void reducer_kernel<false, true>"] == "full_step.conditioning"
    assert by["elementwise_kernel"] == "full_step.pitch"
    assert by["void rfft_mag_kernel<10, 32>"] == "full_step.pitch"
    assert by["onset_kernel"] == "full_step.onsets"
    assert by["reduce_kernel"] == "full_step.fleet"
    assert by["Memcpy DtoH (Device -> Pinned)"] is None


@pytest.mark.parametrize("metric, ms", [
    ("chain.conditioning_launched_ms", 1.5),
    ("chain.pitch_launched_ms", 0.2 + 0.9),
    ("chain.onset_launched_ms", 0.8),
    ("chain.step_host_ms", 4.6),
])
def test_program_metrics(metric, ms):
    _, ext = contexts()
    fn, args = ps.METRICS[metric]
    assert fn(ext, **args) == pytest.approx(ms, abs=1e-9)


def test_an_idle_gap_is_split_over_the_spans_holding_it():
    _, ext = contexts()
    want = {
        # [1010, 1500] us, host 100.001-100.00149: the call, the step's
        # own code, conditioning.
        "call": 0.0002 + 0.0002, "full_step": 0.0001 + 0.0002 + 0.0002,
        "full_step.conditioning": 0.00019,
        # [3000, 3100]: between K6 and the pitch stage's first kernel.
        "full_step.pitch": 0.0001,
        # [5000, 5400]: the end of onsets, the step's code, fleet; and
        # [5500, 8100]: fleet, the step's return, the call's end, wait,
        # readback.
        "full_step.onsets": 0.00001, "full_step.fleet": 0.00019 + 0.00011,
        "wait": 0.002,
        # and [8300, 10010]: the readback to the window's end.
        "readback": 0.00009 + 0.00171,
    }
    got = ext["idle_by_span"]
    assert set(got) == set(want)
    for name, s in want.items():
        assert got[name] == pytest.approx(s, abs=1e-9), name
    fn, args = ps.METRICS["chain.step_idle_ms"]
    assert fn(ext, **args) == pytest.approx(1.1, abs=1e-9)
    labels = {n for n, _ in ext["breakdown"]["idle_gaps"]}
    assert "idle, host in full_step.fleet" in labels
    assert "idle, host in harness" not in labels


def test_the_split_keeps_the_idle_total():
    ctx, ext = contexts()
    assert sum(ext["idle_by_span"].values()) == pytest.approx(
        ctx["window_s"] - ctx["busy_s"], abs=1e-12)
    assert sum(s for _, s in ctx["breakdown"]["idle_gaps"]) == \
        pytest.approx(sum(ext["idle_by_span"].values()), abs=1e-12)


def test_a_gap_outside_every_span_stays_the_harness():
    edges, names = ps.segments([("call", 1.0, 2.0)])
    into: dict = {}
    ps.split((edges, names), 0.5, 2.5, into)
    assert into == pytest.approx({"harness": 1.0, "call": 1.0})


ACCEPTED = sorted(p.stem for p in (BENCH / "metrics").glob("*.json"))


@pytest.mark.parametrize("metric", ACCEPTED)
@pytest.mark.parametrize("program", (True, False), ids=("spans", "none"))
def test_accepted_metrics_read_what_they_read_before(metric, program):
    ctx, ext = contexts(program=program)
    spec = [{"name": metric, "unit": "x"}]
    before = run.per_layer(spec, ctx, BENCH / "metrics")
    assert before or json.loads((BENCH / "metrics" / f"{metric}.json")
                                .read_text())["reader"] == "kernel_ms"
    assert run.per_layer(spec, ext, BENCH / "metrics") == before


@pytest.mark.parametrize("metric", sorted(ps.METRICS))
def test_program_metrics_read_nothing_without_program_spans(metric):
    _, ext = contexts(program=False)
    fn, args = ps.METRICS[metric]
    assert fn(ext, **args) is None


def test_kernels_with_no_launch_found_are_unattributed():
    _, ext = contexts(launches=False)
    assert all(op[3] is None and op[4] is None for op in ext["launched"])
    check = ps.self_check(ext)
    assert check["coverage"] == 0.0
    assert check["unattributed_ms"] == pytest.approx(3.5, abs=1e-9)


def test_self_check_finds_each_hand_kernel_in_its_stage():
    _, ext = contexts()
    check = ps.self_check(ext)
    assert check["own_stage"]["reducer_kernel"] == 100.0
    assert check["own_stage"]["rfft_mag_kernel<10\\b"] == 100.0
    assert check["own_stage"]["onset_kernel"] == 100.0
    assert check["own_stage"]["extract_kernel"] is None
    assert check["coverage"] == pytest.approx(100.0)
    assert check["unattributed_ms"] == 0.0


def test_a_late_placement_moves_each_launch_into_the_stage_before():
    """Spans placed 0.65 ms late on the trace's clock, as a mark taken
    before a slow synchronize places them: the pitch stage's first
    launches land in conditioning."""
    _, ext = contexts(late=0.65e-3)
    by = {name: span for name, _, _, _, span in ext["launched"]}
    assert by["elementwise_kernel"] == "full_step.conditioning"
    assert ps.self_check(ext)["own_stage"]["rfft_mag_kernel<10\\b"] == 0.0


def test_the_clocks_own_shift():
    # A host time h reads h + shift on the trace's clock.
    start, real_minus_mono = 1_700_000_000_000_000_000, \
        1_699_999_000_000_000_000
    shift = ps.realtime_shift(start, real_minus_mono)
    assert shift == pytest.approx(-1000.0)
    h = 1000.5
    assert (h * 1e9 + real_minus_mono - start) / 1e9 == pytest.approx(
        h + shift)


def test_host_ms_a_step_by_span():
    records = [Record(n, par, 0, round(a * 1e9), round(b * 1e9))
               for n, par, a, b in PROGRAM]
    ms = ps.host_ms(records, 2, ())
    assert ms["full_step"] == pytest.approx(4.6 / 2)
    assert ms["full_step.pitch"] == pytest.approx(1.5 / 2)
    assert ms["full_step.self"] == pytest.approx((4.6 - 1.2 - 1.5 - 1.0
                                                  - 0.4) / 2)


def test_the_split_follows_the_host_where_the_device_times_lie_early():
    """Device times 100 us early against the host's, as one b128 trace
    read: the gaps are moved back, and the split is the true one but at
    the window's edges (100 us less of the call at its start, 100 us of
    the harness after its end)."""
    _, ext = contexts(skew_us=-100.0)
    assert [k for _, k in ext["device_skews"]] == pytest.approx([100e-6])
    _, true = contexts()
    want = dict(true["idle_by_span"], harness=0.0001)
    want["call"] -= 0.0001
    assert ext["idle_by_span"] == pytest.approx(want, abs=1e-9)


def test_each_request_takes_its_own_skew():
    """A drift: the second request's device times lie 0.3 s early, the
    first's 0.01 s late."""
    host = [("request", 0.0, 1.0), ("call", 0.0, 0.5),
            ("request", 1.0, 2.0)]
    launched = [("a", 0.10, 0.20, 0.09, None), ("b", 0.30, 0.40, 0.05, None),
                ("c", 0.90, 1.50, 1.20, None), ("d", 1.60, 1.70, 1.50, None),
                ("e", 1.80, 1.90, None, None)]
    got = ps.device_skews(launched, host)
    assert [x for pair in got for x in pair] == pytest.approx(
        [0.10, -0.01, 0.90, 0.30])


def test_a_collection_inside_a_stage_takes_its_idle_time():
    """A garbage collection from 100.00509 to 100.00529, across the step's
    own code after onsets and the start of fleet: the idle time then is
    the collection's."""
    prof = Prof()
    harness = run.Spans()
    harness.mark = MARK
    harness.done = list(HARNESS)
    ctx = tracing.context(prof, harness, SimpleNamespace(work=Work))
    records = [Record(n, p, 0, round(a * 1e9), round(b * 1e9))
               for n, p, a, b in PROGRAM]
    events = ps._events(prof)
    ext = ps.extend(ctx, events, SHIFT, records,
                    HARNESS + [("gc", 100.00509, 100.00529)])
    _, plain = contexts()
    assert ext["idle_by_span"]["gc"] == pytest.approx(0.0002, abs=1e-9)
    assert ext["idle_by_span"]["full_step"] == pytest.approx(
        plain["idle_by_span"]["full_step"] - 0.00011, abs=1e-9)
    assert ext["idle_by_span"]["full_step.fleet"] == pytest.approx(
        plain["idle_by_span"]["full_step.fleet"] - 0.00009, abs=1e-9)


def test_gc_spans_records_each_collection():
    import gc
    pauses: list = []
    collect = ps.gc_spans(pauses)
    gc.callbacks.append(collect)
    try:
        gc.collect()
        gc.collect(0)
    finally:
        gc.callbacks.remove(collect)
    assert [p[0] for p in pauses] == ["gc", "gc"]
    assert all(p[1] <= p[2] for p in pauses)
    assert collect.generations == [2, 0]


GC = (100.00509, 100.00529)     # the step's own code, then fleet's start


def test_step_host_time_leaves_out_the_collections_inside_it():
    prof = Prof()
    harness = run.Spans()
    harness.mark = MARK
    harness.done = list(HARNESS)
    ctx = tracing.context(prof, harness, SimpleNamespace(work=Work))
    records = [Record(n, p, 0, round(a * 1e9), round(b * 1e9))
               for n, p, a, b in PROGRAM]
    ext = ps.extend(ctx, ps._events(prof), SHIFT, records,
                    HARNESS + [("gc",) + GC])
    fn, args = ps.METRICS["chain.step_host_ms"]
    assert fn(ext, **args) == pytest.approx(4.6 - 0.2, abs=1e-9)


@pytest.mark.parametrize("pauses, want", [
    ((), {"full_step": 4.6, "full_step.onsets": 1.0,
          "full_step.fleet": 0.4}),
    ((GC,), {"full_step": 4.4, "full_step.onsets": 1.0,
             "full_step.fleet": 0.31}),
    # A collection outside every span takes nothing from them.
    (((100.0070, 100.0075),), {"full_step": 4.6, "full_step.onsets": 1.0,
                               "full_step.fleet": 0.4}),
], ids=("none", "inside", "outside"))
def test_host_ms_leaves_out_the_collections(pauses, want):
    records = [Record(n, par, 0, round(a * 1e9), round(b * 1e9))
               for n, par, a, b in PROGRAM]
    ms = ps.host_ms(records, 1, pauses)
    for name, v in want.items():
        assert ms[name] == pytest.approx(v, abs=1e-6), name
    assert ms["full_step.self"] == pytest.approx(
        ms["full_step"] - sum(ms[f"full_step.{c}"] for c in
                              ("conditioning", "pitch", "onsets", "fleet")),
        abs=1e-9)
