"""What a traced window's profile says: the device's operations and busy
time, the harness's host spans set on the trace's clock, and the
breakdown of the result line.

The profiler records the device's activity and the CUDA calls of the
host (no host ops: recording them slowed a 128-stream step by ~2 ms).
The harness's spans, taken by the host clock, are set on the trace's
clock by the synchronize that opens the window (`spans.mark`, its
`cudaDeviceSynchronize` in the trace).  Device operations are the
trace's kernels, copies and sets inside the window, which runs from the
start of the first request span to the end of the last.  Busy time is
the union of their intervals.  An idle gap between two operations is
labelled by the innermost harness span the host was in when it began.
"""

from __future__ import annotations


def _union(intervals) -> float:
    total, cur0, cur1 = 0.0, None, None
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def _label(t: float, host: list) -> str:
    """The innermost harness span holding time t (spans sorted by start)."""
    best, width = "harness", None
    for name, a, b in host:
        if a > t:
            break
        if a <= t <= b and (width is None or b - a < width):
            best, width = name, b - a
    return best


def context(prof, spans, cell) -> dict:
    """The readers' context of one traced window (times in seconds on the
    trace's clock)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    syncs = [e.time_range.start / 1e6 for e in events
             if e.device_type == DeviceType.CPU
             and "DeviceSynchronize" in e.name]
    shift = (min(syncs) - spans.mark) if syncs else 0.0
    host = sorted((n, a + shift, b + shift) for n, a, b in spans.done)
    reqs = [h for h in host if h[0] == "request"]
    w0, w1 = reqs[0][1], max(b for _, _, b in reqs)
    if not syncs:
        dev = [e.time_range for e in events
               if e.device_type == DeviceType.CUDA]
        w0 = min(r.start for r in dev) / 1e6
        w1 = max(r.end for r in dev) / 1e6
    ops = [(e.name, max(e.time_range.start / 1e6, w0),
            min(e.time_range.end / 1e6, w1)) for e in events
           if e.device_type == DeviceType.CUDA
           and e.time_range.end / 1e6 > w0 and e.time_range.start / 1e6 < w1]
    busy = _union((a, b) for _, a, b in ops)
    by_name: dict = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps: dict = {}
    reach = w0
    for a, b in sorted((a, b) for _, a, b in ops) + [(w1, w1)]:
        if a > reach:
            label = _label(reach, host) if syncs else "unlabelled"
            gaps[label] = gaps.get(label, 0.0) + (a - reach)
        reach = max(reach, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "ops": ops, "host": host, "requests": len(reqs),
        "window_s": w1 - w0, "busy_s": busy, "work": cell.work(),
        "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                      "idle_gaps": [["idle, host in " + n, s]
                                    for n, s in idle]},
    }
