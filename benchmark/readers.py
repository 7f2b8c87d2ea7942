"""The general readers a per-layer metric's `.json` file names, each with
its arguments.  A reader returns None where the trace holds nothing for
it to read; the harness then leaves the metric out of the line."""

from __future__ import annotations

import re

NON_KERNELS = ("Memcpy", "Memset")


def _kernels(ctx):
    return [op for op in ctx["ops"] if not op[0].startswith(NON_KERNELS)]


def kernel_ms(ctx, patterns: list[str]) -> float | None:
    """Device ms a request of the kernels whose names match any pattern
    (regular expressions, searched)."""
    rx = [re.compile(p) for p in patterns]
    hit = [b - a for name, a, b in _kernels(ctx)
           if any(r.search(name) for r in rx)]
    if not hit or not ctx["requests"]:
        return None
    return sum(hit) * 1e3 / ctx["requests"]


def kernel_count(ctx) -> float | None:
    """CUDA kernels launched a request (copies and sets left out)."""
    n = len(_kernels(ctx))
    return n / ctx["requests"] if n and ctx["requests"] else None


def span_ms(ctx, span: str) -> float | None:
    """Host ms a request inside the harness span `span`."""
    t = [b - a for name, a, b in ctx["host"] if name == span]
    if not t or not ctx["requests"]:
        return None
    return sum(t) * 1e3 / ctx["requests"]


def idle_share(ctx) -> float | None:
    """% of the traced window in which no operation ran on the device."""
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def roofline(ctx) -> float | None:
    """% of the device's kernel time that the request's work needs at the
    card's peaks (benchmark/work.py): the requests' bound over the summed
    time of every kernel in the window."""
    t = sum(b - a for _, a, b in _kernels(ctx))
    if t <= 0 or not ctx["requests"]:
        return None
    return 100.0 * ctx["work"].bound_s() * ctx["requests"] / t
