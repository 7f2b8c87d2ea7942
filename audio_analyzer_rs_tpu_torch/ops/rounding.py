"""One rounding to float32, as a fused multiply-add gives it.

XLA:CPU contracts some a*b + c expressions of the JAX recurrences into
hardware FMAs, and the port's kernels use `fmaf` there; the plain versions
compute the same expressions with `fma32`.
"""

from __future__ import annotations

import torch


def fma32(a, b, c) -> torch.Tensor:
    """a*b + c with one rounding to float32, for float32 operands (tensors
    or Python floats exact in float32).  The product is exact in float64;
    the sum is made round-to-odd in float64 (TwoSum gives its error), so the
    final rounding to float32 is the correct one.  Rounding the float64 sum
    straight to float32 would round twice and miss by one ulp where the sum
    lands on a float32 midpoint."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else v
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()
