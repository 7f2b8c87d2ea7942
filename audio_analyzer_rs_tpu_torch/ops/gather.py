"""Lane gathers: the functions of the two Pallas kernels of the Mosaic
probe (tools/mosaic_probe.py), as plain PyTorch.

`lane_gather(x, idx)` is the function of the probe's `gather_kernel`
(`jnp.take_along_axis(x, idx, axis=1)` over [F, P] float32 with [F, P]
int32 indices), with JAX's index semantics: an index in [-P, 0) wraps (-1
reads column P - 1) and an index outside [-P, P) gives NaN (jnp's default
"fill" mode).  `torch.take_along_dim` raises on both, so the index is
normalized and masked here.

`comb_gather12(x, idx)` is the function of the probe's 12-gather kernel
`kern`, the comb's harmonic read: acc = +0.0, then for n = 0..11
acc = acc + take_along_axis(x, (idx + n) % P).  `idx + n` wraps as int32
arithmetic does, `%` is the floor-mod of `jnp.remainder` (-3 % 7 == 4), so
every read is in range.  The sum starts at +0.0 and adds in the order
n = 0..11: seeding it with the first gather would keep a -0.0 that
0.0 + -0.0 turns into +0.0.

These are the plain versions.  The hand-written kernels K8 and K9
(csrc/gather.cu) compute the same two functions bit for bit; their
wrappers, `hopper_gather.lane_gather` and `hopper_gather.comb_gather12`,
take these versions for tensors on the CPU.
"""

from __future__ import annotations

import torch

COMB_GATHERS = 12
_INT32 = 1 << 32


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [F, P] float32, idx [F, P] int32 → x[f, idx[f, p]] [F, P]; an index
    in [-P, 0) counts from the end, one outside [-P, P) gives NaN."""
    p = x.shape[1]
    i = idx.long()
    inside = (i >= -p) & (i < p)
    j = torch.where(inside, torch.remainder(i, max(p, 1)), 0)
    if x.numel() == 0:
        return torch.empty_like(x)
    return torch.gather(x, 1, j).masked_fill(~inside, float("nan"))


def comb_gather12(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [F, P] float32, idx [F, P] int32 → the sum over n = 0..11 of
    x[f, (idx[f, p] + n) mod P], from +0.0, in that order."""
    p = x.shape[1]
    acc = torch.zeros_like(x)
    if x.numel() == 0:
        return acc
    i = idx.long()
    for n in range(COMB_GATHERS):
        wrapped = torch.remainder(i + n + (1 << 31), _INT32) - (1 << 31)
        acc = acc + torch.gather(x, 1, torch.remainder(wrapped, p))
    return acc
