"""The control fails the check: the plain reference put in the program's
place and computed in the nearest precision below the configuration's
(bfloat16 for the full chain's float32, TF32 for the offline path's
float32 with TF32 off; TF32 for the full chain too, the nearer format
that its limits also hold out), at a size a CPU test run holds, read
against the real cells' limits.  On the card, at the cells' own sizes:
benchmark/calibrate.py --control."""

from __future__ import annotations

import pytest

import run

SEED = 2 ** 31 + 777


@pytest.mark.parametrize("cell, control", [("tiny48k.b8", "bfloat16"),
                                           ("tiny48k.b8", "tf32"),
                                           ("tiny44k.min", "tf32")])
def test_control_reads_incorrect(tiny_root, cell, control):
    result = run.run_cell(cell, SEED, 0.5, False, root=tiny_root,
                          device="cpu", control=control)
    assert result["correct"] is False, result["checks"]
