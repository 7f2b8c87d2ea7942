"""Shared helpers of the benchmark's CPU tests.

    python -m pytest benchmark/tests -q

`tiny_root` copies BENCHMARK.json and the benchmark's folder into a
temporary directory and adds, by new files and manifest entries alone,
two cells at sizes the CPU can run with the program's plain versions:
`tiny48k.b8` (the full chain, 8 streams of 24 slots) and `tiny44k.min`
(the offline path over 60 s).  Each takes the limits of the real cell
it stands for, so a fault planted under it meets the real limits.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny48k.b8": ("chain48k", "chain48k.b128",
                   {"chunk_slots": 24}, {"streams": 8, "trace_seconds": 1}),
    "tiny44k.min": ("offline44k", "offline44k.30min", {},
                    {"recording_s": 60, "trace_seconds": 1}),
}


def add_cell(root: Path, name: str, config: str, like: str,
             config_changes: dict, workload_changes: dict) -> None:
    """A new cell by files and manifest entries only, as a later change
    adds one."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    src = json.loads((root / "benchmark" / "configs" / f"{config}.json")
                     .read_text())
    cfg_name = name.split(".")[0]
    src.update(config_changes, name=cfg_name)
    (root / "benchmark" / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(src))
    wl = json.loads((root / "benchmark" / "workloads" / f"{like}.json")
                    .read_text())
    wl.update(workload_changes, config=cfg_name)
    (root / "benchmark" / "workloads" / f"{name}.json").write_text(
        json.dumps(wl))
    manifest["configs"].append({
        "name": cfg_name, "source": "https://example.org/tiny",
        "file": f"benchmark/configs/{cfg_name}.json",
        "reduced": sorted(config_changes), "why": "a CPU test's size"})
    manifest["workloads"].append({
        "name": name, "config": cfg_name, "traffic": name.split(".", 1)[1],
        "chips": 1, "why": "a CPU test's size"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (config, like, cc, wc) in TINY.items():
        add_cell(root, name, config, like, cc, wc)
    return root
