"""The manifest keeps to the benchmark's contract, every cell finds its
files by name, a cell added by files alone runs, and a run without a
card exits non-zero with no result."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in MANIFEST["paths"])
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    for section, keys in KEYS.items():
        for entry in MANIFEST[section]:
            extra = set(entry) - keys - ({"workloads"} if section in (
                "end_to_end", "per_layer") else set())
            assert keys <= set(entry) and not extra, (section, entry)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units_use_only_allowed_characters(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), e[key]
        for k in e.get("reduced", []):
            assert NAME.match(k)
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)


def test_metrics_contract():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        reported = [m for m in e2e.values()
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    spec = run.resolve(cell)
    assert spec["driver"].is_file()
    entry = {c["name"]: c for c in MANIFEST["configs"]}[spec["cell"]["config"]]
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert sorted(spec["config"]["reduced"]) == sorted(entry["reduced"])
    assert set(spec["workload"]["limits"]), "a cell without limits"
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.json").is_file() or (
            BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        if m["name"] != "setup_s":
            assert m["name"] in spec["workload"]["end_to_end"]


def test_configs_state_the_scene_kinds_the_generator_makes():
    import scene
    for c in MANIFEST["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["scene_kinds"] == list(scene.KINDS), c["name"]
        assert "scene_kinds" in config["assumed"], c["name"]


def test_configs_each_have_their_own_file_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith(tuple(p + "/" for p in MANIFEST["paths"]))
               for f in files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_a_run_without_a_card_exits_nonzero_with_no_result():
    cell = MANIFEST["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 12345), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    for p in MANIFEST["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    cell = MANIFEST["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


@pytest.mark.parametrize("cell", ["tiny48k.b8", "tiny44k.min"])
def test_a_cell_added_by_files_alone_runs(tiny_root, cell):
    """The harness runs a cell that a later change adds by files and
    manifest entries, with no edit to a file of the benchmark."""
    result = run.run_cell(cell, 2 ** 31 + 99, 0.5, False, root=tiny_root,
                          device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {
        m["name"] for m in MANIFEST["end_to_end"]
        if cell.replace("tiny48k.b8", "chain48k.b128").replace(
            "tiny44k.min", "offline44k.30min") in m.get("workloads", [cell])
        or "workloads" not in m}
    assert list(result)[-1] == "readings" and "checks" in result
