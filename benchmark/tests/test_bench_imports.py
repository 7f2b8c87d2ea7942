"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

import run

JAX_SIDE = {"jax", "jaxlib", "flax", "audio_analyzer_rs_tpu"}
PORT = "audio_analyzer_rs_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PORT not in names and not names & JAX_SIDE
    assert names <= {"__future__", "math", "numpy", "scipy"}, names


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules([PORT, PORT + ".ops", "numpy"]) == []
    assert run.forbidden_modules(["audio_analyzer_rs_tpu.ops.pitch",
                                  "jax._src", "jaxlib", PORT]) == [
        "audio_analyzer_rs_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax_side_module():
    """The harness and the drivers with the program imported, in a clean
    process."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, checks, scene, work, tracing, readers, calibrate\n"
        "from reference import chain, offline, pitch\n"
        "import audio_analyzer_rs_tpu_torch.parallel.sharding\n"
        "import audio_analyzer_rs_tpu_torch.models.segmented\n"
        "for d in ('full_step', 'segmented_pitch'):\n"
        "    run.load_module(run.HERE / 'drivers' / (d + '.py'), d)\n"
        "print(run.forbidden_modules())\n") % (str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
