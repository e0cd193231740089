"""Nothing the benchmark runs imports `jax` or the JAX package, and the
reference imports nothing of the program: checked in fresh processes by whole
top-level module names (the program's name, `sirius_tpu_torch`, begins with
the JAX package's, `sirius_tpu`) and in the sources (all but the test that
holds the reference to the JAX package, which nothing imports)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import harness

BENCH = Path(harness.__file__).resolve().parent
REFERENCE = BENCH / "reference"
JAX_SIDE = {"jax", "jaxlib", "flax", "sirius_tpu"}


IMPORT_ALL = ("import importlib, pkgutil\n"
              "def _import_all(pkg):\n"
              "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
              "        importlib.import_module(m.name)\n")


def _run(code: str) -> str:
    code = IMPORT_ALL + code
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    """The program loaded: `sirius_tpu_torch` is not `sirius_tpu`."""
    code = ("import sys; sys.path.insert(0, '.'); import sirius_tpu_torch.fields.gold; "
            "from port_bench import harness; print(harness.modules_loaded())")
    assert _run(code) == "[]"


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from port_bench import harness, judge, trace; from port_bench.roofline import commit;"
            "import sirius_tpu_torch, port_bench.reference.sirius_plain as ref; _import_all(ref);"
            "_import_all(sirius_tpu_torch);"
            "bench = harness.load_benchmark();"
            "[harness.load_reader(m['name']) for m in bench['end_to_end'] + bench['per_layer']];"
            "print(harness.modules_loaded())")
    assert _run(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import port_bench.reference.sirius_plain as ref; from port_bench import harness; _import_all(ref);"
            "print(harness.modules_loaded(('jax', 'jaxlib', 'flax', 'sirius_tpu', 'sirius_tpu_torch')))")
    assert _run(code) == "[]"


# the one test that holds the reference to the JAX package; no module imports it
JAX_WITNESS = BENCH / "tests" / "test_bench_jax_witness.py"


def test_no_source_of_the_benchmark_names_the_jax_side():
    for path in BENCH.rglob("*.py"):
        if path != JAX_WITNESS:
            assert not _top_level_imports(path) & JAX_SIDE, path
        assert "test_bench_jax_witness" not in _top_level_imports(path), path


def test_no_source_of_the_reference_names_the_program():
    for path in REFERENCE.rglob("*.py"):
        assert not _top_level_imports(path) & (JAX_SIDE | {"sirius_tpu_torch"}), path
