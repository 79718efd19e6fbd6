"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Names are compared by their whole
top-level part, so ``pynndescent_torch`` never matches ``pynndescent_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.spec import BENCH_DIR, ROOT


def _top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_compare_whole_top_level_parts():
    assert forbidden_modules(["pynndescent_torch", "pynndescent_torch.ops", "jaxtyping",
                              "pynndescent_tpux", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "pynndescent_tpu.ops", "flax"]) == [
        "flax", "jax", "pynndescent_tpu"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _top_level_imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        names = _top_level_imports(path)
        assert "pynndescent_torch" not in names and not names & set(FORBIDDEN), path


def test_a_run_loads_no_forbidden_module():
    """Import everything a run imports (the program, the harness, every
    generator, loop, reference and reader) in a fresh interpreter, then
    look at sys.modules."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.run, benchmark.cell, benchmark.control, benchmark.judge
import pynndescent_torch
from pynndescent_torch import NNDescent
from benchmark.spec import Spec
spec = Spec()
for c in spec.doc["configs"]:
    spec.generator(spec.config(c["name"])["generator"])
for m in spec.doc["per_layer"]:
    spec.reader(m["name"])
for w in spec.doc["workloads"]:
    spec.loop(spec.traffic(w["traffic"])["kind"])
    spec.reference(spec.config(w["config"])["metric"])
print(json.dumps(sorted(sys.modules)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = json.loads(p.stdout.strip().splitlines()[-1])
    assert "pynndescent_torch" in loaded
    assert forbidden_modules(loaded) == []
