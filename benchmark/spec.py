"""Find a cell's parts by name.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix; the rest sits in files named after it under the benchmark's
folder:

- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the loop;
- ``loops/<kind>.py``: the loop that drives a kind of traffic, ``Loop``;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``reference/<metric>.py``: the plain reference of a configuration's
  ``metric``, ``knn`` and ``dist_gap``; a metric without one is refused;
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``;
  a metric named ``<quantity>.<cells>`` with no file of its own takes
  ``metrics/<quantity>.py``;
- ``generators/<generator>.py``: the data generator a configuration names.

A later cell, mix, kind of traffic, metric of distance, per-layer metric or
generator is a new file and a new entry; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it leads to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR.name
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics the cell reports (``trace 0``)."""
        return [m for m in self.doc["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics the cell reports (``trace 1``): those that
        list it, and those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in mine)]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read`` function, else that of the
        quantity the name starts with (``metrics/<quantity>.py``)."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return self._load("metrics", path).read

    def loop(self, kind: str):
        """``loops/<kind>.py``'s ``Loop`` class."""
        return self._load("loops", self.dir / "loops" / f"{kind}.py", "kind of traffic").Loop

    def reference(self, metric: str):
        """``reference/<metric>.py``: the plain reference for that metric."""
        return self._load("reference", self.dir / "reference" / f"{metric}.py",
                          "reference for the metric")

    def generator(self, name: str):
        return self._load("generators", self.dir / "generators" / f"{name}.py")

    def _load(self, group: str, path: Path, what: str | None = None):
        if path.stem.startswith("_") or not path.exists():
            raise LookupError(f"no {what or group[:-1]} {path.stem!r}: "
                              f"{path.relative_to(self.root)} does not exist")
        if path not in self._modules:
            self._modules[path] = load_file(path, f"{group}_{path.stem}")
        return self._modules[path]


def load_file(path: Path, tag: str):
    """Import one Python file by its path (names hold dots and dashes)."""
    name = "_bench_" + "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
