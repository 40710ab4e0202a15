"""The benchmark as data: ``BENCHMARK.json`` and the files it names,
found by name under the checkout.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* a configuration is ``configs/<name>.json`` (its ``file``), with its
  generator ``configs/<name>.data.py`` and its plain reference
  ``configs/<name>.ref.py`` beside it;
* a traffic mix is ``traffic/<name>.json``, read by ``traffic.py``;
* a per-layer metric is ``metrics/<name>.py``, whose ``read(window)``
  returns its number or None.

Nothing here names a cell, a configuration or a metric: a new one is new
files and new ``BENCHMARK.json`` entries.

``held_back.json`` beside the harness, where there is one, holds cells in
the form of ``BENCHMARK.json``'s entries that were built and measured but
are not in the benchmark (its ``why`` says why): :meth:`Benchmark.cell`
finds them after ``BENCHMARK.json``'s own, so that they run and are
tested as they are until a later benchmark moves them in.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_path: Path
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench: "Benchmark"

    def data_module(self):
        return load_module(self.config_path.with_suffix(".data.py"),
                           f"portbench_data_{self.config['name']}")

    def ref_module(self):
        return load_module(self.config_path.with_suffix(".ref.py"),
                           f"portbench_ref_{self.config['name']}")


class Benchmark:
    """``BENCHMARK.json`` at ``root`` (the checkout), its files under the
    first of its ``paths``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.spec["paths"][0]
        held = self.bench / "held_back.json"
        self.held_back = json.loads(held.read_text()) if held.is_file() else {}

    def cell(self, name: str) -> Cell:
        spec = self.spec
        w = next((w for w in spec["workloads"] if w["name"] == name), None)
        if w is None:
            spec = self.held_back
            w = next((w for w in spec.get("workloads", []) if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        c = next(c for c in spec.get("configs", []) + self.spec["configs"]
                 if c["name"] == w["config"])
        cfg_path = self.root / c["file"]
        traffic = json.loads((self.bench / "traffic" / f"{w['traffic']}.json").read_text())

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        return Cell(
            name=name, chips=int(w["chips"]),
            config=json.loads(cfg_path.read_text()), config_path=cfg_path,
            traffic=traffic,
            end_to_end=[m for m in self.spec["end_to_end"] if here(m)],
            per_layer=[m for m in spec["per_layer"] if here(m)],
            bench=self,
        )

    def reader(self, metric: str):
        """The ``read(window)`` of per-layer metric ``metric``."""
        mod = load_module(self.bench / "metrics" / f"{metric}.py",
                          "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))
        return mod.read
