"""Finding a cell's parts by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (``benchmark/configs/``);
* a traffic mix: ``benchmark/workloads/<traffic>.json``;
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, whose ``read(window)``
  returns the number or None where the window has nothing to read;
* a model: ``benchmark/models/<name>.py`` (its interface is in
  ``benchmark/models/__init__.py``), named by a configuration file's
  ``model`` key, ``ddsp_decoder`` where it has none.

A later cell, mix, metric or model is new files and new entries; no file
here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
DEFAULT_MODEL = "ddsp_decoder"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._models = {}

    def cell(self, workload: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        path = self.dir / "limits" / f"{workload}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def end_to_end(self, workload: str) -> List[str]:
        """The end-to-end metrics this cell reports."""
        return [m["name"] for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics read in this cell: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = set(self.end_to_end(workload))
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]

    def reader(self, metric: str) -> Callable:
        return _load(self.dir / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read

    def model(self, name: str) -> ModuleType:
        if name not in self._models:
            self._models[name] = _load(self.dir / "models" / f"{name}.py", f"benchmark_model_{name}")
        return self._models[name]

    def config_model(self, config: str) -> ModuleType:
        """The model module the configuration ``config`` names."""
        return self.model(self.config(config).get("model", DEFAULT_MODEL))

    def unit(self, metric: str) -> str:
        for m in self.spec["end_to_end"] + self.spec["per_layer"]:
            if m["name"] == metric:
                return m["unit"]
        raise KeyError(metric)

    def listing(self) -> Dict[str, List[str]]:
        """Every configuration, traffic mix, metric reader and model the
        registry holds, by the files it finds."""
        return {
            "configs": sorted(p.stem for p in (self.dir / "configs").glob("*.json")),
            "workloads": sorted(p.stem for p in (self.dir / "workloads").glob("*.json")),
            "metrics": sorted(p.name[:-3] for p in (self.dir / "metrics").glob("*.py")),
            "models": sorted(p.stem for p in (self.dir / "models").glob("*.py")
                             if p.stem != "__init__"),
        }
