"""Everything a cell is made of, found by its name: the manifest
(``BENCHMARK.json`` at the root of the checkout), the workload file
``bench/workloads/<cell>.json``, the configuration file
``bench/configs/<config>.json`` and one reader per metric,
``bench/metrics/<metric>.py`` (a ``read(ctx)`` that returns the number or
None).  A later cell, configuration or metric is new files and new
manifest entries."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List


class Registry:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> Dict[str, Any]:
        path = self.root / "bench" / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def cell(self, name: str) -> Dict[str, Any]:
        """The manifest's entry of the cell."""
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def workload(self, name: str, traffic: str) -> Dict[str, Any]:
        """The traffic mix's parameters with the cell's limits."""
        wl = self._json("traffic", traffic)
        wl.update(self._json("workloads", name), name=name)
        return wl

    def config(self, name: str) -> Dict[str, Any]:
        return self._json("configs", name)

    def metrics(self, cell: str, traced: bool) -> List[Dict[str, Any]]:
        """The manifest's metrics this cell reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        e2e = [m for m in self.manifest["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]

    def reader(self, metric: str) -> Callable[[Dict[str, Any]], Any]:
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
