"""Find a cell's pieces by name.

`BENCHMARK.json` (at the checkout's root) names each cell's configuration
and traffic mix; the files are `configs/<config>.json`,
`traffic/<traffic>.json` and `limits/<cell>.json` beside this module, and
each per-layer metric is read by `metrics/<metric>.py`, whose `read(run)`
returns a number or None. A later cell, configuration, mix or metric is a
new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def int_keys(tree: Any) -> Any:
    """Dict keys made of digits as ints, as YAML reads them
    (`n_extra_attempts: {0: 2}`); JSON keys are always strings."""
    if isinstance(tree, dict):
        return {(int(k) if isinstance(k, str) and k.isdigit() else k): int_keys(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [int_keys(v) for v in tree]
    return tree


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


class Cell:
    """One workload of `BENCHMARK.json` with its configuration, mix, limits
    and metrics."""

    def __init__(self, name: str, entry: Dict, config: Dict, mix: Dict, limits: Dict,
                 end_to_end: List[Dict], per_layer: List[Dict]):
        self.name = name
        self.entry = entry
        self.chips = int(entry["chips"])
        self.config = config
        self.mix = mix
        self.limits = limits
        self.end_to_end = end_to_end
        self.per_layer = per_layer

    @classmethod
    def named(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        entry = cells[name]
        return cls(name, entry, config(entry["config"]), mix(entry["traffic"]), limits(name),
                   [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
                   [m for m in bench["per_layer"] if name in m.get("workloads", [name])])


def config(name: str) -> Dict:
    return int_keys(_json(HERE / "configs" / f"{name}.json"))


def mix(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict:
    return _json(HERE / "limits" / f"{cell}.json")


def reader(metric: str) -> Callable:
    """`metrics/<metric>.py`'s `read`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
