"""Finds a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, one mix or one metric is a
file of its own, found from the names in ``BENCHMARK.json``:

- a configuration: the ``file`` its entry names (sizes and layout, JSON);
- a traffic mix: ``<bench>/traffic/<traffic>.json``;
- a metric: ``<bench>/metrics/<metric name>.py``, a module with
  ``read(run) -> float | None`` (``run`` is a ``harness.Run``).

So a cell, a mix or a metric is added by adding files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    path: pathlib.Path   # its reader


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple   # of Metric, that this cell reports
    per_layer: tuple


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: pathlib.Path = ROOT,
         bench: pathlib.Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read
    and the metrics it reports. Raises ``KeyError`` for an unknown name
    and ``FileNotFoundError`` for a missing file."""
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{w['traffic']}.json").read_text())

    def metrics(key: str) -> tuple:
        out = []
        for m in spec[key]:
            if not _reports(m, name):
                continue
            path = bench / "metrics" / f"{m['name']}.py"
            if not path.exists():
                raise FileNotFoundError(f"no reader {path} for metric "
                                        f"{m['name']!r}")
            out.append(Metric(m["name"], m["unit"], path))
        return tuple(out)

    return Cell(name, int(w["chips"]), config, traffic,
                metrics("end_to_end"), metrics("per_layer"))


def reader(metric: Metric):
    """The ``read`` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.name.replace(".", "_").replace("-", "_"),
        metric.path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
