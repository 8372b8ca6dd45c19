"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells (workloads), the
configurations and the metrics.  A cell names its configuration, whose
file it gives, and its traffic mix, the file ``traffic/<traffic>.json``
here; every metric is read by its own reader, ``metrics/<name>.py``,
whose ``read(record)`` returns the metric's value or None where the run
gives it nothing to read.  A later cell, configuration, traffic mix or
metric is new files and new entries: the harness finds them by name.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: dict, e2e_of_cell: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with
    no list, in every cell that reports the end-to-end metric it moves
    (every cell for an end-to-end metric without a list)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


class Cell:
    """One workload of the benchmark: its entry, configuration, traffic
    and the names of the metrics it reports."""

    def __init__(self, bench: dict, name: str, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} (one of "
                           f"{', '.join(cells)})")
        self.entry = w = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.chips = int(w["chips"])
        self.e2e = [m["name"] for m in bench["end_to_end"]
                    if _for_cell(m, w, set())]
        self.per_layer = [m["name"] for m in bench["per_layer"]
                          if _for_cell(m, w, set(self.e2e))]
        self.units = {m["name"]: m["unit"]
                      for m in bench["end_to_end"] + bench["per_layer"]}

    def deck(self) -> dict:
        """The configuration's deck with the traffic's keys over it."""
        return {**self.config["deck"], **self.traffic.get("deck", {})}


def reader(name: str):
    """The ``read`` function of metric ``name`` (metrics/<name>.py)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_h100.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
