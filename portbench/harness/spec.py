"""BENCHMARK.json and the files it names, resolved for one cell.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own that is found by its name:

    configs/<config>.json         the configuration's sizes and source
    problems/<config>.py          make(config) -> (P, q, r, is_eq)
    traffic/<traffic>.json        the mix's parameters (one generator reads
                                  them: harness/rank.py)
    limits/<workload>.json        the limit of each number `correct` compares
    end_to_end/<metric>.py        read(run) -> value or None
    layer_metrics/<metric>.py     read(run) -> value or None
    reference/suggest_<suggest>.py  draw(form, num, seed, dtype, device)
    reference/<improve>.py        improve(form, xs, **args) -> (x, work)

so that a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.  A mix names its suggest and
its improve; one whose reference file is missing stops the run before
its set-up.  Every mix is driven through `solve_restarts` (harness/
rank.py): an entry of another shape (solve_scenarios, the 2-D ADMM)
needs harness code.
"""

from __future__ import annotations

import importlib
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def module_name(name: str) -> str:
    """A file name (configuration, improve method, metric) as a Python
    module name: '-' and '.' become '_'."""
    return name.replace("-", "_").replace(".", "_")


def load(package: str, name: str):
    """portbench/<package>/<name>.py as a module."""
    return importlib.import_module(f"portbench.{package}.{module_name(name)}")


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics this cell reports:
    those that list it, and those that list no cell."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


class Cell:
    """One entry of `workloads`, with its configuration, its mix, its
    limits and its metrics."""

    def __init__(self, name: str, bench: dict = None):
        bench = load_benchmark() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = entries[name]
        self.name, self.chips = name, int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        self.config = _json("configs", f"{self.config_name}.json")
        self.mix = _json("traffic", f"{self.traffic_name}.json")
        self.limits = _json("limits", f"{name}.json")["limits"]
        self.end_to_end = metrics_of(bench, "end_to_end", name)
        self.per_layer = metrics_of(bench, "per_layer", name)

    def problem(self):
        """The problem's arrays (P, q, r, is_eq) in NumPy float64, made by
        problems/<config>.py from the configuration (its instance_seed):
        the run's seed draws the starts, not the instance, so that every
        seed's run does the same work in another order."""
        return load("problems", self.config_name).make(self.config)

    def reference(self):
        """reference/<improve>.py, the improve's frozen plain version."""
        return improve_reference(self.mix)

    def suggest_reference(self):
        """reference/suggest_<suggest>.py, the suggest's plain draw."""
        return suggest_reference(self.mix)


def improve_reference(mix: dict):
    return _reference(mix["improve"])


def suggest_reference(mix: dict):
    return _reference("suggest_" + mix["suggest"])


def _reference(name: str):
    """reference/<name>.py; a LookupError that names the file where the
    reference has none."""
    try:
        return load("reference", name)
    except ModuleNotFoundError as e:
        if e.name != f"portbench.reference.{module_name(name)}":
            raise
        raise LookupError(f"the reference has no {name!r}: add "
                          f"portbench/reference/{module_name(name)}.py") \
            from None
