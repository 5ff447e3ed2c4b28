"""Finds a cell's configuration, traffic mix and metric readers (end to
end and per layer) by the names ``BENCHMARK.json`` gives them, so that a new cell, mix or
metric is a new file and an entry, never an edit of a file here."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file named by the ``configs`` entry ``name``."""
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(os.path.join(root, entry["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> dict:
    """``traffic/<name>.json``: the mix's parameters, which ``generator``
    drives."""
    with open(os.path.join(here, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metric entries this cell reports: its end-to-end ones, or with
    ``traced`` its per-layer ones."""
    return [m for m in bench["per_layer" if traced else "end_to_end"] if _in_cell(m, cell)]


def reader(name: str, here: str = HERE):
    """``metrics/<name>.py``'s ``read``: it takes the run's record
    (``harness.RunRecord``) and returns the metric's value, or None where
    the run holds nothing to read it from."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
