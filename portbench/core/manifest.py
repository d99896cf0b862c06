"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's file (the manifest's ``configs[].file``), a traffic mix's
``portbench/traffic/<name>.json``, a metric's reader
``portbench/metrics/<name>.py``.  A metric ``<base>.<variant>`` with no file
of its own is read by ``<base>``'s reader: a variant is the same quantity
under a bound of its own, reported by other cells."""

from __future__ import annotations

import importlib.util
import json
import pathlib

#: The checkout that holds this harness.
ROOT = pathlib.Path(__file__).resolve().parents[2]


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def metric_path(name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """``portbench/metrics/<name>.py``, or that of the longest base of
    ``name`` (its dotted parts, the last ones dropped) that has one."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "portbench" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} under portbench/metrics")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The reader of the metric ``name`` (its ``read(run)``)."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(manifest: dict, kind: str, cell_name: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those whose
    ``workloads`` name it, and those without ``workloads``."""
    return [m for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]
