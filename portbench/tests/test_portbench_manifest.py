"""The manifest keeps the benchmark's contract: names, units and lines of
the allowed characters and lengths, every file it names present, every
metric's reader present, the cells' metrics as the contract asks."""

import json
import re

import pytest

from portbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")

MF = manifest.load()


def _entries():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MF[kind]:
            yield kind, e


def test_top_level_keys_and_size():
    assert set(MF) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MF["run_seconds"] <= 51 and isinstance(MF["run_seconds"], int)
    assert 1 <= len(MF["command"]) <= 32 and all(LINE.match(w) for w in MF["command"])
    assert 1 <= len(MF["paths"]) <= 16
    for p in MF["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")


@pytest.mark.parametrize("kind,entry", list(_entries()), ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_lines(kind, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key]), (key, entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", ()):
        assert NAME.match(key)
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[kind]
    assert set(entry) <= allowed


def test_names_are_unique():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in MF[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MF["end_to_end"] + MF["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MF["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_are_found_by_name():
    for c in MF["configs"]:
        assert c["file"].startswith(MF["paths"][0] + "/")
        cfg = manifest.config(MF, c["name"])
        assert cfg["name"] == c["name"] and cfg["precision"] == "float32"
    for w in MF["workloads"]:
        assert w["chips"] == 1
        assert manifest.traffic(w["traffic"])["kind"] in ("render", "fit")
    for m in MF["end_to_end"] + MF["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in MF["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in MF["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MF["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in manifest.metrics_of(MF, "end_to_end", w)}
    for w in MF["workloads"]:
        own = [m["name"] for m in manifest.metrics_of(MF, "end_to_end", w["name"])]
        assert "setup_s" in own and len(own) >= 2
        assert manifest.metrics_of(MF, "per_layer", w["name"])


def test_layers_are_spelled_alike():
    layers = {}
    for m in MF["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_config_files_are_json_objects():
    for c in MF["configs"]:
        assert isinstance(json.loads((manifest.ROOT / c["file"]).read_text()), dict)
