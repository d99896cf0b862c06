"""A later cell is data: a throwaway configuration, traffic mix and
per-layer metric dropped into a copy of the benchmark, with entries added to
its ``BENCHMARK.json`` and no file that was there edited, are found by name
and run (on the CPU, the port's plain versions, in a child process)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_new_cell_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    old = json.loads((root / "BENCHMARK.json").read_text())

    mf = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/reference.json").read_text())
    cfg["name"] = "tiny_sphere"
    cfg["scene"]["children"][1]["params"]["radius"] = 0.3
    (root / "portbench/configs/tiny_sphere.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/render_1080p.json").read_text())
    mix.update(width=40, height=30, frames_per_request=2, views=2)
    mix["check"].update(keep_requests=1, images=1)
    (root / "portbench/traffic/thumbs.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/frames_seen.py").write_text("def read(run):\n    return float(run.frames)\n")
    mf["configs"].append({"name": "tiny_sphere", "source": "https://github.com/ezorzin/SDF3D",
                          "file": "portbench/configs/tiny_sphere.json", "reduced": [], "why": "a test"})
    mf["workloads"].append({"name": "tiny_sphere.thumbs", "config": "tiny_sphere", "traffic": "thumbs",
                            "chips": 1, "why": "a test"})
    mf["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher", "source": "program_counter",
                            "layer": "render entry and forward wrapper", "moves": "render_rays_per_s",
                            "workloads": ["tiny_sphere.thumbs"]})
    for m in mf["end_to_end"]:
        if m["name"] in ("render_rays_per_s", "render_request_p95_ms"):
            m["workloads"].append("tiny_sphere.thumbs")
    (root / "BENCHMARK.json").write_text(json.dumps(mf))

    code = ("import json, sys\n"
            "from portbench.core import cell\n"
            "for traced in (False, True):\n"
            "    res, rows, loaded, _ = cell.run_cell('tiny_sphere.thumbs', 99, 0.2, traced, device='cpu',\n"
            "                                         log=lambda line: None)\n"
            "    print(json.dumps([res, rows, loaded, sys.modules['portbench'].__file__]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (plain, rows, loaded, _), (traced, _, _, where) = [json.loads(x) for x in out.stdout.splitlines()[-2:]]
    assert plain["correct"] and not loaded
    assert set(plain["metrics"]) == {"render_rays_per_s", "render_request_p95_ms", "setup_s"}
    assert traced["metrics"]["frames_seen"]["value"] >= 2
    assert where.startswith(str(root))
    for path, data in before.items():
        assert path.read_bytes() == data, path
    for kind in ("configs", "workloads", "per_layer"):
        assert mf[kind][:len(old[kind])] == old[kind]


def test_a_variant_is_read_by_its_base_unless_it_has_a_file(tmp_path):
    """``<base>.<variant>`` (a metric under a bound of its own) is read by
    ``<base>``'s file; a file of the variant's own name takes precedence."""
    from portbench.core import manifest

    metrics = tmp_path / "portbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "idle.fit.py").write_text("def read(run):\n    return 1.0\n")
    assert manifest.metric_path("idle.fit.4k", tmp_path) == metrics / "idle.fit.py"
    assert manifest.metric_reader("idle.fit.4k", tmp_path).read(None) == 1.0
    (metrics / "idle.fit.4k.py").write_text("def read(run):\n    return 2.0\n")
    assert manifest.metric_reader("idle.fit.4k", tmp_path).read(None) == 2.0
    with pytest.raises(FileNotFoundError):
        manifest.metric_path("busy.fit", tmp_path)
