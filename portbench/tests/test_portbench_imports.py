"""Nothing of JAX or the JAX package in the benchmark: the reference (and
the work tables' counter) loads no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``sdf3d_tpu``, nor any of ``sdf3d_tpu_torch``; a
run of the harness loads none of the first four, and one that does prints
no result.  Names are compared whole
(``sdf3d_tpu_torch`` begins with ``sdf3d_tpu``)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "sdf3d_tpu"}


def _top_modules(code: str) -> set:
    code += "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_loads_nothing_of_jax_or_the_port():
    mods = _top_modules("import portbench.reference.shader, portbench.reference.fit, portbench.reference.scene\n"
                        "import portbench.reference.nodes.plane, portbench.reference.nodes.sphere\n"
                        "import portbench.reference.nodes.union, portbench.reference.nodes.mandelbulb\n"
                        "import portbench.control, portbench.work.count, portbench.core.roofline")
    assert not mods & (FORBIDDEN | {"sdf3d_tpu_torch"}), sorted(mods)


def test_a_run_loads_nothing_of_jax():
    mods = _top_modules("from portbench.core import cell\n"
                        "cell.run_cell('reference.render_4k', 1, 0.1, True, device='cpu', log=lambda l: None,\n"
                        "              traffic_overrides={'width': 16, 'height': 12, 'frames_per_request': 1,\n"
                        "                                 'views': 1})")
    assert "sdf3d_tpu_torch" in mods
    assert not mods & FORBIDDEN, sorted(mods & FORBIDDEN)


def test_the_harness_names_what_it_finds():
    from portbench.core import cell

    assert set(cell.FORBIDDEN) == FORBIDDEN
    sys.modules["jaxlib_fake_for_test"] = sys
    try:
        assert "jaxlib_fake_for_test" not in cell.forbidden_modules()
    finally:
        del sys.modules["jaxlib_fake_for_test"]


@pytest.mark.parametrize("planted", ["", "flax"])
def test_a_run_that_loads_a_forbidden_module_prints_no_result(tmp_path, planted):
    """A copy of the benchmark whose ``setup_s`` reader (read after the
    window, the reference and the roofline) imports a stand-in ``flax``:
    the run prints no result and exits with a code other than 0.  Without
    the import the same copy prints its result."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "flax").mkdir()
    (root / "flax" / "__init__.py").write_text('"""A stand-in that only carries the name."""\n')
    if planted:
        reader = root / "portbench" / "metrics" / "setup_s.py"
        reader.write_text(f"import {planted}  # noqa: F401\n" + reader.read_text())
    code = ("from portbench import run\n"
            "raise SystemExit(run.report('reference.render_4k', 7, 0.1, False, run.ROOT, 'cpu',\n"
            "                            {'width': 16, 'height': 12, 'frames_per_request': 1, 'views': 1}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    if planted:
        assert out.returncode != 0 and not lines, (out.returncode, out.stdout[-2000:])
        assert planted in out.stderr.splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(lines[-1])["correct"]
