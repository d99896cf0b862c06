"""The port's fit examples (``sdf3d_tpu_torch/examples/inverse_fit.py``,
``pose_fit.py``, ``grid_fit.py``) against the JAX package's scripts
(``examples/``), each run whole on the CPU at a small step count.

JAX's script runs through ``runpy.run_path`` with ``sys.argv`` patched, a stub
``_common`` module in ``sys.modules`` (no TPU probe), and
``sdf3d_tpu.utils.write_png`` replaced by a capture of the float images; the
port's ``main(argv)`` runs with ``--device cpu`` (the kernels' plain
versions) and its ``write_png`` captured the same way.  ``fit_scene`` and
``fit_view`` of both packages are wrapped to keep their results, and both
packages' ``FitConfig`` log every step (``log_every=1``), so every step's
loss is compared; nothing else of either script changes.

Bars, each beside the error measured here:
- ``inverse_fit --steps 4`` (96×64, the multiscale loss and the silhouette
  term, K3's combined form): the port's kernel engine against JAX's fused
  engine (``engine="pallas"``, interpret mode, its counterpart): losses 1e-3
  relative at every step (measured 2.9e-4 at step 2: the coverage sigmoid,
  β = ε/2.5, makes the loss after a step move by 1e4 per unit of a
  parameter, so a 1e-5 difference in an Adam update shows; JAX's own two
  engines differ by 9.8e-3 at step 3), and against the script as it
  runs (JAX's XLA engine): step 0's loss 1e-5 relative (measured 2.6e-7),
  the fitted centre and radius within 15% of JAX's move from the start
  (measured 11% on y);
- ``pose_fit --steps 4`` (128×96, ``fit_view``'s form of K3): losses 1e-4
  relative at every step against both JAX engines (measured 3e-6), the
  fitted camera position within 15% of JAX's move;
- both: the target and start images at the pixel budget of
  ``utils/parity.py``; the printed lines;
- ``grid_fit --res 8 --size 32 --steps 3`` (the banded route): losses 1e-4
  relative at every step, the images at ``NEURAL_BAR``.

About 45 s on one worker, most of it JAX's fit steps.
"""

import functools
import json
import pathlib
import runpy
import sys
import types

import numpy as np
import pytest
import torch

import sdf3d_tpu.fit as jax_fit
import sdf3d_tpu.utils as jax_utils
import sdf3d_tpu_torch.fit as port_fit
import sdf3d_tpu_torch.utils as port_utils
from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, check_pixel_budget

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PALLAS = dict(engine="pallas", pallas_interpret=True, pallas_tile=(8, 128))


def _capture(monkeypatch, module, fits_module, results: list) -> dict:
    """Capture ``module.write_png``'s images and the results of
    ``fits_module``'s ``fit_scene``/``fit_view``; every step logged."""
    images = {}
    monkeypatch.setattr(module, "write_png",
                        lambda path, img: images.__setitem__(pathlib.Path(path).name, np.array(img, np.float32)))
    for name in ("fit_scene", "fit_view"):
        orig = getattr(fits_module, name)

        def spy(*args, _orig=orig, **kwargs):
            results.append(_orig(*args, **kwargs))
            return results[-1]

        monkeypatch.setattr(fits_module, name, spy)
    return images


def run_jax(name, argv, monkeypatch, capsys, **fit_overrides):
    """JAX's ``examples/<name>.py`` with ``argv``: (images, fit results,
    printed lines)."""
    stub = types.ModuleType("_common")
    stub.use_live_device = lambda: False
    monkeypatch.setitem(sys.modules, "_common", stub)
    results = []
    images = _capture(monkeypatch, jax_utils, jax_fit, results)
    monkeypatch.setattr(jax_fit, "FitConfig", functools.partial(jax_fit.FitConfig, log_every=1, **fit_overrides))
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return images, results, lines


def run_port(name, argv, monkeypatch, capsys):
    """The port's ``examples.<name>.main(argv + --device cpu)``."""
    import importlib

    results = []
    images = _capture(monkeypatch, port_utils, port_fit, results)
    monkeypatch.setattr(port_fit, "FitConfig", functools.partial(port_fit.FitConfig, log_every=1))
    capsys.readouterr()
    assert importlib.import_module(f"sdf3d_tpu_torch.examples.{name}").main([*map(str, argv), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return images, results, lines


def _rel(a, b) -> float:
    return max(abs(x / y - 1.0) for x, y in zip(a, b))


def _printed(lines):
    """The script's own lines (the metrics logger's JSON lines left out)."""
    return [ln for ln in lines if not ln.startswith("{")]


def test_inverse_fit_matches_jax(monkeypatch, capsys, tmp_path):
    argv = ["--steps", 4]
    j_img, (j_res,), j_lines = run_jax("inverse_fit", [*argv, "--out", tmp_path / "jax"], monkeypatch, capsys)
    f_img, (f_res,), _ = run_jax("inverse_fit", [*argv, "--out", tmp_path / "fused"], monkeypatch, capsys, **PALLAS)
    p_img, (p_res,), p_lines = run_port("inverse_fit", [*argv, "--out", tmp_path / "port"], monkeypatch, capsys)

    assert len(p_res.losses) == len(f_res.losses) == 4 and p_res.steps_run == 4
    print("[measured] inverse_fit losses vs JAX's fused engine:", _rel(p_res.losses, f_res.losses),
          "JAX's two engines:", _rel(j_res.losses, f_res.losses))
    assert _rel(p_res.losses, f_res.losses) <= 1e-3
    assert abs(p_res.losses[0] / j_res.losses[0] - 1.0) <= 1e-5
    start = np.array([0.08, 0.45, 0.0, 0.27])
    j_fit = np.append(np.asarray(j_res.scene.b.center), float(j_res.scene.b.radius))
    p_fit = np.append(p_res.scene.b.center.detach().numpy(), float(p_res.scene.b.radius.detach()))
    share = np.abs(p_fit - j_fit) / np.abs(j_fit - start)
    print("[measured] inverse_fit fitted parameters off JAX's, of its move:", share.tolist())
    assert (share <= 0.15).all()
    # The plane stays frozen.
    assert torch.equal(p_res.scene.a.offset.detach(), torch.zeros(()))
    for name in ("target.png", "init.png"):
        check_pixel_budget(p_img[name], j_img[name], name, channel_axis=-1)
    assert sorted(p_img) == sorted(j_img) == ["fitted.png", "init.png", "target.png"]
    assert np.isfinite(p_img["fitted.png"]).all()
    p_out, j_out = _printed(p_lines), _printed(j_lines)
    assert p_out[0] == j_out[0] == "true   : center (0, 0.4, 0)  radius 0.2"
    center = np.round(p_res.scene.b.center.detach().numpy(), 4).tolist()
    assert p_out[1] == f"fitted : center {center}  radius {float(p_res.scene.b.radius.detach()):.4f}"
    assert p_out[2].startswith(f"loss {p_res.losses[0]:.3f} -> {p_res.losses[-1]:.4f}  (")
    metrics = [json.loads(ln) for ln in (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [0, 1, 2, 3] and [m["loss"] for m in metrics] == p_res.losses


def test_pose_fit_matches_jax(monkeypatch, capsys, tmp_path):
    argv = ["--steps", 4]
    j_img, (j_res,), j_lines = run_jax("pose_fit", [*argv, "--out", tmp_path / "jax"], monkeypatch, capsys)
    _, (f_res,), _ = run_jax("pose_fit", [*argv, "--out", tmp_path / "fused"], monkeypatch, capsys, **PALLAS)
    p_img, (p_res,), p_lines = run_port("pose_fit", [*argv, "--out", tmp_path / "port"], monkeypatch, capsys)

    print("[measured] pose_fit losses vs JAX's XLA and fused engines:", _rel(p_res.losses, j_res.losses),
          _rel(p_res.losses, f_res.losses))
    assert len(p_res.losses) == 4
    assert _rel(p_res.losses, j_res.losses) <= 1e-4 and _rel(p_res.losses, f_res.losses) <= 1e-4
    cam_true = np.array([0.0, 0.2, 2.0], np.float32)
    pos0 = cam_true + np.float32(0.06) * np.array([1.0, -0.7, 1.3], np.float32)
    j_pos, p_pos = np.asarray(j_res.camera.position), p_res.camera.position.detach().numpy()
    share = float(np.linalg.norm(p_pos - j_pos) / np.linalg.norm(j_pos - pos0))
    print("[measured] pose_fit position off JAX's, of its move:", share)
    assert share <= 0.15
    for name in ("target.png", "init.png"):
        check_pixel_budget(p_img[name], j_img[name], name, channel_axis=-1)
    assert np.isfinite(p_img["fitted.png"]).all()
    p_out, j_out = _printed(p_lines), _printed(j_lines)
    assert p_out[0] == f"loss {p_res.losses[0]:.3f} -> {p_res.losses[-1]:.4f}"
    e_p = [float(x) for x in p_out[1].split("position error ")[1].split("   ->")[0].split(" -> ")]
    e_j = [float(x) for x in j_out[1].split("position error ")[1].split("   ->")[0].split(" -> ")]
    assert e_p[0] == e_j[0] and abs(e_p[1] - e_j[1]) <= 0.15 * abs(e_j[1] - e_j[0]) + 1e-4


def test_grid_fit_matches_jax(monkeypatch, capsys, tmp_path):
    argv = ["--res", 8, "--size", 32, "--steps", 3]
    j_img, (j_res,), j_lines = run_jax("grid_fit", [*argv, "--out", tmp_path / "jax"], monkeypatch, capsys)
    p_img, (p_res,), p_lines = run_port("grid_fit", [*argv, "--out", tmp_path / "port"], monkeypatch, capsys)

    print("[measured] grid_fit losses vs JAX's:", _rel(p_res.losses, j_res.losses))
    assert len(p_res.losses) == 3 and _rel(p_res.losses, j_res.losses) <= 1e-4
    assert sorted(p_img) == sorted(j_img) == ["fitted.png", "initial.png", "target.png"]
    for name in sorted(p_img):
        check_pixel_budget(p_img[name], j_img[name], name, channel_axis=-1, **NEURAL_BAR)
    p_out, j_out = _printed(p_lines), _printed(j_lines)
    assert p_out[0] == f"losses: {['%.1f' % x for x in p_res.losses]}"
    assert p_out[1].startswith("mean-sq pixel error: initial ") and j_out[1].startswith("mean-sq pixel error: initial ")
    err_p = [float(x) for x in p_out[1].split("initial ")[1].split(" -> fitted ")]
    err_j = [float(x) for x in j_out[1].split("initial ")[1].split(" -> fitted ")]
    assert err_p[1] < err_p[0] and err_p == pytest.approx(err_j, rel=1e-3, abs=1e-5)
