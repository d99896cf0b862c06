"""The port's render examples (``sdf3d_tpu_torch/examples/render_gallery.py``,
``neural_sdf.py``, ``sharded_render.py``) against the JAX package's scripts
and library calls, on the CPU at small sizes.

JAX's script runs through ``runpy.run_path`` with ``sys.argv`` patched, a
stub ``_common`` module in ``sys.modules`` (no TPU probe) and
``sdf3d_tpu.utils.write_png`` replaced by a capture of the float images; the
port's ``main(argv)`` runs with ``--device cpu`` (the kernels' plain
versions) and its ``write_png`` captured the same way.

Bars, each beside the error measured here:
- ``render_gallery --width 96 --height 72`` (AO on; at 48×36 the budget's
  0.05% is less than one of the 1728 pixels): each scene's image at its
  ``utils/parity.py::SCENE_BARS`` bar (the pixel budget; measured at most 3
  pixels over 1e-4, on ``csg_showcase``), the fractal at
  JAX's own bar between its two paths (``tests/test_fractal.py``: max 2e-2,
  mean 1e-3).  ``random_blobs`` draws from each package's own generator, so
  the port's gallery is handed JAX's spheres (``convert.from_jax``).  The
  flagship's AOVs, captured at ``sphere_trace``, ``estimate_normals``,
  ``soft_shadow`` and ``ambient_occlusion`` of both packages: ``t`` by
  ``check_planes``' clamped relative ``t``, the normals, shadow and AO at
  1e-4 under the pixel budget (the written images are their colormaps,
  whose slope reaches 5, so they are held through these);
- ``neural_sdf --hidden 16 --steps 5 --frames 2 --size 32``: JAX's distilled
  model, carried over by ``convert.from_jax``, through the port's
  ``render_frames`` against JAX's frames at ``NEURAL_BAR``; the port's own
  distillation (another generator's batches) only to a falling loss;
- ``sharded_render``: JAX's script is fixed at 256×192 with interpret-mode
  tiles, so its library calls run here at 128×48, where its (8, 128) tiles
  apply unchanged, on two of the test session's virtual CPU devices; the
  port's script runs at that size over two gloo CPU ranks.  ``render_sharded``
  equal to ``render`` bit for bit in the port, and the tile-queue image (the
  tile-queue kernel's plain version) against JAX's ``render_pallas_tiles``
  at the pixel budget.

About 60 s on one worker, most of it JAX's gallery.
"""

import dataclasses
import json
import os
import pathlib
import runpy
import subprocess
import sys
import types

import jax
import numpy as np
import torch

import sdf3d_tpu as s
import sdf3d_tpu.march as jax_march
import sdf3d_tpu.sdf as jax_sdf
import sdf3d_tpu.utils as jax_utils
import sdf3d_tpu_torch as tt
import sdf3d_tpu_torch.march as port_march
import sdf3d_tpu_torch.utils as port_utils
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, SCENE_BARS, check_pixel_budget

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
AOVS = ("sphere_trace", "estimate_normals", "soft_shadow", "ambient_occlusion")


def _capture(monkeypatch, module) -> dict:
    images = {}
    monkeypatch.setattr(module, "write_png",
                        lambda path, img: images.__setitem__(pathlib.Path(path).name, np.array(img, np.float32)))
    return images


def _spy(monkeypatch, module, names, out: dict) -> None:
    """Keep the last result of each of ``module``'s functions ``names``."""
    for name in names:
        def spy(*args, _orig=getattr(module, name), _name=name, **kwargs):
            out[_name] = _orig(*args, **kwargs)
            return out[_name]

        monkeypatch.setattr(module, name, spy)


def run_jax(name, argv, monkeypatch, capsys, spies=()):
    """JAX's ``examples/<name>.py`` with ``argv``: (images, printed lines)."""
    stub = types.ModuleType("_common")
    stub.use_live_device = lambda: False
    monkeypatch.setitem(sys.modules, "_common", stub)
    images = _capture(monkeypatch, jax_utils)
    for module, names, out in spies:
        _spy(monkeypatch, module, names, out)
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return images, lines


def run_port(name, argv, monkeypatch, capsys, spies=()):
    """The port's ``examples.<name>.main(argv + --device cpu)``."""
    import importlib

    images = _capture(monkeypatch, port_utils)
    for module, names, out in spies:
        _spy(monkeypatch, module, names, out)
    capsys.readouterr()
    assert importlib.import_module(f"sdf3d_tpu_torch.examples.{name}").main([*map(str, argv), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    return images, lines


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_render_gallery_matches_jax(monkeypatch, capsys, tmp_path):
    argv = ["--width", 96, "--height", 72]
    j_aov, p_aov = {}, {}
    j_img, j_lines = run_jax("render_gallery", [*argv, "--out", tmp_path / "jax"], monkeypatch, capsys,
                             spies=[(jax_march, AOVS, j_aov)])
    blobs = convert.from_jax(s.random_blobs(n=8))
    monkeypatch.setattr(tt, "random_blobs", lambda n=8: blobs)
    p_img, p_lines = run_port("render_gallery", [*argv, "--out", tmp_path / "port"], monkeypatch, capsys,
                              spies=[(port_march, AOVS, p_aov)])

    assert p_lines == [ln.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for ln in j_lines]
    assert sorted(p_img) == sorted(j_img) and len(p_img) == 11
    bars = {"csg_showcase": SCENE_BARS["csg_showcase"], "lattice": SCENE_BARS["lattice_scene"]}
    for name in ("reference", "flagship", "csg_showcase", "lattice", "capsule_chain", "random_blobs"):
        st = check_pixel_budget(p_img[f"{name}.png"], j_img[f"{name}.png"], name, channel_axis=-1,
                                **bars.get(name, {}))
        print(f"[measured] gallery {name}: {st['over_atol']} pixels over 1e-4, max {st['max_abs_err']:.3g}")
    err = np.abs(p_img["fractal.png"] - j_img["fractal.png"])
    print(f"[measured] gallery fractal: max {err.max():.3g}, mean {err.mean():.3g}")
    assert err.max() < 2e-2 and err.mean() < 1e-3
    # The AOVs: t clamped and relative, as check_planes compares it; the
    # rest at the pixel budget.
    max_d = s.REFERENCE_CONFIG.march.max_distance
    t_p, t_j = (np.minimum(_np(x), max_d) for x in (p_aov["sphere_trace"], j_aov["sphere_trace"]))
    check_pixel_budget(t_p, t_j, "aov t", relative=True)
    check_pixel_budget(_np(p_aov["estimate_normals"]), np.asarray(j_aov["estimate_normals"]), "aov normals",
                       channel_axis=-1)
    for name in ("soft_shadow", "ambient_occlusion"):
        check_pixel_budget(_np(p_aov[name]), np.asarray(j_aov[name]), f"aov {name}")
    assert all(np.isfinite(p_img[f"aov_{n}.png"]).all() for n in ("depth", "normals", "shadow", "ao"))


def test_neural_sdf_matches_jax(monkeypatch, capsys, tmp_path):
    from sdf3d_tpu_torch.examples import neural_sdf

    argv = ["--hidden", 16, "--steps", 5, "--frames", 2, "--size", 32]
    distilled = {}
    j_img, j_lines = run_jax("neural_sdf", [*argv, "--out", tmp_path / "jax"], monkeypatch, capsys,
                             spies=[(jax_sdf, ("distill",), distilled)])
    model = convert.from_jax(distilled["distill"][0])
    frames = neural_sdf.render_frames(model, 2, 32, "cpu").numpy()
    stats = [check_pixel_budget(frames[k], j_img[f"frame_{k:05d}.png"], f"frame {k}", channel_axis=-1, **NEURAL_BAR)
             for k in range(2)]

    p_img, p_lines = run_port("neural_sdf", [*argv, "--out", tmp_path / "port"], monkeypatch, capsys)
    print("[measured] neural frames of JAX's model:", [(st["over_atol"], st["max_abs_err"]) for st in stats])
    assert sorted(p_img) == sorted(j_img) == ["frame_00000.png", "frame_00001.png"]
    assert all(img.shape == (24, 32, 3) and np.isfinite(img).all() for img in p_img.values())
    first, last = (float(x) for x in p_lines[0].split("distill loss ")[1].split(" -> "))
    assert last < first and j_lines[0].startswith("distill loss ")
    assert p_lines[1] == j_lines[1].replace(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_sharded_render_matches_jax(tmp_path):
    from sdf3d_tpu.ops import PallasRenderConfig
    from sdf3d_tpu.parallel import make_mesh, render_pallas_tiles, render_sharded

    W, H = 128, 48
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "sdf3d_tpu_torch.examples.sharded_render", "--world", "2",
                           "--device", "cpu", "--width", str(W), "--height", str(H), "--out", str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    ranks = json.loads(lines[-1])["ranks"]
    assert lines[:3] == ["mesh: {'tiles': 2}", "sharded == single-device: True", f"output shape: ({H}, {W}, 3)"]
    assert lines[3].startswith("tile-queue sharded vs single-device: max |err| ")
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["backend"] == "gloo" and r["sharded_equal"] for r in ranks)
    port = np.load(tmp_path / "images.npz")
    assert np.array_equal(port["sharded"], port["single"])

    devices = jax.devices("cpu")
    mesh = make_mesh(devices, n_devices=2)
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    scene = s.flagship_scene()
    with jax.default_device(devices[0]):
        single = np.asarray(s.render(scene, cam, light, mat, cfg))
    sharded = np.asarray(render_sharded(scene, cam, light, mat, cfg, mesh))
    assert np.array_equal(single, sharded)
    tiles = np.asarray(render_pallas_tiles(scene, cam, light, mat, cfg, mesh,
                                           PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)))
    st = check_pixel_budget(port["tiles"], tiles, "tile queue", channel_axis=-1)
    print(f"[measured] tile queue against JAX's: {st['over_atol']} pixels over 1e-4, max {st['max_abs_err']:.3g}")
    check_pixel_budget(port["single"], single, "render", channel_axis=-1)
