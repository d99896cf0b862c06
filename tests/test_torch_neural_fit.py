"""Fitting a NeuralSDF (ROADMAP items 17a and 17b) against the JAX package
on the CPU; the MLPs are distilled or initialised in JAX and carried over
with ``convert.from_jax``.

- 17a, unsharded (``tests/test_neural.py``'s image fit): the kernel engine
  (the neural kernel's plain version forward, the planar shade re-traced as
  backward) against JAX's ``engine="pallas"`` fit (its banded render and
  planar shade) and its ``"xla"`` fit; the torch engine (``diff.py``)
  against JAX's ``"xla"``;
- 17b, two gloo processes (``tests/test_neural.py``'s sharded fit, on the
  ``tests/test_torch_launch.py`` pattern): each rank renders its rows
  through ``diff.render_rays_diff`` in bands and the MLP's gradient is
  all-reduced with ``psum``, the latency ring and the reduce-scatter +
  all-gather ring (their plain versions on CPU ranks), contiguous and
  interleaved, against the port's unsharded torch-engine fit and JAX's fit
  on its 8-device CPU mesh at JAX's bars (losses 1e-5 relative, the MLP
  1e-4 relative plus 1e-6); then ``fit_scene(mesh, engine="torch")`` on the
  reference scene against the unsharded torch-engine fit.

Losses are held at 1e-4 relative across packages (the fit tests' bar),
the weights at 1e-4 relative plus 1e-6.  About 60 s on one worker."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.flatten_util as fu
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu import sdf as jsdf
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene as jax_fit_scene
from sdf3d_tpu.parallel import make_mesh as jax_make_mesh
from sdf3d_tpu.sdf import distill as jax_distill
from sdf3d_tpu.sdf import neural_sdf as jax_neural_sdf
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.scene_program import count_params, scene_param_vector
from sdf3d_tpu_torch.parallel.collectives import resolve_algorithm
from sdf3d_tpu_torch.sdf import NeuralSDF

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfg(width, height, steps):
    ref = s.REFERENCE_CONFIG
    return dataclasses.replace(ref, width=width, height=height, march=dataclasses.replace(ref.march, max_steps=steps),
                               shadow=dataclasses.replace(ref.shadow, enabled=False))


@pytest.fixture(scope="module")
def image_fit():
    """``test_neural.py``'s image fit: the distilled MLP, the target and the
    view (48×36, 48-step march, no shadow)."""
    jcfg = _cfg(48, 36, 48)
    view = (s.Camera.reference(), s.reference_light(), s.reference_material())
    target = np.asarray(s.render(jsdf.sphere(center=(0.05, 0.42, 0.0), radius=0.23), *view, jcfg))
    m0, _ = jax_distill(jax_neural_sdf(key=0, hidden=32, depth=3, radius=0.3),
                        jsdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2), key=1, steps=150, batch=1024,
                        lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6))
    return jcfg, view, target, m0


def _jax_fit(image_fit, engine):
    jcfg, view, target, m0 = image_fit
    return jax_fit_scene(target, m0, *view, jcfg, JaxFitConfig(steps=4, learning_rate=1e-4, log_every=1,
                                                               engine=engine))


def _port_fit(image_fit, engine):
    jcfg, view, target, m0 = image_fit
    return fit_scene(target, convert.from_jax(m0), *(convert.from_jax(o) for o in view), convert.from_jax(jcfg),
                     FitConfig(steps=4, learning_rate=1e-4, log_every=1, engine=engine), device="cpu")


@pytest.mark.parametrize("engine,jax_engines", [("kernel", ("pallas", "xla")), ("torch", ("xla",))])
def test_neural_image_fit_matches_jax(image_fit, engine, jax_engines):
    """Four Adam steps of the distilled MLP: the losses and the fitted
    weights against each of JAX's engines; the loss falls."""
    got = _port_fit(image_fit, engine)
    assert isinstance(got.scene, NeuralSDF) and got.losses[-1] < got.losses[0]
    for jengine in jax_engines:
        want = _jax_fit(image_fit, jengine)
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, err_msg=jengine)
        np.testing.assert_allclose(scene_param_vector(got.scene).numpy(), np.asarray(fu.ravel_pytree(want.scene)[0]),
                                   rtol=1e-4, atol=1e-6, err_msg=jengine)


def test_auto_allreduce_takes_rs_ag_for_the_hidden_64_gradient():
    """The gradient of ``neural_sdf(hidden=64)`` (4482 values, with the loss
    4483) is past ``_rs_ag_threshold(2)`` = 4096: ``"pallas_ring"`` runs
    the reduce-scatter + all-gather ring between two ranks; the fit demo's
    9 values run the latency ring."""
    n = count_params(tt.sdf.neural_sdf(0, hidden=64, depth=3))
    assert n == 4482
    assert resolve_algorithm("auto", n + 1, 2) == "rs_ag" and resolve_algorithm("auto", 9, 2) == "ring"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


SHARDED = {  # name: FitConfig fields of the two-rank neural fits
    "psum": dict(allreduce="psum"),
    "ring": dict(allreduce="pallas_ring"),
    "rs_ag": dict(allreduce="pallas_rs_ag"),
    "interleaved": dict(allreduce="psum", shard_layout="interleaved"),
}

WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import launch, make_mesh

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, device="cpu")
mesh = make_mesh("cpu")
spec = json.load(open(os.path.join(outdir, "spec.json")))
view = [tt.Camera.reference(), tt.reference_light(), tt.reference_material()]
out = {"rank": mesh.rank, "fits": {}}
m0 = torch.load(os.path.join(outdir, "m0.pt"), weights_only=False)
ncfg = torch.load(os.path.join(outdir, "ncfg.pt"), weights_only=False)
target = np.load(os.path.join(outdir, "target.npy"))
for name, extra in spec["sharded"].items():
    res = fit_scene(target, m0, *view, ncfg, FitConfig(steps=2, learning_rate=1e-4, log_every=1, **extra), mesh=mesh,
                    kernel_config=KernelConfig(tile_h=8, tile_w=64))
    out["fits"][name] = {"losses": res.losses, "params": scene_param_vector(res.scene).tolist()}
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=48, height=32)
ref_target = tt.render(tt.reference_scene(), *view, cfg)
start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
res = fit_scene(ref_target, start, *view, cfg, FitConfig(steps=3, learning_rate=1e-2, log_every=1, engine="torch"),
                mesh=mesh, trainable=(False, False, True, True))
out["fits"]["torch_reference"] = {"losses": res.losses, "params": scene_param_vector(res.scene).tolist()}
json.dump(out, open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""


def _sharded_setup():
    """``test_neural.py``'s sharded fit: 64×48, 32-step march, no shadow,
    ``neural_sdf(key=0, hidden=16)``."""
    jcfg = _cfg(64, 48, 32)
    view = (s.Camera.reference(), s.reference_light(), s.reference_material())
    target = np.asarray(s.render(jsdf.sphere(center=(0.05, 0.42, 0.0), radius=0.23), *view, jcfg))
    return jcfg, view, target, jax_neural_sdf(key=0, hidden=16, depth=3, radius=0.3)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("neural_ranks")
    jcfg, _, target, m0 = _sharded_setup()
    np.save(outdir / "target.npy", target)
    torch.save(convert.from_jax(m0), outdir / "m0.pt")
    torch.save(convert.from_jax(jcfg), outdir / "ncfg.pt")
    (outdir / "spec.json").write_text(json.dumps({"sharded": SHARDED}))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(r), str(outdir), str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [json.loads((outdir / f"out_r{r}.json").read_text()) for r in range(2)]
    assert outs[0]["fits"] == outs[1]["fits"]  # replicated: both ranks hold the same trajectory
    return outs[0]["fits"]


@pytest.fixture(scope="module")
def jax_mesh8_fit():
    """JAX's fit on its 8-device CPU mesh (``engine="pallas"``: each device's
    row slab through the banded ``render_rays_diff``), psum."""
    jcfg, view, target, m0 = _sharded_setup()
    return jax_fit_scene(target, m0, *view, jcfg, JaxFitConfig(steps=2, learning_rate=1e-4, log_every=1,
                                                               engine="pallas"),
                         mesh=jax_make_mesh(jax.devices("cpu"), n_devices=8))


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_two_process_neural_fit_matches_unsharded_and_jax(name, two_ranks, jax_mesh8_fit):
    jcfg, view, target, m0 = _sharded_setup()
    ref = fit_scene(target, convert.from_jax(m0), *(convert.from_jax(o) for o in view), convert.from_jax(jcfg),
                    FitConfig(steps=2, learning_rate=1e-4, log_every=1, engine="torch"), device="cpu")
    got = two_ranks[name]
    np.testing.assert_allclose(got["losses"], ref.losses, rtol=1e-5)
    np.testing.assert_allclose(got["params"], scene_param_vector(ref.scene).numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["losses"], jax_mesh8_fit.losses, rtol=1e-5)
    np.testing.assert_allclose(got["params"], np.asarray(fu.ravel_pytree(jax_mesh8_fit.scene)[0]), rtol=1e-4,
                               atol=1e-6)


def test_two_process_torch_engine_fit_matches_unsharded(two_ranks):
    """``fit_scene(mesh, engine="torch")`` on the reference scene (each
    rank's contiguous slab through ``diff.render_rays_diff``): the unsharded
    torch-engine fit's losses and parameters."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=48, height=32)
    view = [tt.Camera.reference(), tt.reference_light(), tt.reference_material()]
    start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    ref = fit_scene(tt.render(tt.reference_scene(), *view, cfg), start, *view, cfg,
                    FitConfig(steps=3, learning_rate=1e-2, log_every=1, engine="torch"),
                    trainable=(False, False, True, True), device="cpu")
    got = two_ranks["torch_reference"]
    np.testing.assert_allclose(got["losses"], ref.losses, rtol=1e-5)
    np.testing.assert_allclose(got["params"], scene_param_vector(ref.scene).numpy(), rtol=1e-5, atol=1e-7)
