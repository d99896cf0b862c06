"""The port's package boundary: no JAX at import, objects carried over from the
JAX package bit for bit, and loud failures where the port has no support yet."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_scene_multiview, fit_view
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source, pack_uniforms, render_kernel_forward
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import make_mesh
from sdf3d_tpu_torch.sdf import SDFNode, load_setup, save_setup
from sdf3d_tpu_torch.utils.parity import check_pixel_budget

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(20261016)


def _random_jax_setup():
    """A three-leaf scene, an orbit camera and a non-default config, with
    parameters drawn from a fixed numpy seed."""
    r = RNG.uniform(-1.0, 1.0, 12).astype(np.float32)
    scene = s.sdf.union(
        s.sdf.plane(normal=r[0:3], offset=r[3]),
        s.sdf.sphere(center=r[4:7], radius=abs(r[7]) + 0.1),
        s.sdf.sphere(center=r[8:11], radius=abs(r[11]) + 0.1),
    )
    cam = s.Camera.orbit(azimuth_deg=float(r[0]) * 90.0, elevation_deg=15.0, radius=2.5, fov_deg=47.0)
    light = s.point_light(position=r[1:4] * 5.0, ambient=0.15)
    mat = s.material(diffuse=np.abs(r[4:7]), shininess=9.0)
    cfg = dataclasses.replace(
        s.REFERENCE_CONFIG, width=64, height=48, normals="tetrahedron", background=(0.1, 0.2, 0.3),
        ao=dataclasses.replace(s.REFERENCE_CONFIG.ao, enabled=True, samples=3),
    )
    return scene, cam, light, mat, cfg


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, sys, sdf3d_tpu_torch\n"
        "for m in pkgutil.walk_packages(sdf3d_tpu_torch.__path__, 'sdf3d_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import sdf3d_tpu_torch.fit, sdf3d_tpu_torch.cli\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'optax', 'sdf3d_tpu') or k.startswith(('jax.', 'optax.', 'sdf3d_tpu.')))\n"
        "print(len(list(pkgutil.walk_packages(sdf3d_tpu_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_the_port_or_the_smoke():
    """No module of the port (the interactive runtime, its examples and the
    labs among them) and not ``chip_smoke.py`` imports ``jax`` or the JAX
    package, at module level or inside a function; the walk of
    :func:`test_import_leaves_jax_out` reaches the new modules."""
    import pkgutil
    import re

    names = {m.name for m in pkgutil.walk_packages(tt.__path__, "sdf3d_tpu_torch.")}
    assert {"sdf3d_tpu_torch.interact.app", "sdf3d_tpu_torch.interact.controller", "sdf3d_tpu_torch.interact.devices",
            "sdf3d_tpu_torch.interact.viewer", "sdf3d_tpu_torch.examples.live_view",
            "sdf3d_tpu_torch.examples.turntable", "sdf3d_tpu_torch.benchmarks.perf_lab",
            "sdf3d_tpu_torch.benchmarks.fast_profile", "sdf3d_tpu_torch.benchmarks.scaling_report",
            "sdf3d_tpu_torch.benchmarks.collectives_lab", "sdf3d_tpu_torch.examples.inverse_fit",
            "sdf3d_tpu_torch.examples.pose_fit", "sdf3d_tpu_torch.examples.render_gallery",
            "sdf3d_tpu_torch.examples.neural_sdf", "sdf3d_tpu_torch.examples.grid_fit",
            "sdf3d_tpu_torch.examples.sharded_render"} <= names
    bad = re.compile(r"^\s*(import|from) (jax|sdf3d_tpu)(\.| |$)", re.M)
    files = sorted((REPO / "sdf3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    assert not [str(f) for f in files if bad.search(f.read_text())]


@pytest.mark.parametrize("route", ["from_jax", "load_setup"])
def test_objects_carried_over_bit_exact(route, tmp_path):
    scene, cam, light, mat, cfg = _random_jax_setup()
    if route == "from_jax":
        t_scene, t_cam, t_light, t_mat, t_cfg = (convert.from_jax(o) for o in (scene, cam, light, mat, cfg))
    else:
        path = tmp_path / "setup.json"
        s.sdf.save_setup(path, scene, cam, light, mat, cfg)
        setup = load_setup(path)
        t_scene, t_cam, t_light, t_mat, t_cfg = (setup[k] for k in ("scene", "camera", "light", "material", "config"))

    assert type(t_scene).__name__ == "Union"
    np.testing.assert_array_equal(scene_param_vector(t_scene).numpy(), np.asarray(jax_scene_param_vector(scene)))
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(cfg)
    for j, t in ((cam, t_cam), (light, t_light), (mat, t_mat)):
        for f in dataclasses.fields(j):
            np.testing.assert_array_equal(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)))
    ju = np.asarray(jax_pack_uniforms(cam, light, mat, cfg.ray_mode))
    tu = pack_uniforms(t_cam, t_light, t_mat, t_cfg.ray_mode).numpy()
    np.testing.assert_array_max_ulp(tu, ju, maxulp=1)


def test_port_setup_loads_in_jax_bit_exact(tmp_path):
    scene, cam, light, mat, cfg = _random_jax_setup()
    path = tmp_path / "port.json"
    save_setup(path, *(convert.from_jax(o) for o in (scene, cam, light, mat, cfg)))
    back = s.sdf.load_setup(path)
    np.testing.assert_array_equal(
        np.asarray(jax_scene_param_vector(back["scene"])), np.asarray(jax_scene_param_vector(scene))
    )
    np.testing.assert_array_equal(np.asarray(back["camera"].c2w), np.asarray(cam.c2w))
    assert back["config"] == cfg


def test_reference_scene_param_vector():
    np.testing.assert_array_equal(
        scene_param_vector(tt.reference_scene()).numpy(),
        np.asarray([0, 1, 0, 0, 0, 0.4, 0, 0.2], np.float32),
    )
    np.testing.assert_array_equal(
        scene_param_vector(tt.reference_scene()).numpy(), np.asarray(jax_scene_param_vector(s.reference_scene()))
    )


def test_unknown_jax_class_raises():
    # Every node class of the JAX package has a counterpart now (VoxelGrid
    # since ROADMAP item 14), so the case is a node class of its own.
    import flax.struct

    @flax.struct.dataclass
    class Gyroid(s.sdf.SDFNode):
        scale: object

    with pytest.raises(TypeError, match="Gyroid"):
        convert.from_jax(Gyroid(scale=np.float32(1.0)))


class Box(SDFNode):
    """A node the render kernel has no emitter for (a class of its own, not
    the port's ``sdf.Box``)."""

    fields = ("center", "half_extents")


CFG = dataclasses.replace(tt.REFERENCE_CONFIG, width=32, height=24)
VIEW = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())


def test_kernel_path_raises_for_unsupported_node():
    scene = tt.sdf.union(tt.sdf.ground_plane(), Box(center=(0, 0, 0), half_extents=(1, 1, 1)))
    with pytest.raises(NotImplementedError, match="Box"):
        cuda_scene_source(scene, CFG, KernelConfig())
    with pytest.raises(NotImplementedError, match="Box"):
        render_kernel_forward(scene, *VIEW, CFG)
    with pytest.raises(NotImplementedError, match="A VoxelGrid has no kernel"):
        render_kernel_forward(scene, *VIEW, CFG)


@pytest.mark.parametrize(
    "cfg",
    [
        dataclasses.replace(CFG, march=dataclasses.replace(CFG.march, relaxation=1.6)),
        dataclasses.replace(CFG, normals="autodiff"),
    ],
    ids=["relaxed", "autodiff"],
)
def test_kernel_path_raises_for_later_settings(cfg):
    """The relaxed march is ported (ROADMAP 13c): the kernel path renders it
    (the plain version, on the CPU), as the torch engine's relaxed march.
    Autodiff normals raise ``ValueError`` on the kernel path, as JAX's Pallas
    path does; the torch engine takes them."""
    if cfg.normals == "autodiff":
        with pytest.raises(ValueError, match="autodiff"):
            render_kernel_forward(tt.reference_scene(), *VIEW, cfg)
        return
    rgb, t, _, _ = render_kernel_forward(tt.reference_scene(), *VIEW, cfg)
    assert torch.isfinite(rgb).all()
    check_pixel_budget(rgb, tt.render(tt.reference_scene(), *VIEW, cfg), channel_axis=-1)


def test_no_quiet_move_to_cpu():
    """The main path defaults to the card; without one it fails, it does not
    render on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the cuda-marked tests cover this path")
    with pytest.raises((RuntimeError, AssertionError)):
        tt.render_batch(tt.reference_scene(), [VIEW[0]], VIEW[1], VIEW[2], CFG)
    with pytest.raises((RuntimeError, AssertionError)):
        render_kernel_forward(tt.reference_scene(), *VIEW, CFG, device="cuda")


def test_forward_records_no_graph():
    scene = tt.reference_scene()
    assert all(p.requires_grad for p in scene.parameters())
    rgb, t, sh, ao = render_kernel_forward(scene, *VIEW, CFG)
    assert not any(x.requires_grad for x in (rgb, t, sh, ao))
    assert not tt.render(scene, *VIEW, CFG).requires_grad


def test_fit_config_from_jax():
    got = convert.from_jax(JaxFitConfig(steps=7, learning_rate=3e-3, optimizer="sgd", engine="pallas",
                                        pallas_interpret=True, pallas_tile=(8, 128), loss="multiscale"))
    assert got == FitConfig(steps=7, learning_rate=3e-3, optimizer="sgd", engine="kernel", loss="multiscale")
    # The sharding fields carry over, the ring all-reduces included.
    sharded = dict(shard_interleaved=True, shard_layout="tiles", shard_policy="balanced", replan_every=3,
                   allreduce="psum")
    got = convert.from_jax(JaxFitConfig(engine="pallas", **sharded))
    assert got == FitConfig(**sharded)
    assert {k: getattr(got, k) for k in sharded} == sharded
    assert convert.from_jax(JaxFitConfig(steps=3)) == FitConfig(steps=3, engine="torch")  # JAX's default "xla"
    for ring in ("pallas_ring", "pallas_rs_ag", "pallas_ring_interpret", "pallas_rs_ag_interpret"):
        assert convert.from_jax(JaxFitConfig(engine="pallas", allreduce=ring)) == FitConfig(allreduce=ring)
    with pytest.raises(ValueError, match="allreduce"):
        convert.from_jax(JaxFitConfig(allreduce="nccl"))


FIT_ARGS = (np.zeros((24, 32, 3), np.float32), tt.reference_scene(), *VIEW, CFG)


@pytest.mark.parametrize(
    "kwargs,raises",
    [
        # JAX's "xla" engine is the port's "torch" (diff.py), which runs;
        # the name "xla" is an unknown engine.
        (dict(fit_config=FitConfig(steps=2, engine="torch")), None),
        # The silhouette term outside the fused step runs on diff.coverage;
        # with autodiff normals the kernel engine raises JAX's ValueError.
        (dict(fit_config=FitConfig(silhouette_weight=0.5), render_config=dataclasses.replace(CFG, normals="autodiff")),
         (ValueError, "central/tetrahedron normals")),
        (dict(fit_config=FitConfig(steps=2, silhouette_weight=0.5, loss="multiscale", pyramid_levels=4),
              target_coverage=np.ones((24, 32), np.float32)), None),
        # A sharded multiscale fit whose pyramid the block cannot hold: each
        # rank's rows on K1 + K5 (the row route, ROADMAP item 15b).
        (dict(mesh=make_mesh("cpu"), fit_config=FitConfig(steps=2, loss="multiscale"),
              kernel_config=KernelConfig(block_w=16, block_h=4)), None),
        # The shadow re-marched in the backward (ROADMAP item 12).
        (dict(fit_config=FitConfig(steps=2),
              render_config=dataclasses.replace(CFG, shadow=dataclasses.replace(CFG.shadow, grad="ad"))), None),
    ],
    ids=["xla", "silhouette", "coverage", "mesh", "shadow_ad"],
)
def test_fit_options_that_wait_raise(kwargs, raises):
    """The fit options that waited for a later item run now, or raise as
    JAX's do: those of ROADMAP item 5 (diff.py), a sharded fit outside the
    fused step (item 15b) and ``shadow.grad == "ad"`` on the kernel engine
    (item 12)."""
    args = list(FIT_ARGS)
    if "render_config" in kwargs:
        args[-1] = kwargs.pop("render_config")
    if raises is None:
        res = fit_scene(*args, **kwargs, device="cpu")
        assert res.steps_run == 2 and all(np.isfinite(res.losses))
        if kwargs["fit_config"].engine == "torch":
            with pytest.raises(ValueError, match="unknown engine 'xla'; choose 'kernel' or 'torch'"):
                fit_scene(*args, FitConfig(engine="xla"), device="cpu")
        return
    with pytest.raises(raises[0], match=raises[1]):
        fit_scene(*args, **kwargs, device="cpu")


@pytest.mark.parametrize("fn", [fit_view, fit_scene_multiview])
def test_fit_entry_points_that_wait_raise(fn):
    """The routes that waited for diff.py (ROADMAP item 5) run: fit_view
    outside the fused step (a pyramid deeper than the block: the
    differentiable kernel render) and the multi-view fit on the torch
    engine (JAX's "xla")."""
    if fn is fit_view:
        res = fn(*FIT_ARGS, fit_config=FitConfig(steps=2, loss="multiscale", pyramid_levels=4), device="cpu")
    else:
        target, scene, camera, light, mat, cfg = FIT_ARGS
        res = fn([target], scene, [camera], light, mat, cfg, fit_config=FitConfig(steps=2, engine="torch"),
                 device="cpu")
    assert res.steps_run == 2 and all(np.isfinite(res.losses))


def test_fit_has_no_quiet_move_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the cuda-marked tests cover this path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_scene(*FIT_ARGS, FitConfig(steps=1))


@pytest.mark.parametrize("module", ["sdf3d_tpu", "sdf3d_tpu.sdf", "sdf3d_tpu.interact"])
def test_exports_carry_every_jax_name(module):
    """Every name the JAX package exports (``__all__`` of the package, of
    ``sdf`` and of ``interact``) resolves in the port under the same name;
    ROADMAP's "Do not port these" list leaves none of them out."""
    import importlib

    jax_mod = importlib.import_module(module)
    port_mod = importlib.import_module(module.replace("sdf3d_tpu", "sdf3d_tpu_torch"))
    missing = [n for n in jax_mod.__all__ if not hasattr(port_mod, n)]
    assert not missing, missing
    if module != "sdf3d_tpu":
        assert not [n for n in jax_mod.__all__ if n not in port_mod.__all__]
    if module == "sdf3d_tpu.interact":
        star = {}
        exec("from sdf3d_tpu_torch.interact import *", star)
        assert set(jax_mod.__all__) <= set(star)


def test_13b_exports_carry_the_jax_names():
    """The primitives, transforms, factories and scenes of ROADMAP item 13b
    under the JAX package's names; every node class of JAX's
    ``sdf/primitives.py`` and ``sdf/transforms.py`` but Mandelbulb (13c)
    has a counterpart the scene compiler accepts."""
    import inspect
    import re

    import sdf3d_tpu.sdf.primitives as jp
    import sdf3d_tpu.sdf.transforms as jt
    from sdf3d_tpu_torch.ops.scene_program import check_scene

    names = ("Capsule", "Cylinder", "Ellipsoid", "capsule", "cylinder", "ellipsoid", "Translate", "Rotate", "Scale",
             "Round", "Onion", "Elongate", "RepeatInfinite", "translate", "rotate", "scale", "round_edges", "onion",
             "elongate", "repeat_infinite", "rotvec_to_matrix")
    assert all(n in tt.sdf.__all__ and hasattr(tt.sdf, n) for n in names)
    assert all(hasattr(tt, n) for n in ("csg_showcase", "lattice_scene", "capsule_chain", "random_blobs"))
    classes = [c for mod in (jp, jt) for _, c in inspect.getmembers(mod, inspect.isclass)
               if issubclass(c, s.sdf.SDFNode) and c is not s.sdf.SDFNode and c.__module__ == mod.__name__]
    assert {c.__name__ for c in classes} >= {"Capsule", "Translate", "RepeatInfinite", "Mandelbulb"}
    sphere = tt.sdf.sphere((0.0, 0.3, 0.0), 0.2)
    for c in classes:
        if c.__name__ == "Mandelbulb":
            continue
        port = getattr(tt.sdf, c.__name__)
        node = port(sphere, [0.1, 0.2, 0.3] if c.__name__ in ("Translate", "Rotate", "Elongate", "RepeatInfinite")
                    else 0.1) if "child" in port.fields else convert.from_jax(
            getattr(jp, re.sub(r"(?<!^)(?=[A-Z])", "_", c.__name__).lower())())
        check_scene(tt.sdf.union(tt.sdf.ground_plane(), node))
