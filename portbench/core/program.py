"""The program under test, ``sdf3d_tpu_torch``: its scene, camera, light,
material and render settings built from the benchmark's inputs, and its two
entry points, ``render.render_batch`` and ``fit.fit_scene``.  This file is
the only one of the harness that imports the program."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def port():
    import sdf3d_tpu_torch

    return sdf3d_tpu_torch


def build_scene(spec: dict, values: dict, path: str = ""):
    """The port's scene of the configuration's tree, with ``values``
    (``"<path>.<name>"`` keys): ``sdf3d_tpu_torch.sdf.<op>(*children,
    **params, **static)``."""
    sdf = port().sdf
    kids = [build_scene(k, values, f"{path}/{i}" if path else str(i)) for i, k in enumerate(spec.get("children", ()))]
    params = {n: values[f"{path}.{n}"].tolist() for n in spec.get("params", {})}
    return getattr(sdf, spec["op"])(*kids, **params, **spec.get("static", {}))


def _fields(node, spec: dict, path: str):
    """``(key, leaf)`` of the port node's numeric leaves in the port's leaf
    order (``scene_program.leaves``), keyed as the configuration's values."""
    kids = iter(enumerate(spec.get("children", ())))
    for name in node.fields:
        value = getattr(node, name)
        if isinstance(value, port().sdf.SDFNode):
            i, kid = next(kids)
            yield from _fields(value, kid, f"{path}/{i}" if path else str(i))
        elif name not in node.static:
            yield f"{path}.{name}", value


def leaf_values(scene, spec: dict) -> dict:
    """The scene's values, ``key -> float32 array``."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in _fields(scene, spec, "")}


def trainable(scene, spec: dict, keys: list) -> tuple:
    """``fit_scene``'s ``trainable``: one flag a leaf, set for ``keys``."""
    from sdf3d_tpu_torch.ops.scene_program import leaves

    flags = tuple(k in keys for k, _ in _fields(scene, spec, ""))
    if len(flags) != len(list(leaves(scene))):
        raise ValueError("the configuration's tree does not match the port's leaves")
    return flags


def trainable_order(scene, spec: dict, keys: list) -> list:
    """``keys`` in the port's leaf order, the optimizer's order of its
    parameters."""
    return [k for k, _ in _fields(scene, spec, "") if k in keys]


def camera(cam: dict, device):
    return port().Camera(position=torch.as_tensor(cam["position"], device=device),
                         c2w=torch.as_tensor(cam["c2w"], device=device),
                         fov_deg=torch.as_tensor(cam["fov_deg"], device=device))


def light(config: dict, device):
    lt = config["light"]
    return port().point_light(lt["position"], lt["color"], lt["ambient"], device=device)


def material(config: dict, device):
    m = config["material"]
    return port().material(m["ambient"], m["diffuse"], m["specular"], m["shininess"], device=device)


def render_config(config: dict, width: int, height: int):
    """The port's ``RenderConfig`` of the configuration's render settings."""
    tt = port()
    r = config["render"]
    return dataclasses.replace(
        tt.REFERENCE_CONFIG, width=width, height=height,
        march=tt.MarchConfig(max_steps=r["march_steps"], max_distance=r["max_distance"], epsilon=r["epsilon"]),
        shadow=tt.ShadowConfig(enabled=r["shadow"], k=r["shadow_k"], max_steps=r["shadow_steps"]),
        ao=tt.AOConfig(enabled=r["ao"]), normals=r["normals"], ray_mode=r["ray_mode"], shading=r["shading"])


def render_batch(scene, cameras, lt, mat, cfg, device):
    """One request: the images ``(N, H, W, 3)`` of ``cameras`` on the card."""
    return port().render_batch(scene, cameras, lt, mat, cfg, engine="kernel", device=device)


def fit_scene(target, scene0, cam, lt, mat, cfg, traffic: dict, flags: tuple, device):
    """One fit job: ``fit_scene`` on the kernel engine with the mix's steps,
    optimizer, learning rate, loss and logging cadence."""
    tt = port()
    fc = tt.FitConfig(steps=traffic["steps"], learning_rate=traffic["learning_rate"], optimizer=traffic["optimizer"],
                      log_every=traffic["log_every"], engine="kernel", loss=traffic["loss"])
    return tt.fit_scene(target, scene0, cam, lt, mat, cfg, fc, trainable=flags, device=device)


def build_counters() -> dict:
    """The port's native-library counters: libraries built in this process
    and their seconds."""
    from sdf3d_tpu_torch.ops import _build

    return {"builds": _build.LIBRARIES.builds, "build_seconds": _build.LIBRARIES.build_seconds}
