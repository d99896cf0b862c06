"""Render-setup files (the port of ``sdf3d_tpu/sdf/io.py``).

Reads and writes the JAX package's tagged JSON format (``"sdf3d-tpu/1"``) for
the classes ported so far, so a setup written by either package loads in the
other with every float32 leaf bit-exact: small arrays are JSON lists (decimal
shortest-round-trip doubles, a superset of float32), arrays of more than 256
elements base64-packed raw bytes.  The registry is closed: an unknown type in
a file fails loudly.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import pathlib

import numpy as np
import torch
from torch import nn

from sdf3d_tpu_torch.sdf.node import SDFNode

_LIST_MAX = 256
_FORMAT = "sdf3d-tpu/1"
_DTYPE_ALLOWLIST = ("float32", "int32", "bool")


def registry() -> dict:
    """Class name -> the port's class, for every type a setup file may hold."""
    from sdf3d_tpu_torch.camera import Camera
    from sdf3d_tpu_torch.config import AOConfig, MarchConfig, RenderConfig, ShadowConfig
    from sdf3d_tpu_torch.lighting import Material, PointLight
    from sdf3d_tpu_torch.sdf import csg, primitives, transforms
    from sdf3d_tpu_torch.sdf.grid import VoxelGrid
    from sdf3d_tpu_torch.sdf.materials import Shaded
    from sdf3d_tpu_torch.sdf.neural import NeuralSDF

    classes = (primitives.Sphere, primitives.Plane, primitives.Box, primitives.RoundBox, primitives.Torus,
               primitives.Capsule, primitives.Cylinder, primitives.Ellipsoid, primitives.Mandelbulb,
               csg.Union, csg.Intersection, csg.Subtraction, csg.SmoothUnion, csg.SmoothIntersection,
               csg.SmoothSubtraction, transforms.Translate, transforms.Rotate, transforms.Scale, transforms.Round,
               transforms.Onion, transforms.Elongate, transforms.RepeatInfinite, Shaded, VoxelGrid, NeuralSDF, Camera,
               PointLight,
               Material, RenderConfig, MarchConfig, ShadowConfig, AOConfig)
    return {cls.__name__: cls for cls in classes}


def _field_names(v) -> list[str]:
    if isinstance(v, SDFNode):
        return list(v.fields)
    return [f.name for f in dataclasses.fields(v)]


def _encode(v):
    if isinstance(v, torch.Tensor):
        a = v.detach().cpu().numpy()
        out = {"__array__": True, "dtype": str(a.dtype), "shape": list(a.shape)}
        if a.size <= _LIST_MAX:
            out["data"] = a.tolist()
        else:
            out["b64"] = base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")
        return out
    if isinstance(v, SDFNode) or (dataclasses.is_dataclass(v) and not isinstance(v, type)):
        return {
            "__type__": type(v).__name__,
            "fields": {name: _encode(getattr(v, name)) for name in _field_names(v)},
        }
    if isinstance(v, (tuple, list, nn.ParameterList)):
        # A node's tuple field (an nn.ParameterList) is a tuple in the format.
        return {"__seq__": "list" if isinstance(v, list) else "tuple", "items": [_encode(x) for x in v]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cannot serialize {type(v).__name__}: {v!r}")


def _decode(v, classes: dict):
    if isinstance(v, dict) and v.get("__array__"):
        if str(v["dtype"]) not in _DTYPE_ALLOWLIST:
            raise ValueError(f"scene file array dtype {v['dtype']!r} not allowed; expected one of {_DTYPE_ALLOWLIST}")
        dtype = np.dtype(v["dtype"])
        shape = tuple(int(s) for s in v["shape"])
        if "b64" in v:
            raw = base64.b64decode(v["b64"])
            expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if len(raw) != expected:
                raise ValueError(f"scene file array payload is {len(raw)} bytes but shape {shape} dtype {dtype} needs {expected}")
            a = np.frombuffer(raw, dtype=dtype).reshape(shape)
        else:
            a = np.asarray(v["data"], dtype=dtype).reshape(shape)
        return torch.from_numpy(a.copy())
    if isinstance(v, dict) and "__type__" in v:
        name = v["__type__"]
        if name not in classes:
            raise ValueError(f"unknown or not yet ported node/config type {name!r} in scene file")
        fields = {k: _decode(x, classes) for k, x in v["fields"].items()}
        return classes[name](**fields)
    if isinstance(v, dict) and "__seq__" in v:
        items = [_decode(x, classes) for x in v["items"]]
        return tuple(items) if v["__seq__"] == "tuple" else items
    return v


def scene_to_json(obj, indent: int | None = 2) -> str:
    """Serialize a scene, camera, light, material, config, or a dict of them."""
    payload = {k: _encode(v) for k, v in obj.items()} if isinstance(obj, dict) else _encode(obj)
    return json.dumps({"format": _FORMAT, "root": payload}, indent=indent)


def scene_from_json(text: str):
    doc = json.loads(text)
    if not isinstance(doc, dict) or doc.get("format") != _FORMAT:
        raise ValueError(f"not an {_FORMAT} file")
    classes = registry()
    root = doc["root"]
    if isinstance(root, dict) and "__type__" not in root and "__seq__" not in root and not root.get("__array__"):
        return {k: _decode(v, classes) for k, v in root.items()}
    return _decode(root, classes)


def save_scene(path, scene: SDFNode) -> None:
    """Write a scene tree to ``path`` as editable JSON."""
    pathlib.Path(path).write_text(scene_to_json(scene))


def load_scene(path) -> SDFNode:
    """Load a scene written by :func:`save_scene` (of either package) or by
    hand."""
    obj = scene_from_json(pathlib.Path(path).read_text())
    if not isinstance(obj, SDFNode):
        raise ValueError(f"{path} does not contain a scene node (got {type(obj).__name__})")
    return obj


def save_setup(path, scene, camera=None, light=None, material=None, config=None) -> None:
    """Write a render setup (scene + view + config) to one JSON file;
    ``None`` entries are omitted."""
    doc = {"scene": scene}
    for key, value in (("camera", camera), ("light", light), ("material", material), ("config", config)):
        if value is not None:
            doc[key] = value
    pathlib.Path(path).write_text(scene_to_json(doc))


def load_setup(path) -> dict:
    """Load a setup file: a dict with ``scene`` plus ``camera`` / ``light`` /
    ``material`` / ``config``, reference defaults where the file has none."""
    obj = scene_from_json(pathlib.Path(path).read_text())
    if isinstance(obj, SDFNode):
        obj = {"scene": obj}
    if not isinstance(obj, dict) or "scene" not in obj:
        raise ValueError(f"{path} has no 'scene' entry")
    from sdf3d_tpu_torch.camera import Camera
    from sdf3d_tpu_torch.config import REFERENCE_CONFIG
    from sdf3d_tpu_torch.lighting import reference_light, reference_material

    obj.setdefault("camera", Camera.reference())
    obj.setdefault("light", reference_light())
    obj.setdefault("material", reference_material())
    obj.setdefault("config", REFERENCE_CONFIG)
    return obj
