"""Carry objects of the JAX package over to the port.

``from_jax(obj)`` turns a JAX scene node, ``Camera``, ``PointLight``,
``Material`` or a ``RenderConfig`` family config into the port's object of
the same class name.  It walks dataclass fields and reads every array leaf
with ``np.asarray(leaf, np.float32)``, so it never imports JAX and works on
JAX arrays and numpy leaves alike.  The registry is closed: a class the port
does not have raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdf3d_tpu_torch.sdf import io


def from_jax(obj):
    """The port's counterpart of ``obj`` (see the module docstring)."""
    return _convert(obj, io.registry())


def _convert(v, classes: dict):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name not in classes:
            raise TypeError(f"{name} has no counterpart in sdf3d_tpu_torch yet")
        fields = {f.name: _convert(getattr(v, f.name), classes) for f in dataclasses.fields(v)}
        return classes[name](**fields)
    if isinstance(v, (tuple, list)):
        return type(v)(_convert(x, classes) for x in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return torch.from_numpy(np.array(np.asarray(v, np.float32)))
