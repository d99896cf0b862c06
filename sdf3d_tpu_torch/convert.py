"""Carry objects of the JAX package over to the port.

``from_jax(obj)`` turns a JAX scene node, ``Camera``, ``PointLight``,
``Material``, a ``RenderConfig`` family config, a ``FitConfig`` or a
``NeuralRenderConfig`` into the port's object of the same class name.  It walks dataclass fields and reads
every array leaf with ``np.asarray(leaf, np.float32)``, so it never imports
JAX and works on JAX arrays and numpy leaves alike.  The registry is closed:
a class the port does not have raises ``TypeError``.

A ``FitConfig`` maps ``engine="pallas"`` to ``"kernel"`` and ``"xla"``
(``diff.py``'s implicit-function render) to ``"torch"``, and drops the
TPU-only ``pallas_interpret`` and ``pallas_tile``; its sharding fields
(``shard_*``, ``replan_every``, ``allreduce``, the ring all-reduces
included) carry over.  A
``NeuralRenderConfig`` keeps ``block_rays`` and drops the TPU-only
``check_every`` and ``interpret``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdf3d_tpu_torch.sdf import io


def from_jax(obj):
    """The port's counterpart of ``obj`` (see the module docstring)."""
    return _convert(obj, io.registry())


_TPU_ONLY = ("pallas_interpret", "pallas_tile")
_ENGINES = {"pallas": "kernel", "xla": "torch"}


def _fit_config(v):
    from sdf3d_tpu_torch.fit import FitConfig
    from sdf3d_tpu_torch.parallel.collectives import check_allreduce

    ported = {f.name for f in dataclasses.fields(FitConfig)}
    defaults = type(v)()
    fields = {}
    for f in dataclasses.fields(v):
        value = getattr(v, f.name)
        if f.name == "allreduce":
            check_allreduce(value)  # an unknown value raises here, not at the fit
        if f.name in ported:
            fields[f.name] = _ENGINES.get(value, value) if f.name == "engine" else value
        elif f.name not in _TPU_ONLY and value != getattr(defaults, f.name):
            raise NotImplementedError(f"FitConfig.{f.name}={value!r} has no counterpart in the port")
    return FitConfig(**fields)


def _convert(v, classes: dict):
    if dataclasses.is_dataclass(v) and not isinstance(v, type) and type(v).__name__ == "FitConfig":
        return _fit_config(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type) and type(v).__name__ == "NeuralRenderConfig":
        from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig

        return NeuralRenderConfig(block_rays=v.block_rays)
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
