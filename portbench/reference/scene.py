"""A configuration's scene tree as a plain distance function.

The tree is the configuration file's ``scene``: nodes ``{"op", "params",
"static", "children"}``.  Each node's distance is the file
``reference/nodes/<op>.py``; a scene's parameter values are a flat dict
keyed ``"<path>.<name>"``, the path the child indices from the root joined
by ``/`` (``""`` for the root), so ``"1.center"`` is the center of the
root's second child."""

from __future__ import annotations

import importlib

import numpy as np
import torch


def node_module(op: str):
    return importlib.import_module(f"portbench.reference.nodes.{op}")


def walk(spec: dict, path: str = ""):
    """``(path, node)`` of every node, depth first, children in order."""
    yield path, spec
    for i, kid in enumerate(spec.get("children", ())):
        yield from walk(kid, f"{path}/{i}" if path else str(i))


def spec_values(spec: dict) -> dict:
    """The tree's own parameter values: ``"<path>.<name>" -> float32 array``."""
    return {f"{path}.{name}": np.asarray(v, np.float32)
            for path, node in walk(spec) for name, v in node.get("params", {}).items()}


def trainable_keys(spec: dict) -> list:
    """The keys of the parameters a fit moves: those a node's ``jitter``
    names, in :func:`walk` order."""
    return [f"{path}.{name}" for path, node in walk(spec) for name in node.get("jitter", {})]


def jittered(spec: dict, rng: np.random.Generator) -> dict:
    """The tree's values with each jittered parameter moved by offsets drawn
    uniformly from ``[-j, j]``, one per component."""
    values = spec_values(spec)
    for path, node in walk(spec):
        for name, j in node.get("jitter", {}).items():
            key = f"{path}.{name}"
            values[key] = (values[key] + rng.uniform(-j, j, values[key].shape)).astype(np.float32)
    return values


class PlainScene:
    """The tree's distance over points (N, 3), its parameters tensors
    (``tensors``, keyed as :func:`spec_values`) in ``dtype`` on ``device``."""

    def __init__(self, spec: dict, values: dict, dtype=torch.float32, device="cpu"):
        self.spec = spec
        self.tensors = {k: torch.as_tensor(np.asarray(v, np.float32), device=device).to(dtype)
                        for k, v in values.items()}
        self.fn = self._build(spec, "")

    def _build(self, node: dict, path: str):
        mod = node_module(node["op"])
        kids = [self._build(k, f"{path}/{i}" if path else str(i)) for i, k in enumerate(node.get("children", ()))]
        names = list(node.get("params", {}))
        static = node.get("static", {})
        tensors = self.tensors

        def distance(p):
            return mod.distance(p, {n: tensors[f"{path}.{n}"] for n in names}, kids, static)

        return distance

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return self.fn(p)
