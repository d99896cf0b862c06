"""The fit's optimizer in the reference: Adam (Kingma and Ba, with bias
corrections; betas 0.9 and 0.999, eps 1e-8), one step from a given state,
and whole runs of it on the reference's own gradients (the control's
trajectory)."""

from __future__ import annotations

import math

import torch

from portbench.reference import shader

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_step(p, g, m, v, step: int, lr: float):
    """``(p, m, v)`` after Adam's ``step``-th update (1-based) with gradient
    ``g`` from the moments ``m`` and ``v``."""
    g = g.to(p.dtype)
    m = m + (1.0 - BETA1) * (g - m)
    v = BETA2 * v + (1.0 - BETA2) * g * g
    bc1, bc2 = 1.0 - BETA1 ** step, 1.0 - BETA2 ** step
    denom = v.sqrt() / math.sqrt(bc2) + ADAM_EPS
    return p - (lr / bc1) * m / denom, m, v


def replay(scene, keys: list, camera: dict, light: dict, mat: dict, settings: dict, target: torch.Tensor,
           steps: int, lr: float, record=()):
    """Run ``steps`` Adam steps from ``scene``'s values (moved in place).
    Returns ``(losses, states)``: the loss before each step, and for each
    step in ``record`` the state before it, ``{"theta", "grad", "m", "v"}``
    (key -> tensor)."""
    m = {k: torch.zeros_like(scene.tensors[k]) for k in keys}
    v = {k: torch.zeros_like(scene.tensors[k]) for k in keys}
    losses, states = [], {}
    for step in range(steps):
        value, grads = shader.loss_and_grads(scene, keys, camera, light, mat, settings, target)
        losses.append(float(value))
        if step in record:
            states[step] = {"theta": {k: scene.tensors[k].detach().clone() for k in keys},
                            "grad": {k: grads[k].to(scene.tensors[k].dtype) for k in keys},
                            "m": dict(m), "v": dict(v)}
        with torch.no_grad():
            for k in keys:
                p, m[k], v[k] = adam_step(scene.tensors[k], grads[k], m[k], v[k], step + 1, lr)
                scene.tensors[k].copy_(p)
    return losses, states
