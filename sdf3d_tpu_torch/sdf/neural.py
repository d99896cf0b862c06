"""Neural SDF: an MLP distance field as a scene node (the port of
``sdf3d_tpu/sdf/neural.py``).

- :class:`NeuralSDF` evaluates ``p -> W_{L-1}ᵀ σ(… σ(W_0ᵀ p + b_0) …) +
  b_{L-1}`` with ``σ(x) = softplus(β·x)/β``, always in full float32: the
  JAX package's ``precision`` is kept as a static field so setup files and
  ``convert.from_jax`` round-trip, but it selects nothing here (its default
  ``"high"``, 3-pass bf16, is float32 within 2.7e-5).
- :func:`neural_sdf` is the IGR geometric initialisation (Gropp et al.
  2020): the network starts as about ``|p| − radius``.
- :func:`distill` regresses the MLP onto another scene node with Adam, with
  surface-focused samples and the eikonal term; :func:`distill_loss` is one
  step's loss.

Random numbers come from an explicit ``torch.Generator`` (or a seed), so
they are not the JAX package's bits: tests hand both packages the same
numpy inputs and carry weights across with ``convert.from_jax``.
"""

from __future__ import annotations

import copy
import math

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode, as_f32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX computes it (``logaddexp(x, 0)``):
    ``max(x, 0) + log1p(exp(−|x|))``.  Not ``torch.nn.functional.softplus``,
    whose ``threshold=20`` switches to the linear form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mlp(x: torch.Tensor, weights, biases, beta: torch.Tensor) -> torch.Tensor:
    """The MLP of :class:`NeuralSDF` on points ``x`` (..., 3) → (...,).

    Weights (fan_in, fan_out) and biases (fan_out,) may carry leading batch
    dimensions that broadcast with ``x``'s (one weight set per point: the
    per-pixel expansion of ``utils/parity.py::gradient_mass``), and so may
    ``beta``.  Matrix products run in full float32: on the card that needs
    TF32 off, which is checked.
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("NeuralSDF runs in full float32: set torch.backends.cuda.matmul.allow_tf32 = False")
    b_ = beta[..., None] if beta.dim() else beta
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = torch.matmul(x.unsqueeze(-2), w).squeeze(-2) + b
        if i < n - 1:
            x = softplus(b_ * x) / b_
    return x[..., 0]


class NeuralSDF(SDFNode):
    """MLP distance field ``f(p) -> signed distance``.

    ``weights`` / ``biases``: tuples of layer parameters, shapes ``(3, H),
    (H, H), ..., (H, 1)`` and ``(H,), ..., (1,)``.  ``beta``: softplus
    sharpness (a scalar parameter).  ``precision``: the JAX package's matmul
    precision, static and unused (the port computes in full float32).
    """

    fields = ("weights", "biases", "beta", "precision")
    tuples = ("weights", "biases")
    static = ("precision",)
    defaults = {"precision": "high"}

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return mlp(p, list(self.weights), list(self.biases), self.beta)


def _generator(generator, device=None) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(generator))
    return gen


def neural_sdf(
    generator: torch.Generator | int = 0,
    hidden: int = 64,
    depth: int = 3,
    radius: float = 0.5,
    beta: float = 100.0,
) -> NeuralSDF:
    """Geometrically initialised MLP SDF ≈ sphere of ``radius`` at the origin,
    on the generator's device.  ``depth`` counts weight layers (≥ 2):
    ``3 → hidden×(depth−1) → 1``.  The distributions are the JAX package's:
    hidden layers N(0, 2/fan_out); the last layer √(π/fan_in) plus 1e-6·N(0, 1)
    with bias −radius."""
    if depth < 2:
        raise ValueError("depth must be >= 2 (input and output layers)")
    gen = _generator(generator)
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    dims = [3] + [hidden] * (depth - 1) + [1]
    weights, biases = [], []
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        noise = torch.randn((fan_in, fan_out), **kw)
        if i == depth - 1:
            weights.append(math.sqrt(math.pi / fan_in) + 1e-6 * noise)
            biases.append(torch.full((fan_out,), -radius, dtype=torch.float32, device=gen.device))
        else:
            weights.append(noise * (math.sqrt(2.0) / math.sqrt(fan_out)))
            biases.append(torch.zeros((fan_out,), dtype=torch.float32, device=gen.device))
    return NeuralSDF(weights=tuple(weights), biases=tuple(biases), beta=as_f32(beta, gen.device))


def distill_loss(model: NeuralSDF, target: SDFNode, pts: torch.Tensor, eikonal_weight: float = 0.1) -> torch.Tensor:
    """One distillation loss: MSE of ``model`` against ``target``'s
    distances at ``pts`` (N, 3), plus ``eikonal_weight·mean((|∇f| − 1)²)``
    with ``∇f`` the model's gradient in the points (kept in the graph, so
    the loss differentiates through it)."""
    with torch.no_grad():
        d_t = target.distance(pts)
    pts = pts.detach().requires_grad_(eikonal_weight > 0.0)
    with torch.enable_grad():
        d_m = model.distance(pts)
        loss = torch.mean((d_m - d_t) ** 2)
        if eikonal_weight > 0.0:
            (g,) = torch.autograd.grad(d_m.sum(), pts, create_graph=True)
            eik = torch.mean((torch.sqrt(torch.sum(g * g, dim=-1) + 1e-12) - 1.0) ** 2)
            loss = loss + eikonal_weight * eik
    return loss


def _sample_points(target, gen, batch, n_near, lo, hi):
    """A fresh batch in the box ``[lo, hi]``; the first ``n_near`` points are
    projected onto the target's surface (``p − d(p)·∇d(p)``) and jittered."""
    dev = gen.device
    pts = lo + (hi - lo) * torch.rand((batch, 3), generator=gen, device=dev)
    if n_near:
        sl = pts[:n_near].detach().requires_grad_(True)
        with torch.enable_grad():
            d = target.distance(sl)
            (g,) = torch.autograd.grad(d.sum(), sl)
        near = (sl - d[:, None] * g).detach()
        jitter = 0.05 * torch.randn(near.shape, generator=gen, device=dev)
        pts = torch.cat([near + jitter, pts[n_near:]], dim=0)
    return pts


def distill(
    model: NeuralSDF,
    target: SDFNode,
    generator: torch.Generator | int = 0,
    steps: int = 500,
    batch: int = 4096,
    learning_rate: float = 1e-3,
    lo=(-1.0, -1.0, -1.0),
    hi=(1.0, 1.0, 1.0),
    surface_focus: float = 0.5,
    eikonal_weight: float = 0.1,
) -> tuple[NeuralSDF, list]:
    """Regress ``model`` onto ``target.distance`` over the box ``[lo, hi]``
    with Adam: each step draws a fresh batch (a ``surface_focus`` fraction
    near the target's surface) and takes :func:`distill_loss`.  Runs on the
    model's device, with ``generator`` (or a generator seeded with it on that
    device).  ``model`` is not modified.  Returns ``(fitted_model, losses)``,
    one loss per step (read from the device once, at the end)."""
    fitted = copy.deepcopy(model)
    dev = fitted.beta.device
    target = copy.deepcopy(target).to(dev)
    gen = _generator(generator, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the model on {dev}")
    lo, hi = as_f32(lo, dev), as_f32(hi, dev)
    opt = torch.optim.Adam(fitted.parameters(), lr=learning_rate)
    n_near = int(batch * surface_focus)
    losses = []
    for _ in range(steps):
        pts = _sample_points(target, gen, batch, n_near, lo, hi)
        opt.zero_grad(set_to_none=True)
        loss = distill_loss(fitted, target, pts, eikonal_weight)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return fitted, torch.stack(losses).tolist() if losses else []
