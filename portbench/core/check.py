"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``portbench/reference``) on the same inputs,
at the timed sizes.  Each number compared has a limit of its own, from the
traffic mix's ``check.limits``; a number at or under its limit passes.

- Render mixes: the images of a sample of the window's requests, drawn
  from the seed; a sample of their frames re-rendered by the reference.
  ``share_off``: the share of an image's pixels with a channel off by more
  than ``OFF`` (the worst image); ``mean_gap``: the mean absolute gap over
  an image's channels (the worst image).
- Fit mixes: one job of the window, drawn from the seed, followed by the
  reference step by step from the program's own state, which the benchmark
  reads through the optimizer's step hook (``torch.optim``'s global
  pre-step hook) at the steps to check: step 0, the last and, where the mix
  asks for it (``mid_step``), one logged step drawn from the seed between.
  At a checked step ``s`` the reference takes the program's parameters and
  computes the loss and the gradient there.
  ``start_gap``: the program's parameters at step 0 against the job's start
  (exact).  ``loss_gap``: the logged loss at step 0 against the reference's,
  over the reference's.  ``grad_gap``: the gradient at step 0 as the
  optimizer gets it against the reference's, by the worst leaf: the gap
  between the two norms of the leaf over the larger of the reference's norm
  of that leaf and of the median leaf.  ``late_loss_gap`` and
  ``late_grad_gap``: the same at each later checked step, each over the
  larger of its own step's scale and ``LATE_FLOOR`` times step 0's.
  ``step_gap``: the parameters' change over each checked step (to the
  returned scene after the last) against the change of the reference's Adam
  step from the program's moments and gradient, by the worst leaf, over the
  reference change's norms.  A leaf whose step-0 gradient in the reference
  is under a thousandth of the median leaf's is left out of the gradients
  and the steps (it moves by rounding alone).  The floor is there because a
  few pixels at the silhouette, whose march or grazing test ends otherwise
  in the two programs, move the loss and the gradient by about the same
  absolute amount at every step, while both fall 10^2 to 10^3-fold over a
  job: late in a fit that noise is most of a step's own gradient.
"""

from __future__ import annotations

import numpy as np
import torch

#: A pixel channel is off when it differs by more than this.
OFF = 1e-3

#: The late steps' floor of scale, as a share of step 0's loss and of each
#: leaf's step-0 gradient norm.
LATE_FLOOR = 0.01


def render_numbers(pairs: list) -> dict:
    """``pairs``: ``(program image, reference image)``, each (H, W, 3)."""
    share = gap = 0.0
    for prog, ref in pairs:
        d = (prog.float().to(ref.device) - ref).abs()
        share = max(share, float((d.amax(-1) > OFF).double().mean()))
        gap = max(gap, float(d.double().mean()))
    return {"share_off": share, "mean_gap": gap}


def logged_steps(steps: int, log_every: int) -> list:
    """The steps whose losses ``fit_scene`` logs."""
    return [s for s in range(steps) if s % log_every == 0 or s == steps - 1]


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().double().cpu())) for k, t in tensors.items()}


def worst_leaf_gap(prog: dict, ref: dict, scale: dict) -> float:
    """The gap of norms by the worst leaf, each over the larger of its
    ``scale`` and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median(list(scale.values())))
    return max(abs(pn[k] - rn[k]) / max(scale[k], med, 1e-30) for k in prog)


def fit_numbers(start: dict, prog: dict, prog_next: dict, prog_losses: dict, ref: dict) -> dict:
    """``prog``: the program's state before each checked step ``s``
    (``theta``, ``grad``, ``m``, ``v``); ``prog_next``: its parameters after
    it; ``prog_losses``: its logged losses by step; ``ref``: the reference's
    ``loss`` and ``grad`` at ``prog[s]["theta"]`` and ``theta``, its Adam step
    from ``prog[s]`` with the program's gradient."""
    out = {"start_gap": max(float((prog[0]["theta"][k].double().cpu() - torch.as_tensor(start[k]).double())
                                  .abs().max()) for k in start)}
    loss0 = abs(ref[0]["loss"])
    g0 = _norms(ref[0]["grad"])
    med = float(np.median(list(g0.values())))
    keep = [k for k in g0 if g0[k] >= 1e-3 * med]

    def loss_gap(s):
        return abs(prog_losses[s] - ref[s]["loss"]) / max(abs(ref[s]["loss"]), LATE_FLOOR * loss0 if s else loss0)

    def grad_gap(s):
        scale = {k: max(n, LATE_FLOOR * g0[k]) for k, n in _norms({k: ref[s]["grad"][k] for k in keep}).items()}
        return worst_leaf_gap({k: prog[s]["grad"][k] for k in keep}, {k: ref[s]["grad"][k] for k in keep}, scale)

    late = [s for s in sorted(ref) if s > 0]
    out["loss_gap"], out["grad_gap"] = loss_gap(0), grad_gap(0)
    out["late_loss_gap"] = max([loss_gap(s) for s in late if s in prog_losses], default=0.0)
    out["late_grad_gap"] = max([grad_gap(s) for s in late], default=0.0)
    step = 0.0
    for s, r in ref.items():
        dp = {k: prog_next[s][k].double().cpu() - prog[s]["theta"][k].double().cpu() for k in keep}
        dr = {k: r["theta"][k].double().cpu() - prog[s]["theta"][k].double().cpu() for k in keep}
        step = max(step, worst_leaf_gap(dp, dr, _norms(dr)))
    out["step_gap"] = step
    return out


def reference_steps(scene_of, keys: list, prog: dict, camera, light, mat, settings, target, lr: float) -> dict:
    """The reference at each checked step, from the program's state there:
    ``{s: {"loss", "grad", "theta"}}``, its loss and gradient at the
    program's parameters and its Adam step from the program's moments and
    gradient; ``scene_of(theta)`` builds the reference's scene with the
    parameters ``theta``."""
    from portbench.reference import fit as ref_fit
    from portbench.reference import shader

    out = {}
    for s, st in sorted(prog.items()):
        scene = scene_of(st["theta"])
        loss, grads = shader.loss_and_grads(scene, keys, camera, light, mat, settings, target)
        theta = {}
        for k in keys:
            p = scene.tensors[k]
            theta[k], _, _ = ref_fit.adam_step(p, st["grad"][k].to(p), st["m"][k].to(p), st["v"][k].to(p), s + 1, lr)
        out[s] = {"loss": float(loss), "grad": grads, "theta": theta}
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit; a number that is not finite fails."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows


def plain_light(config: dict, dtype, device) -> dict:
    lt = config["light"]
    return {"position": torch.tensor(lt["position"], dtype=dtype, device=device),
            "ambient": torch.tensor(lt["ambient"], dtype=dtype, device=device)}


def plain_material(config: dict, dtype, device) -> dict:
    m = config["material"]
    return {k: torch.tensor(m[k], dtype=dtype, device=device) for k in ("ambient", "diffuse", "specular", "shininess")}


def plain_camera(cam: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in cam.items()}
