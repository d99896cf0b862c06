"""The ezorzin/SDF3D shader in plain PyTorch: pinhole rays (the shader's
``-2/tan(fov·π/360)`` focal term), a sphere trace that adds each distance
and stops a ray once ``t > max_distance`` or the distance falls below ε,
central-difference normals, Quilez's improved soft shadow from ``hit + 2ε·n``
and Blinn-Phong (only the light's scalar ambient modulates the material;
no miss branch: a miss is shaded at its far point).

Marches keep only their live rays from step to step; a ray's arithmetic is
that of a masked loop over the whole image.  Every function computes in the
dtype of its inputs.  ``settings`` is the configuration's ``render`` dict.
"""

from __future__ import annotations

import math

import torch

#: A soft-shadow step whose estimate is not real or whose denominator is not
#: positive does not darken (the shader gets it from ``min(x, NaN) = x``).
NO_DARKEN = 1e30
TINY = 1e-30
INTER_CAP = 1e15
#: Grazing rays (|∇f·d| below this) and misses take no implicit gradient.
DENOM_FLOOR = 1e-4


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-12)


def rays(camera: dict, width: int, height: int, dtype=torch.float32, device="cpu"):
    """``(origins, directions)``, each (H·W, 3), row 0 at the top.
    ``camera``: ``position`` (3,), ``c2w`` (3, 3), ``fov_deg`` () tensors."""
    kw = dict(dtype=dtype, device=device)
    xs = (2.0 * (torch.arange(width, **kw) + 0.5) / width) - 1.0
    ys = 1.0 - (2.0 * (torch.arange(height, **kw) + 0.5) / height)
    qx, qy = xs[None, :].expand(height, width), ys[:, None].expand(height, width)
    fov = camera["fov_deg"].to(**kw)
    z = (-2.0 / torch.tan(fov * (math.pi / 360.0))).expand(height, width)
    cam_dir = normalize(torch.stack([qx * (width / height), qy, z], dim=-1))
    c2w = camera["c2w"].to(**kw)
    d = normalize((c2w * cam_dir[..., None, :]).sum(-1)).reshape(-1, 3)
    o = camera["position"].to(**kw).expand(d.shape)
    return o, d


def sphere_trace(f, o, d, settings: dict):
    """``(t, steps)`` per ray: the marched distance (a miss overshoots
    ``max_distance``) and the distance evaluations the ray took."""
    n = o.shape[0]
    t = torch.zeros(n, dtype=o.dtype, device=o.device)
    steps = torch.zeros(n, dtype=torch.int32, device=o.device)
    idx = torch.arange(n, device=o.device)
    ta, oa, da = t, o, d
    eps, far = settings["epsilon"], settings["max_distance"]
    for _ in range(settings["march_steps"]):
        s = f(oa + ta[:, None] * da)
        ta = ta + s
        t[idx] = ta
        steps[idx] += 1
        keep = torch.nonzero(~((ta > far) | (s < eps))).squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < idx.numel():
            idx, ta, oa, da = idx[keep], ta[keep], oa[keep], da[keep]
    return t, steps


def soft_shadow(f, o, d, settings: dict):
    """``(factor in [0, 1], steps)`` of the improved soft shadow."""
    n = o.shape[0]
    kw = dict(dtype=o.dtype, device=o.device)
    shadow = torch.ones(n, **kw)
    steps = torch.zeros(n, dtype=torch.int32, device=o.device)
    idx = torch.arange(n, device=o.device)
    oa, da = o, d
    dist = torch.zeros(n, **kw)
    prev = torch.full((n,), float("inf"), **kw)
    sh = shadow
    eps, far, k = settings["epsilon"], settings["max_distance"], settings["shadow_k"]
    for i in range(settings["shadow_steps"]):
        s = f(oa + dist[:, None] * da)
        if i == 0:
            inter = torch.zeros_like(s)
        else:
            inter = s * s / (2.0 * torch.where(prev == 0.0, TINY, prev))
        inter = torch.clamp(inter, -INTER_CAP, INTER_CAP)
        d2 = s * s - inter * inter
        d_est = torch.sqrt(torch.clamp(d2, min=0.0))
        denom = dist - inter
        valid = (denom > 0.0) & (d2 >= 0.0)
        atten = torch.where(valid, k * d_est / torch.where(valid, denom, 1.0), NO_DARKEN)
        sh = torch.minimum(sh, atten)
        dist = dist + s
        prev = s
        shadow[idx] = sh
        steps[idx] += 1
        keep = torch.nonzero(~((dist > far) | (sh < eps))).squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < idx.numel():
            idx, oa, da, dist, prev, sh = idx[keep], oa[keep], da[keep], dist[keep], prev[keep], sh[keep]
    return torch.clamp(shadow, 0.0, 1.0), steps


def normals(f, p, eps: float):
    """Central differences: six taps at ``±eps`` along the axes."""
    offs = torch.eye(3, dtype=p.dtype, device=p.device) * eps
    return normalize(torch.stack([f(p + offs[a]) - f(p - offs[a]) for a in range(3)], dim=-1))


def blinn_phong(p, n, eye, light: dict, mat: dict, shadow):
    """``amb·M.amb + clamp(N·I, 0, 1)·shadow·M.dif + max(N·H, 0)^shininess·M.spec``."""
    view = normalize(eye - p)
    inc = normalize(light["position"] - p)
    half = normalize(inc + view)
    spec = torch.clamp((n * half).sum(-1), min=0.0) ** mat["shininess"]
    dif = torch.clamp((n * inc).sum(-1), 0.0, 1.0) * shadow
    return light["ambient"] * mat["ambient"] + dif[:, None] * mat["diffuse"] + spec[:, None] * mat["specular"]


def trace(f, o, d, light: dict, settings: dict):
    """The primal of a bundle: ``(t, normal at the hit, shadow factor,
    primary steps, shadow steps)``."""
    t, steps = sphere_trace(f, o, d, settings)
    p = o + t[:, None] * d
    n = normals(f, p, settings["epsilon"])
    if settings["shadow"]:
        shadow, sh_steps = soft_shadow(f, p + n * (2.0 * settings["epsilon"]),
                                       normalize(light["position"] - p), settings)
    else:
        shadow, sh_steps = torch.ones_like(t), torch.zeros_like(steps)
    return t, n, shadow, steps, sh_steps


def check_settings(settings: dict) -> None:
    """The shader's choices this reference computes; anything else raises."""
    want = {"normals": "central", "shading": "blinn_phong", "ao": False, "ray_mode": "reference"}
    for k, v in want.items():
        if settings[k] != v:
            raise ValueError(f"the reference computes {k}={v!r}, not {settings[k]!r}")


@torch.no_grad()
def render(scene, camera: dict, light: dict, mat: dict, settings: dict, width: int, height: int,
           block: int = 1 << 21):
    """``(rgb (H, W, 3) float32, counts)``: the image, and the march counts
    ``primary`` (evaluations of the primary march summed over the image),
    ``shadow`` (of the shadow march) and ``pixels``."""
    check_settings(settings)
    dtype = next(iter(scene.tensors.values())).dtype
    dev = next(iter(scene.tensors.values())).device
    o, d = rays(camera, width, height, dtype, dev)
    out, prim, shad = [], 0, 0
    for i in range(0, o.shape[0], block):
        ob, db = o[i:i + block], d[i:i + block]
        t, n, sh, st, sst = trace(scene.distance, ob, db, light, settings)
        out.append(blinn_phong(ob + t[:, None] * db, n, ob, light, mat, sh).float())
        prim += int(st.sum())
        shad += int(sst.sum())
    rgb = torch.cat(out).reshape(height, width, 3)
    return rgb, {"primary": prim, "shadow": shad, "pixels": width * height}


def loss_and_grads(scene, keys: list, camera: dict, light: dict, mat: dict, settings: dict, target: torch.Tensor,
                   block: int = 1 << 19):
    """The fit step's ``(loss, {key: gradient})``: ``Σ (rgb − target)²``
    summed in float64, and its gradient in the parameters ``keys`` of
    ``scene``.  The primal (march, shadow) is recorded by no graph; the hit
    distance is re-attached by the implicit-function theorem, ``t − (f −
    sg(f)) / sg(∇f·d)`` (zero on misses and grazing rays), the normals and
    the shading are differentiated, the shadow factor is a constant."""
    check_settings(settings)
    dtype = next(iter(scene.tensors.values())).dtype
    dev = next(iter(scene.tensors.values())).device
    o, d = rays(camera, target.shape[1], target.shape[0], dtype, dev)
    tgt = target.reshape(-1, 3).to(dtype)
    params = [scene.tensors[k] for k in keys]
    for prm in params:
        prm.requires_grad_(True)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    grads = [torch.zeros_like(prm, dtype=torch.float64) for prm in params]
    f = scene.distance
    try:
        for i in range(0, o.shape[0], block):
            ob, db = o[i:i + block], d[i:i + block]
            with torch.no_grad():
                t0, _, shadow, _, _ = trace(f, ob, db, light, settings)
            h0 = (ob + t0[:, None] * db).detach().requires_grad_(True)
            with torch.enable_grad():
                f0 = f(h0)
                (g_p,) = torch.autograd.grad(f0.sum(), h0)
                denom = (g_p * db).sum(-1)
                usable = (t0 <= settings["max_distance"]) & (denom.abs() >= DENOM_FLOOR)
                inv = torch.where(usable, 1.0 / torch.where(usable, denom, torch.ones_like(denom)),
                                  torch.zeros_like(denom))
                f_here = f(h0.detach())
                t_att = t0 - (f_here - f_here.detach()) * inv
                h = ob + t_att[:, None] * db
                n = normals(f, h, settings["epsilon"])
                rgb = blinn_phong(h, n, ob, light, mat, shadow)
                res = rgb - tgt[i:i + block]
                block_loss = (res * res).sum(-1)
                gs = torch.autograd.grad(block_loss.sum(), params, allow_unused=True)
            loss += block_loss.detach().double().sum()
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc += g.double()
    finally:
        for prm in params:
            prm.requires_grad_(False)
    return loss, dict(zip(keys, grads))

