"""Power-8 Mandelbulb over ``q = (p - center) / scale``, its distance times
``scale``: Quilez's escape-time estimate (iquilezles.org/articles/mandelbulb)
in its trig-free form.  ``iterations`` unrolled steps of the triplex map
``w <- w^8 + q``, the angles' sines and cosines by three doublings of
``y/rho``, ``k/rho``, ``x/k``, ``z/k``; the derivative ``dr <- 8 rho^7 dr +
1``; an escaped point (``|w|^2 > 16``) frozen; then ``max(0.25 log(rho) rho /
dr, |q| - 1.2)``, every squared norm floored at 1e-12 and ``rho^8`` clamped
at 2^100 (a point that escapes near the bailout would overflow it)."""

import torch

EPS = 1e-12
BAILOUT2 = 16.0
BIG = 2.0 ** 100


def de(qx, qy, qz, iterations):
    """The estimate at ``q`` (components), before the scale."""
    wx, wy, wz = qx, qy, qz
    dr = torch.ones_like(qx)
    r_kept = None
    stay = None
    for it in range(iterations):
        mm = torch.clamp(wx * wx + wy * wy + wz * wz, min=EPS)
        r = torch.sqrt(mm)
        inside = mm <= BAILOUT2
        if stay is None:
            r_kept, stay = r, inside
        else:
            r_kept = torch.where(stay, r, r_kept)
            stay = stay & inside
        m2 = mm * mm
        dr = torch.where(stay, 8.0 * (m2 * mm) * r * dr + 1.0, dr)
        if it == iterations - 1:
            break
        inv_r = 1.0 / torch.sqrt(mm)
        k2 = torch.clamp(wx * wx + wz * wz, min=EPS)
        inv_k = 1.0 / torch.sqrt(k2)
        ct, st = wy * inv_r, torch.sqrt(k2) * inv_r
        cp, sp = wx * inv_k, wz * inv_k
        for _ in range(3):
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r8 = torch.clamp(m2 * m2, max=BIG)
        wx = torch.where(stay, r8 * st * cp + qx, wx)
        wy = torch.where(stay, r8 * ct + qy, wy)
        wz = torch.where(stay, r8 * st * sp + qz, wz)
    est = 0.5 * torch.log(r_kept) * r_kept / dr
    bound = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz, min=EPS)) - 1.2
    return torch.maximum(0.5 * est, bound)


def distance(p, prm, kids, static):
    q = (p - prm["center"]) / prm["scale"]
    return de(q[:, 0], q[:, 1], q[:, 2], int(static["iterations"])) * prm["scale"]
