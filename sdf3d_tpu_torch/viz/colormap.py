"""Turbo colormap for scalar-field (depth, shadow, AO) debug views (the port of
``sdf3d_tpu/viz/colormap.py``).

The published degree-5 polynomial approximation of Turbo, per channel, with
the JAX package's coefficients and order of terms, so both packages map an
intensity to the same colour; ``turbo_lut`` tabulates it and
``apply_colormap`` looks intensities up in such a table, as the reference's
256-entry LUT does.  Float32 on the device of the input.
"""

from __future__ import annotations

import numpy as np
import torch

from sdf3d_tpu_torch.sdf.node import linspace_f32

# Per channel: the degree-3 block (c0..c3), then the x⁴ and x⁵ terms.
_R4 = (0.13572138, 4.61539260, -42.66032258, 132.13108234)
_G4 = (0.09140261, 2.19418839, 4.84296658, -14.18503333)
_B4 = (0.10667330, 12.64194608, -60.58204836, 110.36276771)
_R2 = (-152.94239396, 59.28637943)
_G2 = (4.27729857, 2.82956604)
_B2 = (-89.90310912, 27.34824973)


def _f32(c) -> list:
    return [float(np.float32(v)) for v in c]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def turbo(x) -> torch.Tensor:
    """Map intensities ``x`` in [0, 1] (clipped) to Turbo RGB: shape
    ``x.shape + (3,)``, float32."""
    x = torch.clamp(_as_tensor(x), 0.0, 1.0)
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    x5 = x4 * x

    def channel(c4, c2):
        c4, c2 = _f32(c4), _f32(c2)
        return c4[0] + c4[1] * x + c4[2] * x2 + c4[3] * x3 + c2[0] * x4 + c2[1] * x5

    rgb = torch.stack([channel(_R4, _R2), channel(_G4, _G2), channel(_B4, _B2)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def turbo_lut(n: int = 256) -> torch.Tensor:
    """The ``(n, 3)`` lookup table of :func:`turbo` at ``n`` evenly spaced
    intensities in [0, 1]."""
    return turbo(linspace_f32(torch.zeros(()), torch.ones(()), n))


def apply_colormap(intensity, lut: torch.Tensor | None = None) -> torch.Tensor:
    """Look ``intensity`` up in ``lut`` (default ``turbo_lut()``), as the
    reference indexes its LUT: ``i = round((n − 1)·intensity)`` (half to
    even) clamped to ``[0, n − 1]``."""
    intensity = _as_tensor(intensity)
    lut = turbo_lut() if lut is None else _as_tensor(lut)
    n = lut.shape[0]
    idx = torch.clamp(torch.round(intensity * (n - 1)).to(torch.int64), 0, n - 1)
    return lut.to(intensity.device)[idx]
