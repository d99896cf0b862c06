"""The pixel budget that holds two renders of one frame to each other.

Two correct implementations of the march can differ by rounding (operation
order, fused multiply-add, library ``sqrt``/``pow``), and a ray that passes a
surface at almost exactly ``epsilon`` can then stop one step earlier or
later.  So images are compared by a budget, not bit for bit: at most
``edge_frac`` of the pixels may differ by more than ``atol``, and none by
``hard`` or more (``docs/parity.md``; ``tests/test_pallas.py``).

The marched distance ``t`` (:func:`check_planes`) is first clamped to
``max_distance``: beyond it ``t`` is not a depth but the overshoot of a
missed ray's last step, and a miss whose ``t`` lands within rounding of
``max_distance`` takes one more step in one implementation than in the
other.  It is then held to the same numbers relative to ``max(1, |t|)``: on
grazing rays ``t`` reaches tens of units, where float32 spacing is several
1e-6, and a one-ulp difference in a ray direction moves the end of a 100-step
march by more than 1e-4.  The JAX package's own Pallas kernel and XLA path
differ by more than 1e-4 in 56 of 12288 ``t`` values at 128×96 for that
reason.
"""

from __future__ import annotations

import numpy as np

ATOL = 1e-4
EDGE_FRAC = 5e-4
HARD = 0.05


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def pixel_budget(a, b, channel_axis: int | None = None, atol: float = ATOL, relative: bool = False) -> dict:
    """Per-pixel difference statistics of two planes or images: absolute,
    or relative to ``max(1, |b|)``; the maximum over ``channel_axis`` when
    given."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    if relative:
        diff = diff / np.maximum(1.0, np.abs(b))
    if channel_axis is not None:
        diff = diff.max(axis=channel_axis)
    nonfinite = int((~np.isfinite(diff)).sum())
    diff = np.where(np.isfinite(diff), diff, np.inf)
    return {
        "pixels": int(diff.size),
        "over_atol": int((diff > atol).sum()),
        "frac_over_atol": float((diff > atol).mean()),
        "max_abs_err": float(diff.max()) if diff.size else 0.0,
        "nonfinite": nonfinite,
    }


def check_pixel_budget(a, b, name: str = "image", channel_axis: int | None = None, atol: float = ATOL,
                       edge_frac: float = EDGE_FRAC, hard: float = HARD, relative: bool = False) -> dict:
    """:func:`pixel_budget`, raising ``AssertionError`` when it is exceeded."""
    st = pixel_budget(a, b, channel_axis, atol, relative)
    if st["frac_over_atol"] > edge_frac or st["max_abs_err"] >= hard:
        raise AssertionError(
            f"{name}: {st['over_atol']} of {st['pixels']} pixels off by > {atol}{' (relative)' if relative else ''} "
            f"(budget {edge_frac:.2%}), max abs err {st['max_abs_err']:.3g} (hard limit {hard})"
        )
    return st


def check_planes(got, want, max_distance: float, label: str = "") -> dict:
    """Hold the four output planes of the render kernel, ``(rgb (3,H,W), t,
    shadow, ao)``, of two implementations to each other; returns the
    statistics per plane."""
    names = ("rgb", "t", "shadow", "ao")
    stats = {}
    for name, g, w in zip(names, got, want):
        if name == "t":
            g, w = (_np(x).clip(max=max_distance) for x in (g, w))
        stats[name] = check_pixel_budget(
            g, w, f"{label} {name}".strip(), channel_axis=0 if name == "rgb" else None, relative=name == "t"
        )
    return stats
