"""The bars that hold two implementations to each other: the pixel budget
for renders (:func:`check_planes`) and the per-component bar for gradients
(:func:`check_grads`, with :func:`gradient_mass` and :func:`conditioned`).

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

Neural scenes are held to :data:`NEURAL_BAR` (``check_planes(...,
**NEURAL_BAR)``), the JAX package's own bar for its neural kernel against its
XLA render (``tests/test_neural.py:177-178``): at most 0.5% of the pixels off
by more than 1e-3, no hard limit.  The neural kernel sums each MLP layer in
one thread's chain of fused multiply-adds and divides by β through its
reciprocal, the plain version sums in a matrix product and divides, so every
distance differs by rounding, and the neural kernel's soft
shadow turns that into jumps on some rays.  A shadow ray that recedes
straight from the surface nearest it doubles its distance each step (exactly,
for a sphere), and there ``d2 = s² − inter² = s²·(1 − (s/2·prev)²)`` cancels to
nothing: the last bits of ``s`` decide whether ``d2`` is a small positive
number, which darkens the pixel (``k·√d2/denom``), or negative, which leaves
it lit.  Traced in float32 on the CPU, one ray evaluated alone: at one pixel
``s/prev = 1.999988`` at step 10 gave ``d2 = 3.7e-5`` and a shadow of 0.446;
the whole-image plain version gave 0.404 there and the g++ build of the
kernel 0.350.  On the H100 at 1080p that moved 903 of 2073600 shadow
pixels by more than 1e-3, by up to 1.0, on a distilled scene.

A ray whose primary march passes a surface at almost exactly ``epsilon`` is
razor-edge (:func:`razor_edge`): one implementation stops there, the other
marches on to a surface behind or into the sky, and the pixel moves by up
to its whole colour, past ``hard``.  Scenes with rounded corners, tori and
smooth blends have a few such rays a frame at 1080p, in either form, with
or without fused multiply-add (the flagship; ROADMAP Queue 3).
``check_planes(..., razor=mask)`` then holds the hard
limit off the razor-edge rays and requires every pixel past it to be one;
the budget still counts every pixel.

Scenes whose hard limit needs more than that (the 13b scenes: a hit on the
light's terminator, a tap that straddles a crease of hard CSG, a shadow ray
that grazes an occluder's edge) excuse a pixel only on a second witness
that its value is decided by rounding: :func:`rounding_decided` moves every
entry of the camera by one ulp and marks the pixels whose plain render then
moves past ``hard`` (``razor=razor_edge(...) | rounding_decided(...)``).
"""

from __future__ import annotations

import numpy as np

ATOL = 1e-4
EDGE_FRAC = 5e-4
HARD = 0.05
#: The bar of neural-scene image comparisons (module docstring).
NEURAL_BAR = dict(atol=1e-3, edge_frac=5e-3, hard=None)
#: The image bar of :func:`csg_sampler` (ROADMAP Queue 3): its hard
#: Subtraction and Intersection have creases, where the central-difference
#: normal's taps straddle the kink and a hit point one rounding apart turns
#: the normal by that rounding over epsilon.  0.25% of the pixels may differ
#: by more than ``ATOL``, just above the largest share measured on the H100
#: (95 of 49152 pixels, ray form); the hard limit holds off razor-edge rays.
CREASE_BAR = dict(edge_frac=2.5e-3)
#: The flagship's gradient bars (ROADMAP Queue 3), as ``mass_tol`` of
#: :func:`check_grads`: 1e-4 of the gradient mass where both sides
#: differentiate the same primal planes (a ray on the edge of
#: ``conditioned``'s floor at a rounded corner), 1e-3 where the plain
#: version marches its own (on the pixels where the two primals agree).
FLAGSHIP_SAME, FLAGSHIP_OWN = 1e-4, 1e-3


def flagship_fit_start(device=None):
    """The flagship fit's start: ``flagship_scene`` with its sphere, rounded
    box, k and torus moved (the ground plane, slots 0-3, as it is)."""
    from sdf3d_tpu_torch.sdf import ground_plane, round_box, smooth_union, sphere, torus, union

    blob = smooth_union(
        sphere(center=(-0.22, 0.42, 0.02), radius=0.2),
        round_box(half_extents=(0.19, 0.21, 0.2), corner_radius=0.035, center=(0.27, 0.31, 0.0)),
        k=0.13,
    )
    return union(ground_plane(), blob, torus(major=0.47, minor=0.065, center=(0.02, 0.12, 0.33))).to(device)


def shaded_slots(scene) -> list:
    """The parameter-vector slots of every ``Shaded`` node's 10 material
    channels (its material's leaves: ambient, diffuse, specular,
    shininess), in ``scene_param_vector`` order."""
    from sdf3d_tpu_torch.ops.scene_program import leaves
    from sdf3d_tpu_torch.sdf import Shaded

    mats = {id(n.ambient) for n in scene.modules() if isinstance(n, Shaded)}
    slots, off = [], 0
    for leaf in leaves(scene):
        if id(leaf) in mats:
            slots.extend(range(off, off + 10))
        off += int(leaf.numel())
    return slots


def csg_sampler(device=None):
    """Every node of the flagship's family in one scene: a hard Subtraction
    and Intersection, a SmoothIntersection and SmoothSubtraction, a bare Box
    blended into a sphere by a SmoothUnion, a RoundBox and two tori on the
    ground plane.  The bare Box lies inside its sphere, 0.035 deep at its
    corners, so the blend shows it and no reverse-pass tap enters its core
    (where the emitters' derivative is NaN, as JAX's are); the other boxes
    are rounded by more than the normal taps reach."""
    from sdf3d_tpu_torch import sdf as S

    return S.union(
        S.ground_plane(),
        S.subtraction(S.sphere((-0.55, 0.3, 0.0), 0.2), S.sphere((-0.45, 0.42, 0.12), 0.12)),
        S.intersection(S.sphere((0.0, 0.3, -0.5), 0.22), S.torus(0.2, 0.1, (0.0, 0.3, -0.5))),
        S.smooth_intersection(S.sphere((0.55, 0.3, 0.0), 0.22), S.sphere((0.65, 0.3, 0.05), 0.2), k=0.06),
        S.smooth_subtraction(S.torus(0.25, 0.07, (0.0, 0.1, 0.45)), S.sphere((0.2, 0.12, 0.5), 0.1), k=0.05),
        S.smooth_union(S.sphere((0.0, 0.38, 0.0), 0.2), S.box((0.095, 0.095, 0.095), (0.0, 0.38, 0.0)), k=0.1),
        S.round_box((0.12, 0.08, 0.12), 0.03, (0.45, 0.11, -0.45)),
    ).to(device)


def capsule_chain_fit_start(device=None):
    """The capsule chain's fit start: ``capsule_chain()`` (five links) with
    each link's ends moved by about 0.01-0.02, its radius 0.09 for 0.08
    and each blend's k 0.07 for 0.08 (the ground plane, slots 0-3, as it
    is)."""
    from sdf3d_tpu_torch.sdf import capsule, ground_plane, smooth_union, union

    out = None
    for i in range(5):
        sign = -1.0 if i % 2 else 1.0
        a = (-0.6 + 0.3 * i + 0.02 * sign, 0.235 + 0.12 * (i % 2), 0.01)
        b = (-0.6 + 0.3 * (i + 0.7), 0.3 + 0.01 * sign, 0.085)
        link = capsule(a, b, 0.09)
        out = link if out is None else smooth_union(out, link, k=0.07)
    return union(ground_plane(), out).to(device)


def transform_sampler(device=None):
    """Every node of ROADMAP item 13b in one scene with finite gradients:
    a capsule under ``Translate(Rotate(·))`` (a rotation vector off 0), an
    ellipsoid under a ``Rotate`` at ``rotvec = 0`` (the series branch), a
    rounded cylinder (a bare cylinder's core gives NaN gradients, as JAX's
    emitter does), a scaled sphere, a shelled sphere, an elongated torus
    under a ``Translate``, and a row of spheres repeated along x (periods
    of 0 in y and z), on the ground plane.  The rounding (0.04) exceeds what
    the normal and reverse taps reach past a hit, so no tap enters the
    cylinder's core.  Every shape
    clears the ground by at least 0.05 (a
    shape within a few epsilon of the plane makes a crease of the union
    where the normal taps straddle both).  The torus is elongated in x and
    y, not z: in z its hole's axis would be a column of points where the
    ring's length is sqrt(0), whose derivative is NaN on any tap there
    (the ground seen through the hole included).  The row is finite in depth: a lattice repeated in z
    too reaches the horizon, where the marches of misses end near
    ``max_distance`` at a step that rounding decides (the ray and point
    forms of JAX's own kernel differ by 0.56 in the shadow there)."""
    from sdf3d_tpu_torch import sdf as S

    return S.union(
        S.ground_plane(),
        S.translate(S.rotate(S.capsule((-0.12, 0.0, 0.0), (0.12, 0.0, 0.0), 0.07), (0.3, 0.5, 0.4)),
                    (-0.55, 0.25, 0.05)),
        S.rotate(S.ellipsoid((0.18, 0.1, 0.12), (-0.15, 0.22, -0.35)), (0.0, 0.0, 0.0)),
        S.round_edges(S.cylinder(0.1, 0.12, (0.55, 0.22, 0.0)), 0.04),
        S.scale(S.sphere((0.0, 0.62, 0.0), 0.18), 0.5),
        S.onion(S.sphere((0.22, 0.25, 0.35), 0.14), 0.02),
        S.translate(S.elongate(S.torus(0.07, 0.035, (0.0, 0.0, 0.0)), (0.1, 0.03, 0.0)), (-0.2, 0.13, 0.4)),
        S.repeat_infinite(S.sphere((0.0, 0.12, -0.6), 0.07), (1.1, 0.0, 0.0)),
    ).to(device)


def fractal_fit_start(device=None):
    """The fractal fit's start: ``fractal_scene()`` with the Mandelbulb's
    center moved by (0.02, 0.02, -0.015) and its scale 0.47 for 0.45 (the
    ground plane, slots 0-3, as it is)."""
    from sdf3d_tpu_torch.sdf import ground_plane, mandelbulb, union

    return union(ground_plane(), mandelbulb(center=(0.02, 0.57, -0.015), scale=0.47)).to(device)


#: The 13b scenes' image bars (keyword arguments of :func:`check_planes`),
#: each above the 0.05% budget only as far as a measured share needs:
#: ``csg_showcase``'s hard Subtraction and Intersection have creases, and its
#: ray form put 28 of 12288 shadow pixels (0.23%) over ``ATOL`` against JAX's
#: kernel at 128x96 (the plain version on the CPU) and 85 of 47500 (0.18%)
#: against the kernel on the H100 at 250x190; ``lattice_scene``'s fold
#: ``p - period·round(p/period)`` (an FMA on the card) moves the folded point
#: by an ulp, and over its rows of small spheres towards the horizon 42 of
#: 49152 pixels (0.085%, at most 4.1e-3) moved by more than ``ATOL`` on the
#: H100 at 256x192 under orbit 30/15.  Both at :data:`CREASE_BAR`; the other
#: scenes keep the budget.
SCENE_BARS = {"csg_showcase": CREASE_BAR, "lattice_scene": CREASE_BAR}


def scenes_13b(device=None) -> dict:
    """The scenes of ROADMAP item 13b, ``name -> (scene, camera)``: the JAX
    package's ``csg_showcase``, ``lattice_scene``, ``capsule_chain`` and
    ``random_blobs(n=8)`` (seed 0 of the port's generator) under their
    cameras of the JAX gallery (``examples/render_gallery.py``), and
    :func:`transform_sampler` under the reference camera."""
    import sdf3d_tpu_torch as tt

    orbit = tt.Camera.orbit
    return {
        "csg_showcase": (tt.csg_showcase().to(device), orbit(25, 25, 2.4, device=device)),
        "lattice_scene": (tt.lattice_scene().to(device), orbit(15, 18, 3.0, device=device)),
        "capsule_chain": (tt.capsule_chain().to(device), orbit(0, 25, 2.2, device=device)),
        "random_blobs": (tt.random_blobs(n=8).to(device), orbit(40, 22, 2.4, device=device)),
        "transform_sampler": (transform_sampler(device), tt.Camera.reference(device=device)),
    }


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _pixel_diff(a, b, channel_axis: int | None, relative: bool) -> np.ndarray:
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    if relative:
        diff = diff / np.maximum(1.0, np.abs(b))
    if channel_axis is not None:
        diff = diff.max(axis=channel_axis)
    return diff


def pixel_budget(a, b, channel_axis: int | None = None, atol: float = ATOL, relative: bool = False) -> dict:
    """Per-pixel difference statistics of two planes or images: absolute,
    or relative to ``max(1, |b|)``; the maximum over ``channel_axis`` when
    given."""
    diff = _pixel_diff(a, b, channel_axis, relative)
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
                       edge_frac: float = EDGE_FRAC, hard: float | None = HARD, relative: bool = False) -> dict:
    """:func:`pixel_budget`, raising ``AssertionError`` when it is exceeded
    or a value is not finite (``hard=None``: no hard limit)."""
    st = pixel_budget(a, b, channel_axis, atol, relative)
    if st["frac_over_atol"] > edge_frac or st["nonfinite"] or (hard is not None and st["max_abs_err"] >= hard):
        raise AssertionError(
            f"{name}: {st['over_atol']} of {st['pixels']} pixels off by > {atol}{' (relative)' if relative else ''} "
            f"(budget {edge_frac:.2%}), max abs err {st['max_abs_err']:.3g} (hard limit {hard})"
        )
    return st


#: Pixels with |∇f·d| below this are left out of the gradient comparisons
#: (:func:`conditioned`).
COND_FLOOR = 1e-2


def conditioned(scene, prm, uni, t, cfg, floor: float = COND_FLOOR, pixels=None):
    """Pixels (H, W bool) whose gradient two implementations can be held to
    at the gradient bars: misses, and hits with ``|∇f·d| ≥ floor``.
    ``scene`` is a scene of the analytic kernels or a distance callable
    (``render_bwd_kernel.planar_distance``; ``neural_distance`` for a neural
    scene), its values read from the flat parameter vector ``prm``.

    On a ray that grazes a silhouette the implicit-function term of ``t``
    scales with ``1/(∇f·d)`` and its error with ``1/(∇f·d)²``: a one-ulp
    difference in a ray direction (JAX's CPU ``rsqrt`` is not ``1/sqrt``;
    nvcc contracts FMA) moves the hit point, and at ``|∇f·d| = 3.6e-4`` it
    moved one pixel's term by 0.17% (ROADMAP Queue 3).  The comparisons give
    such pixels a zero cotangent (or residual).  ``pixels``: the planes'
    absolute ``(rows, cols)`` (a tile stack's, ``render_kernel.ray_planes``)."""
    from sdf3d_tpu_torch.ops.render_bwd_kernel import implicit_denominator

    den = implicit_denominator(scene, prm, uni, t, cfg, pixels)
    return (den.abs() >= floor) | (t > cfg.march.max_distance)


def gradient_mass(scene, prm, uni, g_rgb, t, shadow, ao, cfg, pixels=None, remarch_shadow: bool = False):
    """Per component of the render backward's ``(g_prm, g_uni)``, the sum
    over pixels of the magnitude of each pixel's term, ``(P + 30,)``.

    A float32 sum's rounding error scales with this mass, not with the sum:
    the plane-normal gradient, for one, sums terms of ±(distance to the
    hit) that cancel.  It runs the plain backward with the parameters and
    uniforms expanded to one copy per pixel, which gives each pixel's term.
    ``scene`` is a scene or a distance callable, and ``pixels`` the planes'
    absolute positions, as for :func:`conditioned`.  ``remarch_shadow``: the
    backward of ``shadow.grad == "ad"`` (``render_bwd_kernel.planar_vjp``),
    whose terms include the re-marched shadow's."""
    import torch

    from sdf3d_tpu_torch.ops.render_bwd_kernel import planar_vjp

    H, W = t.shape

    def planes(v):
        return v[:, None, None].expand(-1, H, W).contiguous()

    mp, mu = planar_vjp(scene, planes(prm), planes(uni), g_rgb, t, shadow, ao, cfg, pixels,
                        remarch_shadow=remarch_shadow)
    return torch.cat([mp.abs().sum((1, 2)), mu.abs().sum((1, 2))])


def check_grads(got, want, mass, rtol: float = 1e-4, mass_tol: float = 1e-5, max_tol: float | None = None,
                label: str = "gradient") -> dict:
    """Hold two gradient vectors to each other, component by component:
    ``|got − want| ≤ rtol·|want| + mass_tol·mass`` (``mass`` from
    :func:`gradient_mass`), and with ``max_tol`` also
    ``≤ rtol·|want| + max_tol·max|want|``.  Returns the largest absolute
    error and the smallest ``mass_tol`` and ``max_tol`` that would pass."""
    got, want, mass = _np(got).ravel(), _np(want).ravel(), _np(mass).ravel()
    over = np.maximum(np.abs(got - want) - rtol * np.abs(want), 0.0)
    peak = float(np.abs(want).max()) if want.size else 0.0
    st = {
        "max_abs_err": float(np.abs(got - want).max()) if got.size else 0.0,
        "err_over_mass": float((over / np.maximum(mass, 1e-30)).max()) if got.size else 0.0,
        "err_over_max": float(over.max() / max(peak, 1e-30)) if got.size else 0.0,
    }
    over_max = max_tol is not None and st["err_over_max"] > max_tol
    if not np.isfinite(got).all() or st["err_over_mass"] > mass_tol or over_max:
        raise AssertionError(
            f"{label}: error {st} over the bar (rtol {rtol}, {mass_tol}·mass, {max_tol}·max|g|)\n"
            f"got  {got.tolist()}\nwant {want.tolist()}"
        )
    return st


def check_planes(got, want, max_distance: float, label: str = "", razor=None, **bar) -> dict:
    """Hold the four output planes of the render kernel, ``(rgb (3,H,W), t,
    shadow, ao)``, of two implementations to each other; returns the
    statistics per plane.  ``bar`` overrides the budget's ``atol``,
    ``edge_frac`` and ``hard`` (:data:`NEURAL_BAR` for neural scenes).
    ``razor``: the (H, W) razor-edge rays (:func:`razor_edge`), or a
    callable that returns them, called once and only if a pixel passes the
    hard limit; the hard limit then holds off them and every pixel past it
    must be one of them (``over_hard`` counts those pixels)."""
    names = ("rgb", "t", "shadow", "ao")
    hard = bar.pop("hard", HARD)
    stats, edge = {}, None
    for name, g, w in zip(names, got, want):
        if name == "t":
            g, w = (_np(x).clip(max=max_distance) for x in (g, w))
        kw = dict(channel_axis=0 if name == "rgb" else None, relative=name == "t")
        label_n = f"{label} {name}".strip()
        if razor is None or hard is None:
            stats[name] = check_pixel_budget(g, w, label_n, hard=hard, **kw, **bar)
            continue
        st = check_pixel_budget(g, w, label_n, hard=None, **kw, **bar)
        over = _pixel_diff(g, w, **kw) >= hard
        st["over_hard"] = int(over.sum())
        if over.any() and edge is None:
            edge = _np(razor() if callable(razor) else razor).astype(bool)
        if over.any() and (over & ~edge).any():
            raise AssertionError(f"{label_n}: {int((over & ~edge).sum())} pixels off by >= {hard} on rays that are "
                                 f"not razor-edge ({int(over.sum())} in all, max abs err {st['max_abs_err']:.3g})")
        stats[name] = st
    return stats


def fixed_order_total(partials, threads: int = 256) -> np.ndarray:
    """The float64 totals of the fit kernel's partial rows ``(rows, live)``
    in its fixed order (``csrc/fit_kernel.cu``, ``fixed_order_total``), in
    Python's float64 arithmetic: for each column, thread ``j`` of
    ``threads`` adds rows ``4j .. 4j + 3``, ``4(j + threads) ..``, ... in row
    order from 0; within each warp of 32 threads lane ``l`` then adds lane
    ``l + 16, 8, 4, 2, 1`` in turn, and the warps' sums are added in order
    from 0.  The kernel's totals equal these bit for bit."""
    rows = np.asarray(partials, dtype=np.float32)
    n = rows.shape[0]
    out = np.zeros(rows.shape[1], np.float64)
    for c in range(rows.shape[1]):
        sums = []
        for j in range(threads):
            s = 0.0
            for r in range(4 * j, n, 4 * threads):
                for x in rows[r:r + 4, c]:
                    s += float(x)
            sums.append(s)
        total = 0.0
        for w in range(0, threads, 32):
            lanes = sums[w:w + 32]
            off = 16
            while off:
                lanes[:off] = [lanes[k] + lanes[k + off] for k in range(off)]
                off //= 2
            total += lanes[0]
        out[c] = total
    return out


def primals_agree(got, want, max_distance: float, atol: float = ATOL):
    """The pixels (H, W bool tensor) where two renders ``(rgb, t, shadow,
    ao)`` agree within ``atol``: rgb and shadow absolute, ``t`` clamped to
    ``max_distance`` and relative to ``max(1, t)`` (:func:`check_planes`'s
    measure).  A fit-step comparison between two implementations that each
    march their own primal holds the gradient on these pixels: elsewhere a
    ray that stopped a step apart on a curved surface turns its normal by
    the step times the curvature, and the pixel budget holds the planes."""
    (k_rgb, k_t, k_sh, _), (p_rgb, p_t, p_sh, _) = got, want
    k_t, p_t = k_t.clamp(max=max_distance), p_t.clamp(max=max_distance)
    dt = (k_t - p_t).abs() / p_t.abs().clamp(min=1.0)
    return ((k_rgb - p_rgb).abs().amax(0) <= atol) & (dt <= atol) & ((k_sh - p_sh).abs() <= atol)


#: The stop test's relative margin of :func:`razor_edge`.
RAZOR_MARGIN = 1e-2


def razor_edge(scene, prm, uni, cfg, kc=None, pixels=None, margin: float = RAZOR_MARGIN):
    """The razor-edge rays (H, W bool; module docstring): those whose primary
    march in the plain version (the ray form or the point form, as ``kc``
    asks) ends more than ``4·epsilon`` apart when its stop test ``s <
    epsilon`` is moved to ``epsilon·(1 ± margin)``, so that the test decides
    between two surfaces (or a surface and the sky) on the last bits of one
    distance.  A ray that converges on a surface ends within a step or two of
    ``epsilon`` either way and is not razor-edge.  ``pixels``: the absolute
    ``(rows, cols)`` planes, as for the render kernel's plain version."""
    import dataclasses

    import torch

    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, _march_primary_plain, pixel_planes, ray_planes
    from sdf3d_tpu_torch.ops.scene_program import compile_scene, compile_scene_ray

    kc = kc or KernelConfig()
    if pixels is None:
        pixels = pixel_planes(uni, cfg.height, cfg.width, kc.tile_h)
    H, W = pixels[0].shape
    o, d = ray_planes(uni, H, W, cfg, pixels)

    def getp(i):
        return prm[i]

    if kc.ray_sdf:
        ev = compile_scene_ray(scene)(o, d, getp)
    else:
        soa = compile_scene(scene)

        def ev(t):
            return soa(o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2], getp)

    mc = cfg.march
    with torch.no_grad():
        ends = [_march_primary_plain(ev, dataclasses.replace(mc, epsilon=mc.epsilon * (1.0 + side * margin)), (H, W),
                                     prm.device).clamp(max=mc.max_distance) for side in (-1.0, 1.0)]
    return (ends[0] - ends[1]).abs() > 4.0 * mc.epsilon


#: The draws of :func:`rounding_decided`.
ROUNDING_DRAWS = 4


def rounding_decided(scene, prm, uni, cfg, kc=None, pixels=None):
    """The pixels (H, W bool) whose value rounding decides: in the plain
    version, a plane moves by ``HARD`` or more (:func:`check_planes`'s
    measure) when each entry of the camera (its position and ``c2w``,
    uniforms 0-11) moves by one ulp, up or down by a fixed pseudo-random
    pattern, in any of :data:`ROUNDING_DRAWS` draws.  Two implementations
    of the same float32 arithmetic differ by about that much in their rays,
    so a pixel that moves past ``hard`` under it may move so between them.
    Arguments as for :func:`razor_edge`."""
    import torch

    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward_plain

    kc = kc or KernelConfig()
    gen = torch.Generator().manual_seed(0)
    names = ("rgb", "t", "shadow", "ao")
    with torch.no_grad():
        base = render_kernel_forward_plain(scene, prm, uni, cfg, kc, pixels)
        moved = np.zeros(tuple(base[1].shape), bool)
        for _ in range(ROUNDING_DRAWS):
            up = (torch.rand(12, generator=gen) < 0.5).to(uni.device)
            cam = uni[:12]
            shifted = uni.clone()
            shifted[:12] = torch.nextafter(cam, torch.where(up, torch.inf, -torch.inf).to(cam.dtype))
            for name, a, b in zip(names, render_kernel_forward_plain(scene, prm, shifted, cfg, kc, pixels), base):
                if name == "t":
                    a, b = (x.clamp(max=cfg.march.max_distance) for x in (a, b))
                moved |= _pixel_diff(a, b, channel_axis=0 if name == "rgb" else None, relative=name == "t") >= HARD
    return torch.from_numpy(moved).to(uni.device)


def argmin_flips(scene, prm, uni, cfg, kc=None, pixels=None):
    """The rays (H, W bool) whose silhouette quantity rounding decides: the
    step at which the plain version's tracked march
    (``render_kernel.primary_min_sdf_plain``) finds its minimum distance
    moves by more than ``4·epsilon`` of ``t_min`` when each entry of the
    camera moves by one ulp, as in :func:`rounding_decided`
    (:data:`ROUNDING_DRAWS` draws).  On such a ray two near-equal distances
    along the march compete for the minimum, so two implementations of the
    same float32 arithmetic may re-attach the coverage term's gradient at
    different points.  Arguments as for :func:`razor_edge`."""
    import torch

    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, primary_min_sdf_plain

    kc = kc or KernelConfig()
    gen = torch.Generator().manual_seed(0)
    _, t_min = primary_min_sdf_plain(scene, prm, uni, cfg, kc, pixels)
    flips = torch.zeros(t_min.shape, dtype=torch.bool, device=uni.device)
    for _ in range(ROUNDING_DRAWS):
        up = (torch.rand(12, generator=gen) < 0.5).to(uni.device)
        shifted = uni.clone()
        shifted[:12] = torch.nextafter(uni[:12], torch.where(up, torch.inf, -torch.inf).to(uni.dtype))
        flips |= (primary_min_sdf_plain(scene, prm, shifted, cfg, kc, pixels)[1] - t_min).abs() > 4.0 * cfg.march.epsilon
    return flips


def loss_mass(scene, prm, uni, rgb, target, t, shadow, ao, cfg, levels: int = 0, coverage=None, sil_w: float = 0.0,
              sil_beta=None, kc=None, pixels=None, mask=None):
    """:func:`gradient_mass` of the fit step's whole loss, ``(P + 30,)``: the
    pixel L2 and, with ``levels``, the multiscale pyramid (the cotangent of
    each pixel's rgb from autograd of both, ``ops.fit_kernel.pyramid_loss``)
    through the render backward, plus with ``coverage`` each pixel's
    silhouette term ``g_min·∂f/∂θ`` at its argmin point (the plain version's
    tracked march) in magnitude.  ``rgb``, ``t``, ``shadow``, ``ao``: the
    planes the gradient is taken on; ``mask``: the real pixels (a tile
    stack's); ``pixels`` as for :func:`conditioned`."""
    import torch

    from sdf3d_tpu_torch.ops.fit_kernel import pyramid_loss
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, primary_min_sdf_plain, ray_planes
    from sdf3d_tpu_torch.ops.scene_program import compile_scene

    kc = kc or KernelConfig()
    real = torch.ones_like(t) if mask is None else mask
    img = rgb.detach().requires_grad_(True)
    with torch.enable_grad():
        res = (img - target) * real
        loss = torch.sum(res * res) + (pyramid_loss(res, real, levels) if levels else 0.0)
        (g_rgb,) = torch.autograd.grad(loss, img)
    mass = gradient_mass(scene, prm, uni, g_rgb, t, shadow, ao, cfg, pixels)
    if coverage is None:
        return mass
    H, W = t.shape
    min_s, t_min = primary_min_sdf_plain(scene, prm, uni, cfg, kc, pixels)
    eps = cfg.march.epsilon
    beta = eps / 2.5 if sil_beta is None else sil_beta
    cov = torch.sigmoid((2.0 * eps - min_s) / beta)
    g_min = -2.0 * sil_w * (cov - coverage) * cov * (1.0 - cov) / beta * real
    if pixels is None:
        from sdf3d_tpu_torch.ops.render_kernel import pixel_planes

        pixels = pixel_planes(uni, H, W, kc.tile_h)
    mp = prm.detach()[:, None, None].expand(-1, H, W).contiguous().requires_grad_(True)
    mu = uni.detach()[:, None, None].expand(-1, H, W).contiguous().requires_grad_(True)
    with torch.enable_grad():
        (ox, oy, oz), (dx, dy, dz) = ray_planes(mu, H, W, cfg, pixels)
        f_min = compile_scene(scene)(ox + t_min * dx, oy + t_min * dy, oz + t_min * dz, lambda i: mp[i])
        gp, gu = torch.autograd.grad(torch.sum(g_min * f_min), (mp, mu), allow_unused=True)
    gu = torch.zeros_like(mu) if gu is None else gu
    return mass + torch.cat([gp.abs().sum((1, 2)), gu.abs().sum((1, 2))])


def fit_targets(base, got, want, scene, prm, uni, cfg, levels: int = 0):
    """The targets of a fit-step comparison between a kernel and its plain
    version, each marching its own primal: ``(target, plain_target)``, both
    ``base`` (3, H, W) where the gradient is well conditioned and the two
    renders ``got`` and ``want`` (``(rgb, t, shadow, ao)``) agree
    (:func:`conditioned`, :func:`primals_agree`), and elsewhere each side's
    own render, so that no residual there reaches either side's gradient.
    With ``levels`` (the multiscale pyramid) a pixel keeps its residual only
    where every pixel of its aligned ``2**levels`` group does: the pyramid
    gives each pixel of a group the group's mean residual."""
    import torch

    keep = conditioned(scene, prm, uni, got[1], cfg) & primals_agree(got, want, cfg.march.max_distance)
    if levels:
        n = 1 << levels
        H, W = keep.shape
        pad = torch.ones((-(-H // n) * n, -(-W // n) * n), dtype=torch.bool, device=keep.device)
        pad[:H, :W] = keep
        whole = pad.reshape(pad.shape[0] // n, n, pad.shape[1] // n, n).all(3).all(1)
        keep = whole.repeat_interleave(n, 0).repeat_interleave(n, 1)[:H, :W]
    return (torch.where(keep, base, got[0]).contiguous(), torch.where(keep, base, want[0]).contiguous())
