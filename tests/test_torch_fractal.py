"""The fractal of ROADMAP item 13c (``Mandelbulb``, ``fractal_scene``)
against the JAX package: the node's ``distance``, the generated C point and
ray forms and the reverse pass (``Scene::sdf_bwd``, ``sdf_grad_p``, built
with g++) and the torch backend's ``torch.autograd`` gradients against
``jax.vjp`` of JAX's emitter, the renders of the torch engine and of the
render kernel's plain version against JAX's, setup files and
``convert.from_jax``.

JAX's CPU ``lax.rsqrt`` is not ``1/sqrt`` (ROADMAP Queue 3), and the
power-8 iterations amplify its last bit: the port (``1/sqrtf``, as the
kernels) is held to JAX's emitter with ``lax.rsqrt`` read as ``1/sqrt`` at
the bar of the other nodes (2e-5 of each derivative, every point; measured
under 1e-6 beyond it), and to JAX's own emitter by a budget: at most 0.5% of
the points with a derivative off by more than 1e-3 (measured 0-1 of 2048 a
case, up to 0.12 relative, none of them near an escape decision).  JAX's
interpret-mode fit kernel on the fractal takes minutes a tile
(``tests/test_fractal.py``), so gradients are held point by point here and
K3 and K5 against their plain versions in ``test_torch_scene_program.py``.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops import PallasRenderConfig, render_pallas
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from test_torch_csg import _assert_grads, _c_scene, _jax_scene, _scene_library, _torch_grads

torch.set_num_threads(1)

S = s.sdf
#: JAX's own bar between its two fractal render paths
#: (``tests/test_fractal.py::test_kernel_matches_xla``).
RENDER_MAX, RENDER_MEAN = 2e-2, 1e-3
#: The budget against JAX's own emitter, whose ``lax.rsqrt`` differs from
#: ``1/sqrt`` by rounding that the iterations amplify (module docstring): a
#: share of the points whose derivatives may be off by more than a tolerance.
RSQRT_BAR, RSQRT_SHARE = 1e-3, 5e-3


def _within_rsqrt_budget(got, want, label):
    off = (np.abs(got - want) > RSQRT_BAR * (1.0 + np.abs(want))).reshape(len(got), -1).any(1)
    assert off.mean() <= RSQRT_SHARE, f"{label}: {int(off.sum())} of {len(got)} points off by > {RSQRT_BAR}"
    return int(off.sum())


def _points(seed, n=2048):
    """Points around the bulb of ``fractal_scene`` (center (0, 0.55, 0),
    scale 0.45): inside, on and outside its surface, and past its
    bounding sphere."""
    r = np.random.default_rng(seed)
    return (r.uniform(-0.6, 0.6, (n, 3)) + np.array([0.0, 0.55, 0.0])).astype(np.float32)


def _escape_flips(js, pts) -> int:
    """The points whose escape decision (``m <= 16`` at some iteration)
    float32 rounding flips: their escape step in float32 differs from the
    float64 one."""
    node = js.b
    q = (pts.astype(np.float64) - np.asarray(node.center, np.float64)) / float(node.scale)

    def steps(dtype):
        x, y, z = (q[:, i].astype(dtype) for i in range(3))
        qx, qy, qz = x.copy(), y.copy(), z.copy()
        alive = np.ones(len(q), bool)
        escape = np.full(len(q), node.iterations)
        for it in range(node.iterations):
            m = np.maximum(x * x + y * y + z * z, dtype(1e-12))
            out = alive & (m > 16.0)
            escape[out] = it
            alive &= ~out
            r = np.sqrt(m)
            k = np.sqrt(np.maximum(x * x + z * z, dtype(1e-12)))
            ct, st, cp, sp = y / r, k / r, x / k, z / k
            for _ in range(3):
                ct, st = ct * ct - st * st, dtype(2.0) * ct * st
                cp, sp = cp * cp - sp * sp, dtype(2.0) * cp * sp
            r8 = (m * m) * (m * m)
            x = np.where(alive, r8 * st * cp + qx, x)
            y = np.where(alive, r8 * ct + qy, y)
            z = np.where(alive, r8 * st * sp + qz, z)
        return escape

    with np.errstate(all="ignore"):
        return int((steps(np.float32) != steps(np.float64)).sum())


@pytest.mark.parametrize("iterations", [1, 4, 6])
def test_mandelbulb_distance_matches_jax(iterations):
    js = S.mandelbulb(center=(0.1, 0.5, -0.05), scale=0.45, iterations=iterations)
    ts = convert.from_jax(js)
    assert type(ts).__name__ == "Mandelbulb" and ts.iterations == iterations
    assert [n for n, _ in ts.named_parameters()] == ["center", "scale"]
    pts = _points(70 + iterations)
    got = ts.distance(torch.from_numpy(pts)).detach().numpy()
    # Measured 6.7e-8 at six iterations.
    np.testing.assert_allclose(got, np.asarray(js.distance(jnp.asarray(pts))), atol=1e-6, rtol=0)


def _one_over_sqrt(monkeypatch):
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))


@pytest.mark.parametrize("iterations", [4, 6])
def test_generated_forms_match_jax_vjp(iterations, tmp_path, monkeypatch, record_property):
    """The g++ build of the generated header: the point form, the ray form
    (the point form at ``o + t·d``, JAX's ``_ray_fallback``) and the reverse
    pass, against ``jax.vjp`` of JAX's emitter; with JAX's ``rsqrt`` read as
    ``1/sqrt`` at the other nodes' bar, and as it is within the budget of
    :data:`RSQRT_SHARE`.  The escape decisions that float32 rounding flips
    are counted (``escape_flips``; none of these points)."""
    js = s.fractal_scene(iterations)
    pts = _points(60 + iterations)
    prm = np.asarray(jax_scene_param_vector(js))
    r = np.random.default_rng(61)
    dirs = r.normal(size=pts.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ts = r.uniform(0.0, 0.5, pts.shape[0]).astype(np.float32)
    got = _c_scene(_scene_library(convert.from_jax(js), tmp_path), pts, dirs, ts, prm)
    record_property("escape_flips", _escape_flips(js, pts))

    dist, ray, dpts, dp = _jax_scene(js, pts, dirs, ts, prm)
    np.testing.assert_allclose(got["dist"], dist, atol=5e-6, rtol=0)
    np.testing.assert_allclose(got["ray"], ray, atol=5e-6, rtol=0)
    for key, want in (("dpts", dpts), ("grad", dpts), ("dp", dp)):
        record_property(f"points_off_{key}", _within_rsqrt_budget(got[key], want, key))

    _one_over_sqrt(monkeypatch)
    dist, ray, dpts, dp = _jax_scene(js, pts, dirs, ts, prm)
    np.testing.assert_allclose(got["dist"], dist, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["ray"], ray, atol=1e-6, rtol=0)
    _assert_grads(got["dpts"], dpts, "grad_p")
    _assert_grads(got["grad"], dpts, "sdf_grad_p")
    _assert_grads(got["dp"], dp, "parameters")
    assert np.isfinite(got["dp"]).all() and np.abs(got["dp"]).max() > 0.0


@pytest.mark.parametrize("iterations", [4, 6])
def test_torch_backend_grads_match_jax_vjp(iterations, monkeypatch, record_property):
    """The torch backend under ``torch.autograd`` (what the plain versions
    differentiate: ``rsqrt`` with lax's derivative, ``log``), as above."""
    js = s.fractal_scene(iterations)
    pts = _points(80 + iterations)
    prm = np.asarray(jax_scene_param_vector(js))
    d, g_pts, g_prm = _torch_grads(convert.from_jax(js), pts, prm)
    dist, _, dpts, dp = _jax_scene(js, pts, pts, np.zeros(pts.shape[0], np.float32), prm)
    np.testing.assert_allclose(d, dist, atol=5e-6, rtol=0)
    record_property("escape_flips", _escape_flips(js, pts))
    record_property("points_off_dp", _within_rsqrt_budget(g_prm, dp, "parameters"))
    record_property("points_off_dpts", _within_rsqrt_budget(g_pts, dpts, "grad_p"))
    _one_over_sqrt(monkeypatch)
    dist, _, dpts, dp = _jax_scene(js, pts, pts, np.zeros(pts.shape[0], np.float32), prm)
    np.testing.assert_allclose(d, dist, atol=1e-6, rtol=0)
    _assert_grads(g_pts, dpts, "grad_p")
    _assert_grads(g_prm, dp, "parameters")


def test_escape_shell_is_finite_where_jax_gives_nan(tmp_path, monkeypatch, record_property):
    """Where |q| lies within about 1e-6 of 4 (the bailout radius) a point
    escapes at the second step with |w|² above 2^32: ``rho^8`` overflows in
    the escape selects' untaken branch, and JAX's reverse mode gives NaN (the
    select's 0 times inf).  The port clamps that term at the largest float32
    (``sdf/primitives.py::mandelbulb_de``): the g++ reverse pass and the torch
    backend are finite at every point, equal to JAX's (``rsqrt`` read as
    ``1/sqrt``) wherever JAX's is finite, and the distance is JAX's
    (ROADMAP Queue 3)."""
    js = s.fractal_scene(6)
    r = np.random.default_rng(17)
    dirs = r.normal(size=(4096, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    q = dirs * (4.0 - r.uniform(0.0, 2e-6, (4096, 1)))
    pts = (q * 0.45 + np.array([0.0, 0.55, 0.0])).astype(np.float32)
    prm = np.asarray(jax_scene_param_vector(js))
    zeros = np.zeros(len(pts), np.float32)
    got = _c_scene(_scene_library(convert.from_jax(js), tmp_path), pts, pts, zeros, prm)
    d, g_pts, g_prm = _torch_grads(convert.from_jax(js), pts, prm)
    assert np.isfinite(got["dp"]).all() and np.isfinite(got["dpts"]).all() and np.isfinite(g_prm).all()
    record_property("jax_nan_points", int(np.isnan(_jax_scene(js, pts, pts, zeros, prm)[3]).any(1).sum()))
    _one_over_sqrt(monkeypatch)
    dist, _, dpts, dp = _jax_scene(js, pts, pts, zeros, prm)
    nan = np.isnan(dp).any(1)
    assert 0 < nan.sum() < len(pts)
    np.testing.assert_allclose(got["dist"], dist, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d, dist, atol=1e-6, rtol=0)
    _assert_grads(got["dp"][~nan], dp[~nan], "parameters")
    _assert_grads(got["dpts"][~nan], dpts[~nan], "grad_p")
    _assert_grads(g_prm[~nan], dp[~nan], "torch parameters")


def test_rsqrt_and_log_follow_lax():
    """The backends' two new operations: values and adjoints of ``rsqrt``
    (``1/sqrt``; lax's ``g·(−0.5·r/x)``) and ``log`` (``g/x``) against
    ``jax.vjp`` with ``rsqrt`` read as ``1/sqrt``; the C forms are the
    accurate ``1.0f / sqrtf`` and ``logf``."""
    from sdf3d_tpu_torch.ops.scene_program import _COps, _TorchOps, CExpr

    x = np.array([1e-12, 3e-7, 0.25, 1.0, 2.0, 16.0, 1234.5], np.float32)
    for op, jf in (("rsqrt", lambda v: 1.0 / jnp.sqrt(v)), ("log", jnp.log)):
        val, back = jax.vjp(jf, jnp.asarray(x))
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = getattr(_TorchOps, op)(xt)
        y.sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(val), rtol=1e-6, atol=0)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(back(jnp.ones_like(jnp.asarray(x)))[0]), rtol=1e-6,
                                   atol=0)
    assert _COps.rsqrt(CExpr("x")).s == "(1.0f / sqrtf(x))" and _COps.log(CExpr("x")).s == "logf(x)"


def test_generated_header_names_its_values():
    """Six iterations unrolled in the header: every intermediate named once
    (``const float eN``), so the text grows linearly with the iterations;
    the accurate operations only; ``iterations`` is structure (another
    value, another header), ``center`` and ``scale`` are run-time
    parameters (other values, the same header)."""
    cfg, kc = tt.REFERENCE_CONFIG, KernelConfig()
    sizes = {n: len(cuda_scene_source(tt.fractal_scene(n), cfg, kc)) for n in (2, 4, 6)}
    assert sizes[6] - sizes[4] < 1.2 * (sizes[4] - sizes[2])
    header = cuda_scene_source(tt.fractal_scene(6), cfg, kc)
    for bad in ("rsqrtf", "__logf", "__fdividef", "__expf"):
        assert bad not in header
    assert "logf(" in header and "(1.0f / sqrtf(" in header
    moved = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.mandelbulb((0.2, 0.6, 0.1), 0.3, 6))
    assert cuda_scene_source(moved, cfg, kc) == header
    assert cuda_scene_source(tt.fractal_scene(5), cfg, kc) != header
    assert scene_param_vector(tt.fractal_scene()).tolist() == pytest.approx([0, 1, 0, 0, 0, 0.55, 0, 0.45])


def _render_setup(W=64, H=48, iterations=4):
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    jscene = s.fractal_scene(iterations)
    cam, light, mat = s.Camera.reference(), s.reference_light(), s.reference_material()
    return jcfg, jscene, cam, light, mat


def _close(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() < RENDER_MAX and diff.mean() < RENDER_MEAN, (diff.max(), diff.mean())


def test_torch_render_matches_jax_render():
    """``render`` (the torch engine) against JAX's ``s.render`` at 64×48
    with ``fractal_scene(iterations=4)``, at JAX's own bar between its two
    fractal paths."""
    jcfg, jscene, cam, light, mat = _render_setup()
    want = np.asarray(s.render(jscene, cam, light, mat, jcfg))
    got = tt.render(convert.from_jax(jscene), *(convert.from_jax(o) for o in (cam, light, mat, jcfg))).numpy()
    _close(got, want)


def test_plain_kernel_matches_jax_interpret_kernel():
    """The render kernel's plain version against JAX's interpret-mode kernel
    (``render_pallas``) at 64×48 with ``fractal_scene(iterations=4)``, at
    JAX's own bar; the bulb covers part of the image."""
    jcfg, jscene, cam, light, mat = _render_setup()
    want = np.asarray(render_pallas(jcfg, PallasRenderConfig(tile_h=8, tile_w=64, interpret=True), jscene, cam,
                                    light, mat))
    scene, tcam, tlight, tmat, cfg = (convert.from_jax(o) for o in (jscene, cam, light, mat, jcfg))
    uni = pack_uniforms(tcam, tlight, tmat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    rgb, t, _, _ = render_kernel_forward_plain(scene, scene_param_vector(scene), uni, cfg)
    _close(rgb.permute(1, 2, 0).numpy(), want)
    assert 200 < int((t[:24] < 2.5).sum()) < 24 * 64  # the bulb, as tests/test_fractal.py's structure check


def test_setup_files_and_from_jax_keep_iterations(tmp_path):
    """A setup file written by either package loads in the other with the
    Mandelbulb's parameters bit for bit and its ``iterations``;
    ``convert.from_jax`` carries both."""
    from sdf3d_tpu.sdf.io import load_setup as jax_load, save_setup as jax_save

    jmb = S.union(S.ground_plane(), S.mandelbulb(center=(0.1, 0.2, 0.3), scale=0.7, iterations=5))
    path = pathlib.Path(tmp_path) / "jax.json"
    jax_save(path, jmb)
    port = tt.sdf.load_setup(path)["scene"]
    assert port.b.iterations == 5
    assert scene_param_vector(port).tolist() == np.asarray(jax_scene_param_vector(jmb)).tolist()
    assert convert.from_jax(jmb).b.iterations == 5
    back = pathlib.Path(tmp_path) / "port.json"
    tt.sdf.save_setup(back, port)
    again = jax_load(back)["scene"]
    assert again.b.iterations == 5
    np.testing.assert_array_equal(np.asarray(jax_scene_param_vector(again)), np.asarray(jax_scene_param_vector(jmb)))
